"""Split the trunk's backward kernel B1-bwd (csrc/trunk_bwd.cu,
kernels/trunk.py:trunk_bwd) pass by pass on the card, through subsets of
`needs` that isolate its passes with no kernel code of their own:

  dW3       (w3, b3): the c3 pass's weight gradient alone
  dW2       (w2, b2): the c3 pass's dgrad (gz2), then the c2 pass's dW2
  dW1       (w1, b1): the c3 pass's dgrad, then the c2 pass's g1 and dW1

beside the whole kernel on training's gradients (TRAIN_NEEDS: all six
parameters, no dx), at batch 8 (the main paths' batch):

    python3 -m driving_dirty_tpu_torch.scripts.probe_trunk_bwd [--paths roadmap detection]

Needs a CUDA card. Inputs, weights and the cotangent come from a seed
(numpy); c1, c2 and c3 from B1-save (`trunk_train_op`). Each subset is held
against `trunk_bwd_plain` on the same saved tensors (hold_subset), then
timed with CUDA events over back-to-back launches after a warm-up, beside
cuDNN's three `convolution_backward` calls for the training gradients
(`library_backward`, a yardstick the port never calls), and printed with
the ptxas report of csrc/trunk_bwd.cu and the card's name and power limit;
the last line is one JSON object of the records. chip_smoke.py runs
hold_subset and pass_split in its B1-bwd phase.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels import build
from driving_dirty_tpu_torch.kernels.trunk import out_hw, trunk_bwd, trunk_bwd_plain, trunk_train_op
from driving_dirty_tpu_torch.scripts.probe_trunk_int8_variants import cuda_ms, ptxas_line, ptxas_report
from driving_dirty_tpu_torch.scripts.probe_trunk_variants import device_line

SEED = 0
BATCH = 8
SHAPES = {"roadmap": (256, 1836), "detection": (800, 800)}  # the two main paths' trunk inputs
_W_SHAPES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]
BWD_NAMES = ("x", "w1", "b1", "w2", "b2", "w3", "b3")
_F, _T = False, True
TRAIN_NEEDS = (_F,) + (_T,) * 6  # an unfrozen encoder's gradients: x asks for none
SPLIT = {"dW3": (_F, _F, _F, _F, _F, _T, _T), "dW2": (_F, _F, _F, _T, _T, _F, _F),
         "dW1": (_F, _T, _T, _F, _F, _F, _F)}
# B1-bwd against trunk_bwd_plain on the same saved tensors (the same masks),
# max |error| <= BWD_TOL * max|plain| per gradient: f32 1e-4 (split-TF32
# products and f32 sums in another order than cuDNN's f32 backward, sums of
# up to 3.7M terms: within 1e-5 of the largest entry at both main-path
# shapes in chip_smoke.py's runs); bf16 2^-6 (both round gz2, gz1, dx and
# the weight gradients to bf16 at the same points, from f32 sums in another
# order: a few bf16 ulps of the largest value).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def probe_inputs(hw, dtype, seed: int = SEED):
    """x [BATCH, *hw, 3] in [0, 1), OIHW weights and biases (randn * 0.1)
    and a cotangent g3 (randn) from numpy's RandomState(seed), on the card
    in `dtype` (the parameters f32, as the models keep them)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(BATCH, *hw, 3).astype(np.float32)).cuda().to(dtype)
    params = [torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32)).cuda() for s in _W_SHAPES]
    g3 = torch.from_numpy(rng.randn(BATCH, *out_hw(*hw), 32).astype(np.float32)).cuda().to(dtype)
    return x, params, g3


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def library_backward(g3, x, params, c1, c2, c3):
    """The yardstick of B1-bwd: cuDNN's three convolution_backward calls
    for training's gradients (no dx) on channels-last views, each on its
    conv's output gradient, which is computed here first. -> a function
    that makes the three calls. Timed only; the port never calls it."""
    aten = torch.ops.aten
    ws = [w.to(x.dtype) for w in params[0::2]]
    gz3 = aten.threshold_backward(_nchw(g3), _nchw(c3), 0)
    g2 = aten.convolution_backward(gz3, _nchw(c2), ws[2], [32], [2, 2], [1, 1], [1, 1], False, [0, 0], 1,
                                   [True, False, False])[0]
    gz2 = aten.threshold_backward(g2, _nchw(c2), 0)
    g1 = aten.convolution_backward(gz2, _nchw(c1), ws[1], [32], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                                   [True, False, False])[0]
    gz1 = aten.threshold_backward(g1, _nchw(c1), 0)
    calls = ((gz3, c2, ws[2], 2, [True, True, True]), (gz2, c1, ws[1], 1, [True, True, True]),
             (gz1, x, ws[0], 1, [False, True, True]))

    def library():
        for gz, act, w, stride, mask in calls:
            aten.convolution_backward(gz, _nchw(act), w, [32], [stride] * 2, [1, 1], [1, 1], False, [0, 0], 1, mask)
    return library


def hold_subset(g3, x, params, c1, c2, c3, needs, label: str) -> dict:
    """B1-bwd for `needs` against trunk_bwd_plain on the same saved tensors:
    max |error| <= BWD_TOL * max|plain| per gradient, and bit-equal over two
    launches -> {gradient: {"max_abs_err", "tol"}}, each printed; raises on
    a miss."""
    got = trunk_bwd(g3, x, *params, c1, c2, c3, needs)
    again = trunk_bwd(g3, x, *params, c1, c2, c3, needs)
    ref = trunk_bwd_plain(g3, x, *params, c1, c2, c3, needs)
    errs = {}
    for name, a, b, r, need in zip(BWD_NAMES, got, again, ref, needs):
        if not need:
            continue
        what = f"B1-bwd {name} {label}"
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: two launches gave different gradients")
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"{what}: shape {tuple(a.shape)} vs {tuple(r.shape)} or non-finite")
        err = (a.float() - r.float()).abs().max().item()
        tol = BWD_TOL[x.dtype] * r.float().abs().max().item()
        print(f"{what}, bit-equal over two launches: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
        if not err <= tol:
            raise RuntimeError(f"{what}: max |error| {err} > {tol} against trunk_bwd_plain")
        errs[name] = {"max_abs_err": err, "tol": tol}
    return errs


def pass_split(g3, x, params, c1, c2, c3) -> dict:
    """B1-bwd's time for each subset of SPLIT, held first (hold_subset) ->
    {subset: {"ms", "launches", "max_abs_err"}}; launches counts every
    launch the subset made here, the held ones included."""
    label = f"{str(x.dtype)[6:]} {list(x.shape)}"
    out = {}
    for name, needs in SPLIT.items():
        start = trunk_bwd.launches
        errs = hold_subset(g3, x, params, c1, c2, c3, needs, f"{label} ({name} only)")
        ms = cuda_ms(lambda: trunk_bwd(g3, x, *params, c1, c2, c3, needs))
        out[name] = {"ms": ms, "launches": trunk_bwd.launches - start,
                     "max_abs_err": {k: v["max_abs_err"] for k, v in errs.items()}}
    return out


def run_probe(paths=tuple(SHAPES), dtypes=(torch.float32, torch.bfloat16)) -> list[dict]:
    """The pass split, the whole kernel on training's gradients, cuDNN's
    yardstick and the plain version's time at each (path, dtype) -> one
    record each."""
    if not torch.cuda.is_available():
        raise RuntimeError("the B1-bwd probe needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    records = []
    for path in paths:
        for dtype in dtypes:
            x, params, g3 = probe_inputs(SHAPES[path], dtype)
            with torch.no_grad():
                c3, c1, c2 = trunk_train_op(x, *params)
            split = pass_split(g3, x, params, c1, c2, c3)
            hold_subset(g3, x, params, c1, c2, c3, TRAIN_NEEDS, f"{str(dtype)[6:]} {list(x.shape)} (training)")
            ms = cuda_ms(lambda: trunk_bwd(g3, x, *params, c1, c2, c3, TRAIN_NEEDS))
            library_ms = cuda_ms(library_backward(g3, x, params, c1, c2, c3))
            plain_ms = cuda_ms(lambda: trunk_bwd_plain(g3, x, *params, c1, c2, c3, TRAIN_NEEDS))
            records.append({"path": path, "shape": list(x.shape), "dtype": str(dtype)[6:], "split": split,
                            "ms": ms, "library_ms": library_ms, "plain_ms": plain_ms})
            del x, params, g3, c1, c2, c3
            torch.cuda.empty_cache()
    return records


def split_line(rec: dict) -> str:
    parts = ", ".join(f"{k} {v['ms']:.4f}" for k, v in rec["split"].items())
    return (f"B1-bwd split {rec['dtype']} {rec['shape']}: {parts} ms; the whole kernel (training) "
            f"{rec['ms']:.4f} ms, cuDNN's three convolution_backward {rec['library_ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args(argv)
    build.load_libraries(("trunk", "trunk_bwd"))
    print(f"{torch.cuda.get_device_name(0)} | nvidia-smi: {device_line()}", flush=True)
    print(f"trunk_bwd {ptxas_line(ptxas_report('trunk_bwd'))}", flush=True)
    records = run_probe(args.paths)
    for r in records:
        print(split_line(r), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}), flush=True)


if __name__ == "__main__":
    main()
