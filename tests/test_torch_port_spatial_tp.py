"""The spatial heads' channel tensor parallelism of driving_dirty_tpu_torch
(models/spatial_bb.py's sharding rules, core/layers.py's column-parallel
conv and transposed conv, parallel/collectives.py:gather_channels) on the
CPU, over gloo:

  * the port's cuts are the JAX package's rules on the same parameter
    tree: for spatial_bb and spatial_rm at both geometries, every leaf of
    the JAX task's init, the JAX rules' spec against the port's sharding
    carried back to the JAX layout (the same names cut, on the same JAX
    dimension; no tolerance);
  * in float64 (weights, activations and the loss), one training step of
    spatial_bb and of spatial_rm on tp=2, the encoder trained too (its
    gradient comes whole through the column layers' input sums), equals
    the one-process step: the loss, every gradient gathered whole and
    every weight after one Adam update within 1e-10 relative (measured
    6e-16: the gathered channels are the one-process channels and
    only the sums over 'model' of the input gradients change order);
  * spatial_rm ("small" geometry, batch 4, seeded box scenes) resumes a
    JAX single-device checkpoint (the JAX task's init, written by the
    JAX package's checkpoints/io.py) on tp=2 and takes 2 Adam steps: its
    losses within 1e-5 relative of the same fit in one process, its
    last.ckpt (written by rank 0 with the shards gathered) is the
    one-process file: the JAX io reads it into the JAX task's tree
    (every leaf's name and shape), a one-process port task loads it, and
    its weights equal the one-process fit's within 1e-5 relative L2 per
    leaf (the f32 sums of the two layouts differ in order only; measured
    1.1e-7 for the losses and 3.2e-8 for the leaves).

The ranks' replicated copies (the last stage, the encoder) stay equal by
construction: Adam averages their gradients over 'model'. A step whose
replicated gradient differs by rank in its last bits, as the card's
default algorithms may make it, moves every rank's copy alike, by the
mean gradient's Adam step, and leaves a shard its own gradient's.

Ranks are processes started by parallel/launch.py:spawn with one torch
thread each; they meet through a file in the test's temporary directory.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import glob
import json
import os
import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.models import spatial_bb as JS
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import gather_params, load_jax_weights, param_places
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.models import spatial_bb as S
from driving_dirty_tpu_torch.parallel import launch
from driving_dirty_tpu_torch.parallel import mesh as mesh_lib
from driving_dirty_tpu_torch.parallel.collectives import TP_COMM, reset_tp_comm
from driving_dirty_tpu_torch.train.optim import Adam

F64_RTOL = 1e-10
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-5
B = 4
HP = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78, pretrained_path=None,
          batch_size=B, learning_rate=1e-3, spatial_geometry="small")
CLASSES = {"spatial_bb": (JS.BBSpatialModel, S.BBSpatialModel), "spatial_rm": (JS.BBSpatialRoadMap, S.BBSpatialRoadMap)}


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        boxes, valid = box_scenes(seed + 20 + i, B, 100)
        out.append({"images": rng.randint(0, 256, (B, 6, 64, 78, 3)).astype(np.uint8),
                    "road": (rng.rand(B, 152, 152) > 0.5).astype(np.float32), "boxes": boxes, "box_valid": valid})
    return out


def _jax_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("geometry", ["small", "reference"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_the_port_cuts_are_the_jax_rules(name, geometry):
    jcls, pcls = CLASSES[name]
    hparams = dict(HP, spatial_geometry=geometry, ae_input_height=256 if geometry == "reference" else 64,
                   ae_input_width=6 * (306 if geometry == "reference" else 78))
    jtask = jcls(hparams)
    params, _ = jax.eval_shape(jtask.init, jax.random.PRNGKey(0))  # the tree's shapes, nothing computed
    want = {}
    for path, leaf in _jax_leaves(params):
        spec = jtask.param_sharding_rules(path, leaf)
        if spec is not None and "model" in tuple(spec):
            want["/".join(path)] = tuple(spec).index("model")
    task = pcls(hparams, device="cpu", generator=torch.Generator().manual_seed(0))
    specs = mesh_lib.param_shardings(types.SimpleNamespace(model=2), task, task.param_sharding_rules)
    got = {}
    for jax_name, pname, perm in param_places(task):
        if specs[pname] is not None:
            dim = specs[pname][0]
            got[jax_name] = dim if perm is None else list(perm).index(dim)
    assert sorted(j for j, _, _ in param_places(task)) == sorted("/".join(p) for p, _ in _jax_leaves(params))
    assert got == want and len(got) == (30 if name == "spatial_rm" else 24)


def f64_step(name, mesh=None):
    """spatial_<name>'s loss, gradients and the weights after one Adam update
    in float64 on the first batch, the encoder trained; on tp=2 the shards'
    gradients and weights gathered whole."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(S, "compute_dtype", lambda precision: torch.float64):
            task = CLASSES[name][1](HP, device="cpu", generator=torch.Generator().manual_seed(0))
            task.encoder.requires_grad_(True)
            specs = {}
            if mesh is not None:
                specs = {n: s for n, s in mesh_lib.param_shardings(mesh, task, task.param_sharding_rules).items()
                         if s is not None}
                mesh_lib.shard_module(task, mesh, specs)
            opt = Adam(task.named_parameters(), 1e-3, tp=(mesh, frozenset(specs)) if specs else None)
            batch = {k: torch.from_numpy(v) for k, v in batches(1)[0].items()}
            loss, _ = task.loss(batch, train=True)
            loss.backward()
            grads = {n: p.grad.detach().clone() for n, p in task.named_parameters()}
            opt.step()
            weights = {n: p.detach().clone() for n, p in task.named_parameters()}
    finally:
        torch.set_default_dtype(prev)
    if mesh is not None:
        grads, weights = gather_params(grads, mesh, specs), gather_params(weights, mesh, specs)
    return float(loss.detach()), grads, weights, sorted(specs)


def fit_spec(root, start, model_parallel):
    return dict(task=S.BBSpatialRoadMap, hparams=HP, seed=0, batches=batches(2), val_batches=batches(1, seed=1),
                model_parallel=model_parallel, resume=start, device="cpu",
                trainer=dict(max_epochs=1, log_every_n_steps=1, enable_progress_bar=False,
                             default_root_dir=os.path.join(root, f"tp{model_parallel}")))


def rank_grads(rank):
    """A rank's gradients of a replicated "w" and a sharded "s": w's differ
    between ranks in the last bits, and in sign where they are float noise."""
    w = torch.tensor([0.5, -2.0, 1e-9, 3.0]) * torch.tensor([1.0, 1.0 + 2e-7, -1.0, 1.0 - 3e-7]) ** rank
    return w, torch.tensor([1.0, -1.0]) * (rank + 1)


def replicated_step(mesh):
    """One Adam step of rank_grads on tp=2 -> (w, s, TP_COMM's mean count)."""
    params = {"w": torch.nn.Parameter(torch.ones(4)), "s": torch.nn.Parameter(torch.ones(2))}
    opt = Adam(params.items(), 1e-3, tp=(mesh, frozenset({"s"})))
    reset_tp_comm()
    params["w"].grad, params["s"].grad = rank_grads(mesh.tp_rank)
    opt.step()
    return params["w"].detach().clone(), params["s"].detach().clone(), dict(TP_COMM["mean"])


def rank_main(root, start):
    mesh = mesh_lib.build_mesh(model_parallel=2)
    out = {name: f64_step(name, mesh) for name in CLASSES}
    out["replicated"] = replicated_step(mesh)
    return out, launch.fit_worker(fit_spec(root, start, 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (root, the one-process results, each rank's), the one process
    computed while the ranks run."""
    root = str(tmp_path_factory.mktemp("spatial_tp"))
    jtask = JS.BBSpatialRoadMap(HP)
    params, state = jtask.init(jax.random.PRNGKey(0))
    start = os.path.join(root, "start.ckpt")
    jax_io.save(start, params=params, state=state, hparams=HP,
                meta={"epoch": 0, "global_step": 0, "mid_epoch": True, "batch_in_epoch": 0, "task": "spatial_rm"})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch.spawn, rank_main, 2, (root, start), device="cpu", threads=1,
                                init_method=f"file://{root}/rdzv")
            one = {name: f64_step(name) for name in CLASSES}, launch.fit_worker(fit_spec(root, start, 1))
            return root, params, one, ranks.result()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_a_tp2_step_equals_one_process_in_float64(runs, name):
    _, _, (one, _), ranks = runs
    loss, grads, weights, _ = one[name]
    for rank, _ in ranks:
        r_loss, r_grads, r_weights, cut = rank[name]
        assert len(cut) == (30 if name == "spatial_rm" else 24)
        assert r_grads["encoder.c1.weight"].dtype == torch.float64 and float(grads["encoder.c1.weight"].abs().max()) > 0
        np.testing.assert_allclose(r_loss, loss, rtol=F64_RTOL)
        for n in grads:
            assert r_grads[n].shape == grads[n].shape, n
            assert _rel(r_grads[n], grads[n]) <= F64_RTOL, (n, _rel(r_grads[n], grads[n]))
            assert _rel(r_weights[n], weights[n]) <= F64_RTOL, n


def test_replicated_copies_step_on_the_mean_gradient(runs):
    *_, ranks = runs
    (w0, s0, mean0), (w1, s1, _) = (rank["replicated"] for rank, _ in ranks)
    assert torch.equal(w0, w1)  # without the mean, w[2] would move +lr on one rank, -lr on the other
    (g0, _), (g1, _) = rank_grads(0), rank_grads(1)
    w = torch.nn.Parameter(torch.ones(4))
    w.grad = (g0 + g1) / 2
    Adam([("w", w)], 1e-3).step()
    assert torch.equal(w0, w.detach())
    for rank, s in enumerate((s0, s1)):  # a shard steps on its own gradient
        sp = torch.nn.Parameter(torch.ones(2))
        sp.grad = rank_grads(rank)[1]
        Adam([("s", sp)], 1e-3).step()
        assert torch.equal(s, sp.detach())
    assert (mean0["calls"], mean0["bytes"]) == (1, 16)


def _losses(run_dir):
    out = {}
    for path in glob.glob(os.path.join(run_dir, "spatial_rm", "version_*", "tb", "metrics.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                for key in ("train_loss", "val_loss"):
                    if key in rec:
                        out[(key, rec["step"])] = rec[key]
    return out


def test_a_jax_single_device_checkpoint_resumes_on_tp2(runs):
    root, _, (_, one), ranks = runs
    ref, got = _losses(os.path.join(root, "tp1")), _losses(os.path.join(root, "tp2"))
    assert sorted(got) == sorted(ref) and len(ref) == 3, (sorted(got), sorted(ref))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=str(k))
    for _, fit in ranks:
        assert fit["shard_shapes"]["box_merge.up_conv_4.weight"] == [16, 4, 3, 3]
        assert "box_merge.up_conv_5.weight" not in fit["shard_shapes"]
    assert one["shard_shapes"] == {}


def test_a_tp2_checkpoint_is_the_one_process_file(runs):
    _, jax_params, (_, one), ranks = runs
    path = ranks[0][1]["last_ckpt_path"]
    blob = jax_io.load(path)  # the JAX package's reader
    assert blob["meta"]["global_step"] == 2
    got = dict(_jax_leaves(blob["params"]))
    assert {k: np.shape(v) for k, v in got.items()} == {k: np.shape(v) for k, v in _jax_leaves(jax_params)}
    task = S.BBSpatialRoadMap(HP, device="cpu", generator=torch.Generator().manual_seed(1))
    port = ckpt_io.load(path)
    load_jax_weights(task, port["params"], port.get("state"), what=path)  # one process, whole weights
    ref = dict(_jax_leaves(ckpt_io.load(one["last_ckpt_path"])["params"]))
    assert sorted(ref) == sorted(got)
    moved = 0
    for k, r in ref.items():
        assert _rel(got[k], r) <= LEAF_TOL, (k, _rel(got[k], r))
        moved += not np.array_equal(np.asarray(r), np.asarray(dict(_jax_leaves(jax_params))[k]))
    assert moved >= 30  # every head leaf stepped; the frozen encoder did not
