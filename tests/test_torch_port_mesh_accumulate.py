"""driving_dirty_tpu_torch's Trainer on two data ranks under gradient
accumulation, on the CPU over gloo: a window cut mid-way by a stop.

Each data rank holds its share of a window's accumulated gradient until
the window's end sums the shares over 'data', so a checkpoint taken
inside a window must sum them, and a resume under 'data' must share the
whole out again. roadmap_bce (AE hidden 16, latent 8, 32 x 306 views, its
encoder frozen), global batch 4 on dp=2, accumulate_grad_batches=2, five
batches (two windows and the first micro-batch of a third), through
parallel/launch.py:fit_worker:

  * uninterrupted on the two ranks, its best and last checkpoints written
    at the epoch's end inside the third window (one snapshot for both,
    its accumulator summed once by every rank);
  * stopped by max_steps=3 (after the first micro-batch of the second
    window), on the two ranks and, for its accumulator, in one process;
  * the two-rank checkpoint resumed on the two ranks and in one process.

The checkpoint's accumulator against the one-process stop's: relative L2
error 1e-5 per tensor (the same gradient, its halves summed in another
order). Both resumed runs against the uninterrupted one: the losses of
steps 3-4 rtol 1e-6 and the final weights 1e-5 per tensor by relative L2
error, the bars of tests/test_torch_port_mesh_train.py's resume.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
from driving_dirty_tpu_torch.parallel import launch

STEPS, STOP = 5, 3
RESUME_RTOL, STATE_TOL = 1e-6, 1e-5


def spec(root, name, checkpoints=False, **trainer):
    rng = np.random.RandomState(0)
    batches = [{"images": rng.randint(0, 256, (4, 6, 32, 306, 3)).astype(np.uint8),
                "road": (rng.rand(4, 800, 800) > 0.5).astype(np.float32)} for _ in range(STEPS)]
    hparams = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=32, pretrained_path=None, batch_size=4,
                   unfreeze_epoch_no=1)
    return dict(task=RoadMapBCEv2, hparams=hparams, seed=0, batches=batches, val_batches=batches[:1],
                state=True, device="cpu",
                trainer=dict(max_epochs=1, log_every_n_steps=1, enable_progress_bar=False,
                             accumulate_grad_batches=2, enable_checkpointing=checkpoints,
                             default_root_dir=os.path.join(root, name), **trainer))


def rank_fits(root):
    out = {"whole": launch.fit_worker(spec(root, "whole", checkpoints=True)),
           "stop": launch.fit_worker(spec(root, "stop", max_steps=STOP, checkpoints=True))}
    out["resumed"] = launch.fit_worker(dict(spec(root, "resumed"), resume=out["stop"]["last_ckpt_path"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_accumulate"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch.spawn, rank_fits, 2, (d,), device="cpu", threads=1,
                                init_method=f"file://{d}/rdzv")
            one = {"stop": launch.fit_worker(spec(d, "stop_one", max_steps=STOP, checkpoints=True))}
            ranks = ranks.result()
        one["resumed"] = launch.fit_worker(dict(spec(d, "resumed_one"), resume=ranks[0]["stop"]["last_ckpt_path"]))
    return d, one, ranks


def _losses(root):
    recs = []
    for path in glob.glob(os.path.join(root, "roadmap_bce", "version_*", "tb", "metrics.jsonl")):
        with open(path) as f:
            recs += [json.loads(line) for line in f]
    return {r["step"]: r["train_loss"] for r in recs if "train_loss" in r}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree) -> int:
    return sum(_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def test_a_mid_window_checkpoint_holds_the_global_accumulator(runs):
    _, one, ranks = runs
    got, want = (ckpt_io.load(r["stop"]["last_ckpt_path"]) for r in (ranks[0], one))
    assert got["meta"]["global_step"] == STOP and got["meta"]["mid_epoch"]
    assert int(got["opt_state"][0]) == int(want["opt_state"][0]) == 1  # MultiSteps' mini_step
    n = _leaves(got["params"])  # the accumulator: the last n leaves, one a parameter
    moved = 0
    for i, (a, b) in enumerate(zip(got["opt_state"][-n:], want["opt_state"][-n:])):
        assert _rel(np.asarray(a), np.asarray(b)) <= STATE_TOL, i
        moved += bool(np.any(b))
    assert moved  # the trained head's accumulator is not zero


@pytest.mark.parametrize("where", ["two_ranks", "one_process"])
def test_a_dp2_run_cut_mid_window_resumes_exactly(runs, where):
    d, one, ranks = runs
    ref = _losses(os.path.join(d, "whole"))
    got = _losses(os.path.join(d, "resumed" if where == "two_ranks" else "resumed_one"))
    assert sorted(ref) == list(range(STEPS)) and sorted(got) == list(range(STOP, STEPS))
    for s in got:
        np.testing.assert_allclose(got[s], ref[s], rtol=RESUME_RTOL, err_msg=f"step {s}")
    want = ranks[0]["whole"]["state"]
    state = (ranks[1] if where == "two_ranks" else one)["resumed"]["state"]
    for k, v in state.items():
        assert _rel(v.double().numpy(), want[k].double().numpy()) <= STATE_TOL, k
