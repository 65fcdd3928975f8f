"""driving_dirty_tpu_torch/cli/submit.py's registry and concurrent fan-out
against the JAX package's (driving_dirty_tpu/cli/submit.py), on the CPU:
each case of tests/test_submit_fanout.py, and

  * the registry names the JAX package's ten models, and `grid_trials`
    gives each model's JAX override dicts in the same order (no tolerance:
    the same Python values);
  * `_trial_env` pins CUDA_VISIBLE_DEVICES by concurrency slot, disjoint
    across slots, on a host whose cards are monkeypatched (8, or those a
    parent CUDA_VISIBLE_DEVICES names, as many as torch counts), and pins
    nothing under --device
    cpu; `--parallel_trials` above the card count is clamped with a
    printed message;
  * two BasicAE trials run concurrently as subprocesses on the CPU (views
    cut to their top 16 rows, hidden 8, latent 8, one step and one
    validation batch a trial), each with its log, a finite val_loss and
    the summary table; a trial that fails keeps its return code, shows in
    the table and makes the process's exit code 1.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from driving_dirty_tpu.cli import submit as J
from driving_dirty_tpu_torch.cli import submit as S
from driving_dirty_tpu_torch.data.synthetic import generate


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """3 unlabeled and 2 labeled scenes of 2 samples, views cut to 16 rows."""
    d = tmp_path_factory.mktemp("dd_fanout")
    generate(str(d), scenes=3, samples=2, labeled_scenes=2, seed=0)
    for path in glob.glob(os.path.join(d, "scene_*", "sample_*", "CAM_*.jpeg")):
        with Image.open(path) as im:
            view = im.crop((0, 0, im.width, 16))
        view.save(path, quality=90)
    return str(d)


def test_the_registry_and_every_models_grid_are_the_jax_packages():
    assert list(S._registry()) == list(J._registry())
    for name in S._registry():
        assert S._registry()[name].name == J._registry()[name].name, name
        assert S.grid_trials(name, None) == J.grid_trials(name, None), name
        assert S.grid_trials(name, 2) == J.grid_trials(name, 2), name


def test_strip_flags_pairs_and_eq():
    argv = ["--model", "basic_ae", "--on_cluster", "--parallel_trials", "2",
            "--gpus=4", "--link", "/x", "--nb_hopt_trials", "2"]
    kw = dict(value_flags={"--parallel_trials", "--nb_hopt_trials", "--gpus"}, bare_flags={"--on_cluster"})
    assert S._strip_flags(argv, **kw) == ["--model", "basic_ae", "--link", "/x"] == J._strip_flags(argv, **kw)


def test_trial_env_pins_disjoint_cards_by_slot(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(S, "_visible_cards", lambda: [str(i) for i in range(8)])
    # by concurrency SLOT, not trial index: trial 5 in slot 1 of a 2-wide
    # pool takes cards 4-7, never cards 20-23 of an 8-card host
    e0 = S._trial_env(0, slot=0, devices_per_trial=4)
    e1 = S._trial_env(5, slot=1, devices_per_trial=4)
    assert e0["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    assert e1["CUDA_VISIBLE_DEVICES"] == "4,5,6,7"
    assert e1["DD_TRIAL_INDEX"] == "5"
    assert "CUDA_VISIBLE_DEVICES" not in S._trial_env(1, slot=1, devices_per_trial=4, device="cpu")
    assert "CUDA_VISIBLE_DEVICES" not in S._trial_env(1, slot=0, devices_per_trial=None)


def test_trial_env_maps_slots_through_the_parents_visible_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6,7")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert S._visible_cards() == ["3", "5", "6", "7"]
    assert [S._trial_env(i, slot=i, devices_per_trial=2)["CUDA_VISIBLE_DEVICES"] for i in range(2)] == \
        ["3,5", "6,7"]


def test_parallel_trials_clamp_to_the_cards(monkeypatch, capsys):
    monkeypatch.setattr(S, "_visible_cards", lambda: ["0"])
    args = SimpleNamespace(parallel_trials=2, gpus=None, device="cuda")
    assert S._concurrency(args) == (1, 1)
    assert "clamping --parallel_trials 2 -> 1" in capsys.readouterr().out
    monkeypatch.setattr(S, "_visible_cards", lambda: [str(i) for i in range(8)])
    assert S._concurrency(args) == (2, 4)
    # more --gpus than the host has cards is refused before any trial starts
    monkeypatch.setattr(S, "_visible_cards", lambda: ["0"])
    with pytest.raises(ValueError, match="--gpus 4 but 1 card"):
        S._concurrency(SimpleNamespace(parallel_trials=2, gpus=4, device="cuda"))
    # on the CPU each trial may take the whole --gpus, and nothing is clamped
    assert S._concurrency(SimpleNamespace(parallel_trials=4, gpus=None, device="cpu")) == (4, None)
    assert S._concurrency(SimpleNamespace(parallel_trials=2, gpus=4, device="cpu")) == (2, 2)
    assert "clamping" not in capsys.readouterr().out


def _fanout_argv(data_dir, tmp_path, name, *extra):
    return ["--model", "basic_ae", "--link", data_dir, "--on_cluster", "--parallel_trials", "2",
            "--nb_hopt_trials", "2", "--gpus", "2", "--tt_name", name, "--logs_save_path", str(tmp_path),
            "--hidden_dim", "8", "--latent_dim", "8", "--input_height", "16", "--output_height", "16",
            "--batch_size", "2", "--max_epochs", "1", "--limit_train_batches", "1", "--limit_val_batches", "1",
            "--num_workers", "1", "--samples_per_scene", "2", "--num_unlabeled_scenes", "3",
            "--output_img_freq", "0", "--device", "cpu", *extra]


def test_two_trial_concurrent_run(data_dir, tmp_path, monkeypatch, capsys):
    """Two trials of one device each, concurrently; each fits BasicAE for one
    tiny epoch and reports a finite val_loss."""
    monkeypatch.setenv("DD_NO_TB", "1")
    monkeypatch.setenv("DD_NO_COST_ANALYSIS", "1")
    results = S.main(_fanout_argv(data_dir, tmp_path, "fanout_test"))
    assert len(results) == 2
    for r in results:
        assert r["rc"] == 0, open(r["log"]).read()[-2000:]
        assert r["val_loss"] is not None and np.isfinite(r["val_loss"])
        assert os.path.exists(r["log"]) and r["cuda_visible_devices"] is None
    assert len({tuple(sorted(r["overrides"].items())) for r in results}) == 2
    assert S.grid_trials("basic_ae", 2) == [r["overrides"] for r in sorted(results, key=lambda r: r["trial"])]
    out = capsys.readouterr().out
    assert "=== fanout_test: 2 trials, 2 concurrent, 1 device(s)/trial ===" in out
    assert S.exit_code(results) == 0


def test_a_failed_trial_is_not_swallowed(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DD_NO_TB", "1")
    missing = str(tmp_path / "no_such_dataset")
    results = S.main(_fanout_argv(missing, tmp_path, "fails", "--nb_hopt_trials", "1"))
    assert len(results) == 1 and results[0]["rc"] not in (0, 3)
    assert results[0]["val_loss"] is None and "Traceback" in open(results[0]["log"]).read()
    assert f"    0  {results[0]['rc']:>3}" in capsys.readouterr().out
    assert S.exit_code(results) == 1


def test_on_done_cmd_hook(tmp_path):
    sentinel = tmp_path / "done.txt"
    args = SimpleNamespace(on_done_cmd=f'echo "$DD_TRIAL_NAME rc=$DD_TRIAL_RC vl=$DD_TRIAL_VAL_LOSS" > {sentinel}')
    S._notify_done(args, "trial_3", 0, 0.125)
    assert sentinel.read_text().strip() == "trial_3 rc=0 vl=0.125"
    S._notify_done(SimpleNamespace(on_done_cmd=None), "x", 1, None)  # no-op
