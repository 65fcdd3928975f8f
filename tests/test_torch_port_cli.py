"""driving_dirty_tpu_torch's main-path CLIs and their data plumbing against
the JAX package, on the CPU:

  * the flag surface of tests/test_flags_surface.py for the port's
    basic_ae and the three roadmap variants: every flag the JAX parser
    (trainer flags + the model's flags) takes is taken here, with the same
    defaults, and the canonical reference invocation routes into the task;
  * the multi-device flags each train one step through the spawned ranks,
    and a missing card raises;
  * run_test's Lightning fallback: a reference-style roadmap state_dict
    written with torch.save loads into the weights JAX's
    checkpoints/torch_import.py:import_roadmap gives, exactly;
  * data/synthetic.py writes the same bytes as the JAX package's generator
    for one seed, and data/cache.py's SampleCache builds the same files and
    reads a cache the JAX package wrote, exactly.

Everything here is exact: the flags are compared as values, the weights
move through transposes only, and the data are bytes.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import argparse
import filecmp
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from driving_dirty_tpu.checkpoints.torch_import import import_roadmap as jax_import_roadmap
from driving_dirty_tpu.cli.common import add_trainer_args as jax_trainer_args
from driving_dirty_tpu.data.cache import SampleCache as JSampleCache
from driving_dirty_tpu.data.dataset import LabeledDataset as JLabeledDataset
from driving_dirty_tpu.data.synthetic import generate as jax_generate
from driving_dirty_tpu.models import basic_ae as JB
from driving_dirty_tpu.models import roadmap as JR
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import from_jax, transposed_paths
from driving_dirty_tpu_torch.cli import basic_ae as cli_basic_ae
from driving_dirty_tpu_torch.cli import roadmap as cli_roadmap
from driving_dirty_tpu_torch.cli import run_test
from driving_dirty_tpu_torch.cli.common import add_trainer_args
from driving_dirty_tpu_torch.data.cache import SampleCache
from driving_dirty_tpu_torch.data.dataset import LabeledDataset
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.export import save_task_ckpt
from driving_dirty_tpu_torch.models import basic_ae as B
from driving_dirty_tpu_torch.models import roadmap as R

MODELS = {"basic_ae": (B.BasicAE, JB.BasicAE), "roadmap_mse": (R.RoadMap, JR.RoadMap),
          "roadmap_bce_v1": (R.RoadMapBCE, JR.RoadMapBCE), "roadmap_bce": (R.RoadMapBCEv2, JR.RoadMapBCEv2)}
TRAINER_FLAGS = ["--gpus", "--max_epochs", "--precision", "--num_nodes", "--resume_from_checkpoint",
                 "--default_root_dir", "--seed", "--max_steps", "--model_parallel", "--walltime_minutes"]
MODEL_FLAGS_UNIVERSAL = ["--link", "--batch_size", "--learning_rate", "--output_img_freq"]


def _parser(add_model, add_trainer=add_trainer_args):
    return add_model(add_trainer(argparse.ArgumentParser()))


@pytest.fixture(scope="module")
def tiny_ae_ckpt(tmp_path_factory):
    """A small BasicAE checkpoint for --pretrained_path (16 x 24 views)."""
    path = tmp_path_factory.mktemp("ae") / "ae.ckpt"
    ae = B.BasicAE(dict(hidden_dim=8, latent_dim=6, input_height=16, input_width=24,
                        output_height=16, output_width=4), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    save_task_ckpt(path, ae)
    return str(path)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_jax_flag_parses_with_its_default(name):
    port_cls, jax_cls = MODELS[name]
    port, ref = _parser(port_cls.add_model_specific_args), _parser(jax_cls.add_model_specific_args,
                                                                   jax_trainer_args)
    missing = set(ref._option_string_actions) - set(port._option_string_actions)
    assert not missing, f"{name}: the port's CLI lacks {sorted(missing)}"
    for f in TRAINER_FLAGS + MODEL_FLAGS_UNIVERSAL:
        assert f in port._option_string_actions, f
    if name != "basic_ae":
        assert {"--pretrained_path", "--unfreeze_epoch_no", "--cache_dir"} <= set(port._option_string_actions)
    got, want = vars(port.parse_args([])), vars(ref.parse_args([]))
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_reference_invocation_routes_into_the_task(name, tiny_ae_ckpt):
    port_cls, _ = MODELS[name]
    argv = ["--link", "/tmp/data", "--gpus", "1", "--max_epochs", "5", "--batch_size", "3",
            "--learning_rate", "0.01", "--seed", "123", "--device", "cpu"]
    argv += ["--hidden_dim", "8", "--latent_dim", "8"] if name == "basic_ae" else ["--pretrained_path", tiny_ae_ckpt]
    args = _parser(port_cls.add_model_specific_args).parse_args(argv)
    assert args.max_epochs == 5 and args.gpus == 1 and args.seed == 123
    task = port_cls(args, device="cpu", generator=torch.Generator().manual_seed(0))
    assert task.batch_size == 3
    assert abs(task.learning_rate() - 0.01) < 1e-12
    assert (task.hidden_dim, task.latent_dim) == (8, 8) if name == "basic_ae" else task.latent_dim == 6


@pytest.fixture(scope="module")
def rank_data(tmp_path_factory):
    """A synthetic dataset of 3 unlabeled and 3 labeled scenes of 2 samples,
    its views cut to their top 16 rows, and a BasicAE checkpoint for them
    (hidden 8, latent 8, 16 x 306 views)."""
    d = tmp_path_factory.mktemp("rank_data")
    generate(str(d / "data"), scenes=3, samples=2, labeled_scenes=3, seed=0)
    for path in glob.glob(os.path.join(d, "data", "scene_*", "sample_*", "CAM_*.jpeg")):
        with Image.open(path) as im:
            view = im.crop((0, 0, im.width, 16))
        view.save(path, quality=90)
    ae = B.BasicAE(dict(hidden_dim=8, latent_dim=8, input_height=16, output_height=16), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    save_task_ckpt(d / "ae.ckpt", ae)
    return d


@pytest.mark.parametrize("flags", [["--gpus", "2"], ["--num_nodes", "2"], ["--model_parallel", "2"]])
@pytest.mark.parametrize("cli", [cli_basic_ae, cli_roadmap])
def test_multi_device_flags_raise(cli, flags, rank_data, tmp_path, monkeypatch):
    """Each multi-device flag (which raised before multi-device training was
    ported) trains one step on the CPU through the spawn path: --gpus 2
    spawns two ranks; --num_nodes 2 runs two nodes of one rank each, met
    through DD_COORDINATOR_ADDRESS / DD_NUM_PROCESSES / DD_PROCESS_ID (node
    1 in a second process); --model_parallel 2 needs two ranks (--gpus 2).
    Rank 0's FitResult comes back without its task."""
    monkeypatch.setenv("DD_NO_TB", "1")
    monkeypatch.setenv("DD_NO_COST_ANALYSIS", "1")
    argv = ["--link", str(rank_data / "data"), "--samples_per_scene", "2", "--batch_size", "2",
            "--max_epochs", "1", "--max_steps", "1", "--log_every_n_steps", "1", "--output_img_freq", "0",
            "--num_workers", "1", "--device", "cpu", "--default_root_dir", str(tmp_path)]
    if cli is cli_basic_ae:
        argv += ["--num_unlabeled_scenes", "3", "--hidden_dim", "8", "--latent_dim", "8",
                 "--input_height", "16", "--output_height", "16"]
    else:
        argv += ["--num_labeled_scenes", "3", "--pretrained_path", str(rank_data / "ae.ckpt")]
    argv += flags + (["--gpus", "2"] if flags[0] == "--model_parallel" else [])
    node = None
    if flags[0] == "--num_nodes":
        monkeypatch.setenv("DD_COORDINATOR_ADDRESS", f"file://{tmp_path}/rdzv")
        monkeypatch.setenv("DD_NUM_PROCESSES", "2")
        node = subprocess.Popen([sys.executable, "-m", cli.__name__, *argv], env=dict(os.environ, DD_PROCESS_ID="1"),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        monkeypatch.setenv("DD_PROCESS_ID", "0")
    result = cli.main(argv)
    if node is not None:
        out = node.communicate(timeout=120)[0]
        assert node.returncode == 0, out
    name = "basic_ae" if cli is cli_basic_ae else "roadmap_bce"
    assert result.task is None and result.stop_reason == "max_steps=1 reached"
    assert ckpt_io.load(result.last_ckpt_path)["meta"]["global_step"] == 1
    recs = [json.loads(x) for x in open(tmp_path / name / "version_0" / "tb" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "train_loss" in r] == [0]


def test_the_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_basic_ae.main([])


def test_run_test_requires_a_checkpoint():
    with pytest.raises(SystemExit):
        run_test.main(["--link", "/tmp/x"])


def _reference_state_dict(model):
    """The reference's Lightning names for a roadmap model's weights:
    ae.encoder.<c1..c3, fc1/fc2 (inner fc1 + fc_bn), fc_z_out>, fc1."""
    out = {}
    for k, v in model.state_dict().items():
        k = k.replace(".fc.", ".fc1.").replace(".bn.", ".fc_bn.")
        out[("ae." + k) if k.startswith("encoder.") else k] = v.clone()
    return out


def test_run_test_loads_a_lightning_checkpoint_as_jax_imports_it(tmp_path, tiny_ae_ckpt):
    model = R.RoadMapBCEv2(dict(pretrained_path=tiny_ae_ckpt), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    for m in model.modules():  # BN statistics away from their init
        if hasattr(m, "running_mean"):
            m.running_mean.uniform_(-1, 1)
            m.running_var.uniform_(0.5, 2)
    path = tmp_path / "rm.ckpt"
    torch.save({"state_dict": _reference_state_dict(model),
                "hparams": argparse.Namespace(learning_rate=1e-3, ae_input_height=16, ae_input_width=24,
                                              pretrained_path="/elsewhere/ae.ckpt"),
                "epoch": 3}, path)
    loaded = run_test.load_roadmap_model(str(path), device="cpu")
    params, state, _ = jax_import_roadmap(str(path))
    ref = from_jax(params, state, transposed=transposed_paths(loaded))
    got = loaded.state_dict()
    assert set(ref) == set(got) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], ref[k]) and torch.equal(got[k], v), k


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_data_and_sample_cache_match_the_jax_package(tmp_path):
    kw = dict(scenes=1, samples=2, labeled_scenes=2, seed=3)
    generate(str(tmp_path / "port"), **kw)
    jax_generate(str(tmp_path / "jax"), **kw)
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax") and len(files) == 2 * 6 + 4 * 7 + 1
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax", files, shallow=False)
    assert not mismatch and not errors

    link = str(tmp_path / "port")
    scenes = np.arange(106, 108)
    args = (link, f"{link}/annotation.csv", scenes)
    port = SampleCache(LabeledDataset(*args, samples_per_scene=2, raw_uint8=True), str(tmp_path / "c_port"))
    ref = JSampleCache(JLabeledDataset(*args, samples_per_scene=2, raw_uint8=True), str(tmp_path / "c_jax"))
    assert port.warm(num_workers=2) == ref.warm(num_workers=2) == 4
    assert os.path.basename(port.dir) == os.path.basename(ref.dir)  # one fingerprint
    cached = _tree_files(port.dir)
    assert cached == _tree_files(ref.dir)
    _, mismatch, errors = filecmp.cmpfiles(port.dir, ref.dir, [f for f in cached if f != ".init.lock"],
                                           shallow=False)
    assert not mismatch and not errors
    # a cache the JAX package wrote serves the port's dataset, every row a hit
    reader = SampleCache(LabeledDataset(*args, samples_per_scene=2, raw_uint8=True), str(tmp_path / "c_jax"))
    plain = LabeledDataset(*args, samples_per_scene=2, raw_uint8=True)
    for i in range(len(plain)):
        got, want = reader[i], plain[i]
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert (reader.hits, reader.misses) == (len(plain), 0)
