"""driving_dirty_tpu_torch/cli/submit.py's Slurm emission and walltime
contract against the JAX package's, on the CPU: each case of
tests/test_submit_slurm.py, and the emitted scripts equal the JAX
package's line for line but for the module each runs
(driving_dirty_tpu_torch.cli.submit for driving_dirty_tpu.cli.submit),
for every registered model; `--emit_commands` likewise. The walltime stop
runs `python -m driving_dirty_tpu_torch.cli.submit --device cpu` on a
synthetic dataset whose views are cut to their top 16 rows (BasicAE
hidden 8, latent 8).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import glob
import os
import subprocess
import sys

import pytest
from PIL import Image

from driving_dirty_tpu.cli import submit as J
from driving_dirty_tpu_torch.cli import submit as S
from driving_dirty_tpu_torch.data.synthetic import generate


def test_slurm_time_to_minutes():
    for t, m in (("24:00:00", 1440), ("1-02:30:00", 1590), ("90", 90), ("30:30", 30.5)):
        assert S._slurm_time_to_minutes(t) == m == J._slurm_time_to_minutes(t)


def _grid_argv(tmp_path, out, model="basic_ae"):
    return ["--model", model, "--link", "/data/dd", "--emit_slurm", str(out), "--nb_hopt_trials", "4",
            "--slurm_time", "2:00:00", "--slurm_gres", "gpu:h100:1", "--notify_email", "a@example.com",
            "--conda_env", "dd", "--tt_name", "grid", "--logs_save_path", str(tmp_path / "logs")]


def test_emit_slurm_scripts(tmp_path):
    out = tmp_path / "sbatch"
    scripts = S.main(_grid_argv(tmp_path, out))
    assert len(scripts) == 4
    assert (out / "submit_all.sh").read_text().count("sbatch ") == 4
    s0 = (out / "trial_0.sh").read_text()
    for line in ("#SBATCH --time=2:00:00", "#SBATCH --cpus-per-task=10", "#SBATCH --mem=30GB",
                 "#SBATCH --gres=gpu:h100:1", "#SBATCH --mail-user=a@example.com", "#SBATCH --mail-type=END,FAIL",
                 "source activate dd", "#SBATCH --signal=B:TERM@300", "--walltime_minutes 120.0",
                 '[ -f "$CKPT" ] && RESUME="--resume_from_checkpoint $CKPT"', "/trial_0/basic_ae/last.ckpt",
                 "if [ $rc -eq 3 ]; then", 'sbatch "$0"', "--single_run", "--latent_dim", "--tt_name trial_0"):
        assert line in s0, line
    assert "--emit_slurm" not in s0 and "--notify_email" not in s0
    assert os.access(out / "trial_0.sh", os.X_OK)
    cmds = [next(ln for ln in (out / f"trial_{i}.sh").read_text().splitlines() if S.MODULE in ln)
            for i in range(2)]
    assert cmds[0] != cmds[1]  # distinct grid points


@pytest.mark.parametrize("model", list(S._registry()))
def test_the_scripts_are_the_jax_packages_line_for_line(tmp_path, model):
    """Every script and submit_all.sh, from the same argv, on one log root."""
    got = S.main(_grid_argv(tmp_path, tmp_path / "port", model))
    ref = J.main(_grid_argv(tmp_path, tmp_path / "jax", model))
    assert len(got) == len(ref) == len(S.grid_trials(model, 4))
    for g, r in zip(got, ref):
        want = open(r).read().replace("driving_dirty_tpu.cli.submit", S.MODULE)
        assert open(g).read().splitlines() == want.splitlines()
    submit_all = (tmp_path / "jax" / "submit_all.sh").read_text().replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert (tmp_path / "port" / "submit_all.sh").read_text() == submit_all


def test_emit_commands_are_the_jax_packages(capsys):
    argv = ["--model", "multitask", "--emit_commands", "--nb_hopt_trials", "3", "--tt_name", "x"]
    S.main(argv)
    got = capsys.readouterr().out.splitlines()
    J.main(argv)
    ref = [ln.replace("driving_dirty_tpu.cli.submit", S.MODULE) for ln in capsys.readouterr().out.splitlines()]
    assert got == ref and len(got) == 3


def test_emit_slurm_minimal_omits_optional(tmp_path):
    out = tmp_path / "sbatch"
    S.main(["--model", "bb_mlp", "--emit_slurm", str(out), "--logs_save_path", str(tmp_path / "logs")])
    s = (out / "trial_0.sh").read_text()
    assert "--partition" not in s and "--gres" not in s
    assert "--mail-user" not in s and "source activate" not in s
    assert "#SBATCH --time=24:00:00" in s  # the reference's default walltime


def test_walltime_stop_exits_3_and_resumes(tmp_path):
    """The contract the sbatch scripts rely on: a run that hits its walltime
    budget checkpoints and exits 3; rerunning with --resume_from_checkpoint
    finishes and exits 0."""
    data = tmp_path / "data"
    generate(str(data), scenes=2, samples=2, labeled_scenes=1, seed=0)
    for path in glob.glob(os.path.join(data, "scene_*", "sample_*", "CAM_*.jpeg")):
        with Image.open(path) as im:
            view = im.crop((0, 0, im.width, 16))
        view.save(path, quality=90)
    logs = tmp_path / "logs"
    base = [sys.executable, "-m", S.MODULE, "--model", "basic_ae", "--single_run", "--link", str(data),
            "--tt_name", "wt", "--logs_save_path", str(logs), "--hidden_dim", "8", "--latent_dim", "8",
            "--input_height", "16", "--output_height", "16", "--batch_size", "2", "--max_epochs", "1",
            "--limit_train_batches", "2", "--limit_val_batches", "1", "--num_workers", "1",
            "--samples_per_scene", "2", "--num_unlabeled_scenes", "2", "--output_img_freq", "0", "--device", "cpu"]
    env = dict(os.environ, DD_NO_TB="1", DD_NO_COST_ANALYSIS="1", OMP_NUM_THREADS="1")
    # a budget of 5 min with the checkpoint 5 min early: it stops after step 1
    p1 = subprocess.run(base + ["--walltime_minutes", "5"], env=env, capture_output=True, text=True, timeout=300)
    assert p1.returncode == 3, p1.stdout[-2000:] + p1.stderr[-2000:]
    ckpt = logs / "wt" / "basic_ae" / "last.ckpt"  # single_run: no trial_i subdirectory
    assert ckpt.exists()
    p2 = subprocess.run(base + ["--resume_from_checkpoint", str(ckpt)], env=env, capture_output=True, text=True,
                        timeout=300)
    assert p2.returncode == 0, p2.stdout[-2000:] + p2.stderr[-2000:]
