"""Experiment orchestration: the model registry and the hyperparameter
grid's fan-out (driving_dirty_tpu/cli/submit.py).

The reference's MODEL_NAMES registry, two-phase parsing keyed on --model,
and test-tube's grid-search fan-out (`optimize_parallel_cluster_gpu`). The
fan-out is N independent runs, one a trial:

  * default: one after another in this process;
  * --on_cluster / --parallel_trials K: K concurrent subprocesses on this
    host, each pinned to its own cards (CUDA_VISIBLE_DEVICES, by
    concurrency slot), with a log file a trial and a summary table. K is
    clamped to the cards on the host; on --device cpu nothing is pinned;
  * --emit_commands: one shell command a trial, for an external scheduler;
  * --emit_slurm DIR: one sbatch script a trial and a submit_all.sh; each
    script resumes from its trial's last.ckpt and resubmits itself when
    the trial stops on its walltime budget (exit code 3).

    python -m driving_dirty_tpu_torch.cli.submit --model roadmap_bce \\
        --link <data> [--single_run] [--nb_hopt_trials 12] [--tt_name exp1] \\
        [--on_cluster --parallel_trials 4]

A trial trains through cli/common.py:fit_from_args, as the model's own CLI
does (`--gpus N` spawns N ranks; `--device cpu` trains on the CPU).

Reference flags kept: --model, --tt_name, --tt_description,
--logs_save_path, --single_run, --nb_hopt_trials, --on_cluster, --nodes,
--conda_env.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

MODULE = "driving_dirty_tpu_torch.cli.submit"


def _registry():
    from driving_dirty_tpu_torch.models.basic_ae import BasicAE
    from driving_dirty_tpu_torch.models.bb_mlp import Boxes
    from driving_dirty_tpu_torch.models.faster_rcnn import BBFasterRCNN, FasterRCNNRoadMap
    from driving_dirty_tpu_torch.models.multitask import MultiTask
    from driving_dirty_tpu_torch.models.roadmap import RoadMap, RoadMapBCE, RoadMapBCEv2
    from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap

    return {
        "basic_ae": BasicAE,
        "roadmap_mse": RoadMap,
        "roadmap_bce": RoadMapBCEv2,
        "roadmap_bce_v1": RoadMapBCE,
        "spatial_bb": BBSpatialModel,
        "spatial_rm": BBSpatialRoadMap,
        "bb_mlp": Boxes,
        "multitask": MultiTask,
        "faster_rcnn": BBFasterRCNN,
        "faster_rcnn_rm": FasterRCNNRoadMap,
    }


def grid_trials(model_name, limit):
    """Trial override dicts for a model's tunable grid. The dimensions live
    with the models (cli/hyperopt.py's `opt_list(..., tunable=True)` and
    `tune` in each `add_model_specific_args`); this collects them off a
    throwaway parser."""
    from driving_dirty_tpu_torch.cli.hyperopt import HyperOptArgumentParser

    p = HyperOptArgumentParser(add_help=False)
    _registry()[model_name].add_model_specific_args(p)
    return p.grid(limit)


def _strip_flags(argv, value_flags, bare_flags):
    """Remove orchestration flags from an argv list (keeping trial flags)."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        name = tok.split("=")[0]
        if name in bare_flags:
            continue
        if name in value_flags:
            skip = "=" not in tok
            continue
        out.append(tok)
    return out


def _visible_cards() -> list[str]:
    """This host's usable cards as CUDA_VISIBLE_DEVICES names them: the
    first torch.cuda.device_count() entries of the parent's
    CUDA_VISIBLE_DEVICES when it is set, else their indices. Counting
    creates no CUDA context in this process, whose trials' processes need
    the cards (device nodes are no count: a container may show every card
    of its host and open only its own)."""
    import torch

    n = torch.cuda.device_count()
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = [v.strip() for v in vis.split(",") if v.strip()] if vis is not None else [str(i) for i in range(n)]
    return names[:n]


def _trial_env(trial_index, slot, devices_per_trial, device="cuda"):
    """A trial subprocess's environment, pinned to its own cards.

    On cards, the trial in concurrency SLOT s owns cards [s*k, (s+1)*k)
    of this host's (CUDA_VISIBLE_DEVICES). Pinning is by slot, not trial
    index: with 12 trials at 4 concurrent, trial 5 takes the cards of
    whichever slot freed up, never cards [10, 11] of an 8-card host. On the
    CPU (--device cpu) nothing is pinned: process isolation keeps the
    trials apart."""
    env = os.environ.copy()
    env["DD_TRIAL_INDEX"] = str(trial_index)
    if not devices_per_trial or not str(device).startswith("cuda"):
        return env
    k = devices_per_trial
    cards = _visible_cards()
    env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[slot * k + j] for j in range(k))
    return env


def _last_val_loss(trial_root):
    """Best (min) val_loss across any task metrics.jsonl under trial_root."""
    best = None
    for dirpath, _, files in os.walk(trial_root):
        if "metrics.jsonl" not in files:
            continue
        with open(os.path.join(dirpath, "metrics.jsonl")) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                v = rec.get("val_loss")
                if v is not None and (best is None or v < best):
                    best = v
    return best


def _notify_done(args, name, rc, val_loss):
    """Completion hook (--on_done_cmd), in place of the reference's Slurm
    email (test-tube's notify_on_end): a user's shell command (curl a
    webhook, touch a sentinel, ...)."""
    cmd = getattr(args, "on_done_cmd", None)
    if not cmd:
        return
    env = os.environ.copy()
    env["DD_TRIAL_NAME"] = str(name)
    env["DD_TRIAL_RC"] = str(rc)
    env["DD_TRIAL_VAL_LOSS"] = "" if val_loss is None else repr(float(val_loss))
    try:
        subprocess.run(cmd, shell=True, env=env, timeout=120)
    except Exception as e:  # noqa: BLE001 — a notification never stops the runs
        print(f"[submit] on_done_cmd failed: {e}")


def _concurrency(args) -> tuple[int, int | None]:
    """-> (concurrent trials, devices a trial or None). On cards every
    concurrent trial needs cards of its own: --gpus (or the host's card
    count) bounds --parallel_trials, with a printed message, and is shared
    out; a --gpus above the host's card count raises. On the CPU every trial may have the whole --gpus."""
    n_par = max(1, args.parallel_trials)
    total_dev = args.gpus if args.gpus else None
    if str(args.device).startswith("cuda"):  # --device cuda or cuda:K
        cards = len(_visible_cards())
        if total_dev is None:
            total_dev = cards or 1
        elif total_dev > cards:
            raise ValueError(f"[submit] --gpus {total_dev} but {cards} card(s) on this host")
        if n_par > total_dev:
            print(f"[submit] clamping --parallel_trials {n_par} -> {total_dev} "
                  f"(one card minimum per trial; {total_dev} card(s) on this host)", flush=True)
            n_par = total_dev
        return n_par, total_dev // n_par
    return n_par, (total_dev // n_par) if total_dev and total_dev >= n_par else total_dev


def run_trials_concurrent(args, trials, base_argv):
    """Run the grid as concurrent pinned subprocesses with per-trial logs.

    In place of the reference's `optimize_parallel_cluster_gpu(nb_trials=12)`
    (12 Slurm jobs): up to --parallel_trials subprocesses run at once on
    this host, each on its own cards, logging to <root>/trial_i/trial.log.
    Returns a summary list of dicts (also printed as a table); a trial that
    fails keeps its return code there.
    """
    import queue
    from concurrent.futures import ThreadPoolExecutor

    n_par, dev_per_trial = _concurrency(args)
    clean = _strip_flags(
        list(base_argv),
        value_flags={"--parallel_trials", "--nb_hopt_trials", "--tt_name",
                     "--gpus", "--logs_save_path", "--on_done_cmd"},
        bare_flags={"--on_cluster", "--single_run", "--emit_commands"},
    )
    # cards are pinned per concurrency SLOT (returned to this pool when a
    # trial ends), so a trial index may exceed n_par without pinning off-host
    free_slots: "queue.Queue[int]" = queue.Queue()
    for s in range(n_par):
        free_slots.put(s)

    def run_one(i_ov):
        i, overrides = i_ov
        slot = free_slots.get()
        try:
            # the child makes its root logs_save_path/tt_name: <exp_root>/trial_i
            trial_root = os.path.join(args.default_root_dir, f"trial_{i}")
            os.makedirs(trial_root, exist_ok=True)
            cmd = [sys.executable, "-m", MODULE, *clean,
                   "--single_run", "--logs_save_path", args.default_root_dir,
                   "--tt_name", f"trial_{i}"]
            if dev_per_trial:
                cmd += ["--gpus", str(dev_per_trial)]
            for k, v in overrides.items():
                cmd += [f"--{k}", str(v)]
            log_path = os.path.join(trial_root, "trial.log")
            env = _trial_env(i, slot, dev_per_trial, args.device)
            t0 = time.perf_counter()
            with open(log_path, "w") as log:
                proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=os.getcwd())
            result = {
                "trial": i,
                "overrides": overrides,
                "rc": proc.returncode,
                "seconds": round(time.perf_counter() - t0, 1),
                "val_loss": _last_val_loss(trial_root),
                "log": log_path,
                "cuda_visible_devices": env.get("CUDA_VISIBLE_DEVICES"),
            }
        finally:
            free_slots.put(slot)
        # --on_done_cmd is stripped from the child's argv, so the parent is
        # the one notifier: one call a trial, with its name
        _notify_done(args, f"trial_{i}", result["rc"], result["val_loss"])
        return result

    with ThreadPoolExecutor(n_par) as pool:
        results = list(pool.map(run_one, enumerate(trials)))

    print(f"\n=== {args.tt_name}: {len(results)} trials, {n_par} concurrent"
          + (f", {dev_per_trial} device(s)/trial" if dev_per_trial else "") + " ===")
    print(f"{'trial':>5}  {'rc':>3}  {'sec':>7}  {'val_loss':>10}  overrides")
    for r in sorted(results, key=lambda r: (r["val_loss"] is None, r["val_loss"])):
        vl = f"{r['val_loss']:.5f}" if r["val_loss"] is not None else "-"
        print(f"{r['trial']:>5}  {r['rc']:>3}  {r['seconds']:>7.1f}  {vl:>10}  {r['overrides']}")
    return results


def _slurm_time_to_minutes(t: str) -> float:
    """Slurm --time strings to minutes: 'D-HH:MM:SS', 'HH:MM:SS', 'MM:SS'
    (Slurm reads bare 'MM' as minutes and 'MM:SS' as min:sec)."""
    days = 0
    if "-" in t:
        d, t = t.split("-", 1)
        days = int(d)
    parts = [int(p) for p in t.split(":")]
    if len(parts) == 3:
        h, m, s = parts
    elif len(parts) == 2:
        h, (m, s) = 0, parts
    else:
        h, m, s = 0, parts[0], 0
    return days * 1440 + h * 60 + m + s / 60.0


def emit_slurm(args, trials, base_argv):
    """Write one sbatch script per trial and a submit_all.sh that submits them.

    In place of test-tube's `SlurmCluster.optimize_parallel_cluster_gpu`:
    each script carries the job's resources (walltime, cpus and memory;
    the reference's defaults 24 h, 10, 30 GB), an optional email notice,
    conda activation, and the checkpoint-before-walltime resubmit contract
    (the reference's minutes_to_checkpoint_before_walltime=5): the trial
    runs with --walltime_minutes set to the Slurm budget, so the trainer
    writes its checkpoint 5 min early and exits with code 3, on which the
    script sbatches itself again to resume from last.ckpt.
    `#SBATCH --signal=B:TERM@300` is a second safety net: the trainer's
    SIGTERM handler checkpoints even if the in-process budget clock
    drifted.
    """
    import shlex

    out_dir = os.path.abspath(args.emit_slurm)
    os.makedirs(out_dir, exist_ok=True)
    exp_root = os.path.abspath(args.default_root_dir)
    wall_min = _slurm_time_to_minutes(args.slurm_time)
    clean = _strip_flags(
        list(base_argv),
        value_flags={"--parallel_trials", "--nb_hopt_trials", "--tt_name",
                     "--logs_save_path", "--on_done_cmd", "--emit_slurm",
                     "--slurm_time", "--slurm_cpus", "--slurm_mem",
                     "--slurm_partition", "--slurm_gres", "--notify_email",
                     "--conda_env", "--walltime_minutes",
                     "--resume_from_checkpoint"},
        bare_flags={"--on_cluster", "--single_run", "--emit_commands"},
    )
    task_name = _registry()[args.model].name  # the trainer writes <root>/<task.name>/
    scripts = []
    for i, overrides in enumerate(trials):
        trial_root = os.path.join(exp_root, f"trial_{i}")
        job = f"{args.tt_name}_t{i}"
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={job}",
            f"#SBATCH --output={trial_root}/slurm-%j.out",
            f"#SBATCH --time={args.slurm_time}",
            "#SBATCH --nodes=1",
            f"#SBATCH --cpus-per-task={args.slurm_cpus}",
            f"#SBATCH --mem={args.slurm_mem}",
            "#SBATCH --signal=B:TERM@300",
        ]
        if args.slurm_partition:
            lines.append(f"#SBATCH --partition={args.slurm_partition}")
        if args.slurm_gres:
            lines.append(f"#SBATCH --gres={args.slurm_gres}")
        if args.notify_email:
            lines += [f"#SBATCH --mail-user={args.notify_email}",
                      "#SBATCH --mail-type=END,FAIL"]
        lines.append("")
        if args.conda_env:
            lines.append(f"source activate {shlex.quote(args.conda_env)}")
        cmd = ["python", "-m", MODULE, *clean,
               "--single_run", "--logs_save_path", exp_root,
               "--tt_name", f"trial_{i}",
               "--walltime_minutes", str(wall_min)]
        for k, v in overrides.items():
            cmd += [f"--{k}", str(v)]
        lines += [
            f"cd {shlex.quote(os.getcwd())}",
            f"mkdir -p {shlex.quote(trial_root)}",
            f"CKPT={shlex.quote(os.path.join(trial_root, task_name, 'last.ckpt'))}",
            'RESUME=""',
            '[ -f "$CKPT" ] && RESUME="--resume_from_checkpoint $CKPT"',
            " ".join(shlex.quote(t) for t in cmd) + " $RESUME",
            "rc=$?",
            "if [ $rc -eq 3 ]; then",
            '  echo "walltime checkpoint reached; resubmitting"',
            '  sbatch "$0"',
            "fi",
            "exit $rc",
            "",
        ]
        path = os.path.join(out_dir, f"trial_{i}.sh")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        os.chmod(path, 0o755)
        scripts.append(path)
    submit_all = os.path.join(out_dir, "submit_all.sh")
    with open(submit_all, "w") as f:
        f.write("#!/bin/bash\n# submit the full grid (one Slurm job per trial)\n"
                + "".join(f"sbatch {shlex.quote(s)}\n" for s in scripts))
    os.chmod(submit_all, 0o755)
    print(f"wrote {len(scripts)} sbatch scripts + {submit_all}")
    return scripts


def main(argv=None):
    from driving_dirty_tpu_torch.cli.common import add_trainer_args, fit_from_args
    from driving_dirty_tpu_torch.cli.hyperopt import HyperOptArgumentParser

    registry = _registry()
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", type=str, default="faster_rcnn_rm")
    ns, _ = pre.parse_known_args(argv)
    if ns.model not in registry:
        sys.exit(f"unknown --model {ns.model!r}; available: {sorted(registry)}")
    task_cls = registry[ns.model]

    # a HyperOptArgumentParser, so the models' opt_list / tune declarations
    # are collected as grid dimensions
    strat = argparse.ArgumentParser(add_help=False)
    strat.add_argument("--hopt_strategy", default="grid_search",
                       choices=("grid_search", "random_search"),
                       help="trial enumeration over the models' tunable dimensions "
                            "(test-tube's HyperOptArgumentParser strategy; the reference "
                            "uses grid_search)")
    sns, _ = strat.parse_known_args(argv)
    parser = HyperOptArgumentParser(parents=[pre, strat], strategy=sns.hopt_strategy)
    parser = add_trainer_args(parser)
    parser = task_cls.add_model_specific_args(parser)
    parser.add_argument("-n", "--tt_name", default="experiment")
    parser.add_argument("-d", "--tt_description", default="")
    parser.add_argument("--logs_save_path", default="logs")
    parser.add_argument("--single_run", action="store_true")
    parser.add_argument("--nb_hopt_trials", type=int, default=12)
    parser.add_argument("--emit_commands", action="store_true",
                        help="print one training command per trial instead of running")
    # the reference's cluster flags: --nodes is --num_nodes (DD_COORDINATOR_ADDRESS,
    # parallel/mesh.py); --conda_env goes into emitted commands and scripts only
    parser.add_argument("--nodes", type=int, default=1)
    parser.add_argument("--conda_env", type=str, default=None)
    parser.add_argument("--on_cluster", action="store_true",
                        help="run the grid as concurrent pinned subprocesses on this host "
                             "(see run_trials_concurrent)")
    parser.add_argument("--parallel_trials", type=int, default=0,
                        help="max concurrent trial subprocesses, clamped to the cards on the "
                             "host; implies the --on_cluster runner when > 0 (default with "
                             "--on_cluster: 4)")
    parser.add_argument("--emit_slurm", type=str, default=None, metavar="DIR",
                        help="write one sbatch script per trial (+ submit_all.sh) to DIR instead "
                             "of running; scripts carry walltime-checkpoint resubmit and optional "
                             "email notify")
    parser.add_argument("--slurm_time", type=str, default="24:00:00",
                        help="Slurm --time per trial (reference: 24h)")
    parser.add_argument("--slurm_cpus", type=int, default=10,
                        help="cpus-per-task (reference: 10)")
    parser.add_argument("--slurm_mem", type=str, default="30GB",
                        help="job memory (reference: 30GB)")
    parser.add_argument("--slurm_partition", type=str, default=None)
    parser.add_argument("--slurm_gres", type=str, default=None,
                        help="e.g. gpu:h100:1 (site-specific; omitted when unset)")
    parser.add_argument("--notify_email", type=str, default=None,
                        help="Slurm mail-user for END,FAIL notifications (test-tube's notify_on_end)")
    parser.add_argument("--on_done_cmd", type=str, default=None,
                        help="shell command run after each trial with DD_TRIAL_NAME, DD_TRIAL_RC and "
                             "DD_TRIAL_VAL_LOSS in its environment (in place of test-tube's "
                             "notify_on_end email)")
    args = parser.parse_args(argv)
    if args.on_cluster and not args.parallel_trials:
        args.parallel_trials = 4
    if args.num_nodes == 1 and args.nodes > 1:
        args.num_nodes = args.nodes
    args.default_root_dir = os.path.join(args.logs_save_path, args.tt_name)

    trials = [{}] if args.single_run else parser.grid(args.nb_hopt_trials)
    base_argv = list(argv) if argv is not None else sys.argv[1:]
    if args.emit_slurm:
        return emit_slurm(args, trials, base_argv)
    if args.parallel_trials and not args.single_run and not args.emit_commands:
        return run_trials_concurrent(args, trials, base_argv)
    results = []
    for i, overrides in enumerate(trials):
        if args.emit_commands:
            ov = " ".join(f"--{k} {v}" for k, v in overrides.items())
            prefix = f"conda run -n {args.conda_env} " if args.conda_env else ""
            print(f"{prefix}python -m {MODULE} --model {args.model} "
                  f"--single_run --tt_name {args.tt_name}_t{i} {ov}")
            continue
        trial_args = argparse.Namespace(**vars(args))
        for k, v in overrides.items():
            setattr(trial_args, k, v)
        if not args.single_run:
            # grid mode: one subdirectory a trial. --single_run uses the root
            # itself: fan-out parents and emitted sbatch scripts already pass
            # --tt_name trial_i, and another trial_0 here would double the
            # path (and break the scripts' resume CKPT path)
            trial_args.default_root_dir = os.path.join(args.default_root_dir, f"trial_{i}")
        print(f"=== trial {i}/{len(trials)}: {overrides} ===", flush=True)
        fit = fit_from_args(task_cls, trial_args)
        results.append(fit)
        _notify_done(args, f"trial_{i}", 0, fit.best_val_loss if np.isfinite(fit.best_val_loss) else None)
    return results


def exit_code(results) -> int:
    """The process's exit code: 1 when a concurrent trial failed; 3 when a
    trial stopped on its walltime budget (the contract the emitted Slurm
    scripts resubmit on, resuming from last.ckpt); else 0."""
    if not isinstance(results, list):
        return 0
    rcs = [r["rc"] for r in results if isinstance(r, dict)]
    if any(rc not in (0, 3) for rc in rcs):
        return 1
    if 3 in rcs or any("walltime" in (getattr(r, "stop_reason", None) or "") for r in results):
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(exit_code(main()))
