"""Serve .ddx artifacts in a fresh process and measure them against the
models' own `predict` (the serving check of chip_smoke.py phase 11).

    python3 -m driving_dirty_tpu_torch.scripts.serve_artifacts spec.json

spec.json: {"artifacts": [{"kind": roadmap|detection|multitask|spatial,
"precision", "task", "path", "ckpt"}, ...], "calib": npz of the int8
calibration batch ("images"), "swap": a second roadmap checkpoint, "out":
where the results go, "batch", "requests" (a timed window), "pool" (the
distinct requests), "seed"}.

It loads every artifact first and records which model modules are
imported by then (none should be). For each artifact it restores the
model from its checkpoint (calibrated on the same batch at precision 8)
and serves `pool` seeded requests of `batch` uint8 scenes (with seeded
road maps for the rm variants) both ways: the artifact takes the host
arrays, `predict` the same f32 inputs on the device (uint8 / 255, as
Served divides them); the outputs come back to the host. After a warm-up
of each, timed windows of `requests` requests, cycling through the pool,
alternate between the two (WINDOWS), so that a drift of the card or the
host falls on both. For each path: the scenes/s of each window, their
median and range, and the median, 10th and 90th percentile of the ms of
its requests; for the artifact, the launches of B1, B1-int8 and B3 a
request, read from their counters. The first window's answers to the pool
are compared: `exact` (every output tensor equal), masks by the share of
equal pixels, box occupancy by the largest difference, detections by the
share of the model's valid detections that the artifact also returns
(same label, IoU >= 0.99). Then the pool once more on each path under
torch.profiler (wall and device-busy ms, idle share, device operations a
request, the rows that take the most device time). Then an HTTP round
trip on 127.0.0.1 (port 0: GET /healthz, POST /predict) against the
roadmap precision-32 artifact, and swap_params from the second checkpoint
(its masks against that checkpoint's predict and against the masks before
the swap) and from a drifted state (refused). It judges nothing: the
caller holds the numbers to its bars. Needs a CUDA card.
"""
from __future__ import annotations

import io
import json
import statistics
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from driving_dirty_tpu_torch import export as ddx
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.cli import serve as cli_serve
from driving_dirty_tpu_torch.data.boxes import detection_scenes
from driving_dirty_tpu_torch.data.pipeline import tree_map
from driving_dirty_tpu_torch.scripts.probe_trunk_variants import device_line

ROAD = 800  # the rm variants' road-map side
# the timed windows in turn: served and predict alternate, each first as often
WINDOWS = ("served", "predict", "predict", "served", "served", "predict")


def launch_counts() -> tuple[int, int, int]:
    """(B1, B1-int8, B3) launches so far in this process."""
    from driving_dirty_tpu_torch.kernels import roialign, trunk, trunk_int8

    return trunk.trunk.launches, trunk_int8.trunk_int8.launches, roialign.roialign.launches


def to_host(y):
    return {k: v.cpu() for k, v in y.items()} if isinstance(y, dict) else y.cpu()


def window(fn, requests, keep: int = 0) -> tuple[list, list]:
    """fn over each request (a tuple of host arrays), one after another ->
    (the host outputs of the first `keep`, the ms of each request). A
    request ends with its outputs on the host, which waits for the card."""
    outs, ms = [], []
    torch.cuda.synchronize()
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        y = to_host(fn(*req))
        ms.append(1e3 * (time.perf_counter() - t0))
        if i < keep:
            outs.append(y)
    return outs, ms


def window_stats(windows: list, batch: int) -> dict:
    """Scenes/s of each window (a list of request ms), their median and
    range; the median, 10th and 90th percentile of the request ms."""
    rates = [1e3 * batch * len(ms) / sum(ms) for ms in windows]
    every = np.asarray([m for ms in windows for m in ms])
    return {"window_scenes_per_s": rates, "scenes_per_s": statistics.median(rates),
            "scenes_per_s_range": [min(rates), max(rates)], "ms_median": float(np.median(every)),
            "ms_p10": float(np.percentile(every, 10)), "ms_p90": float(np.percentile(every, 90)),
            "requests": int(every.size)}


def profiled(fn, requests) -> dict:
    """fn over the requests under torch.profiler: wall and device-busy ms a
    request (kernels and copies), the idle share, device operations a
    request, and the five that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms = window(fn, requests)
    n = len(requests)
    ops = sorted(((e.key, e.count, getattr(e, "self_device_time_total", 0)) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
                 key=lambda t: -t[2])
    wall, busy = sum(ms) / n, sum(us for _, _, us in ops) / 1e3 / n
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "device_ops": sum(c for _, c, _ in ops) / n,
            "top": [[k[:50], c // n, round(us / 1e3 / n, 3)] for k, c, us in ops[:5]]}


def found_share(got, ref) -> float:
    """Share of ref's valid detections that got also returns (same label,
    IoU >= 0.99, any slot), over a batch of host detection dicts."""
    found = total = 0
    for j in range(ref["valid"].shape[0]):
        gv = got["valid"][j]
        gb, gl = got["boxes"][j][gv].float(), got["labels"][j][gv]
        for box, label in zip(ref["boxes"][j][ref["valid"][j]].float(), ref["labels"][j][ref["valid"][j]]):
            lt, rb = torch.maximum(gb[:, :2], box[:2]), torch.minimum(gb[:, 2:], box[2:])
            inter = (rb - lt).clamp(min=0).prod(-1)
            union = (box[2:] - box[:2]).prod() + (gb[:, 2:] - gb[:, :2]).prod(-1) - inter
            found += bool(((inter / union.clamp(min=1e-9) >= 0.99) & (gl == label)).any())
            total += 1
    return found / max(total, 1)


def batched(outs: list):
    """A list of host outputs (tensors or dicts of them) -> one, along the
    batch."""
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return torch.cat(outs)


def compare(kind: str, got, ref) -> dict:
    exact = all(torch.equal(got[k], ref[k]) for k in ref) if isinstance(ref, dict) else torch.equal(got, ref)
    if kind == "roadmap":
        return {"exact": exact, "mask_agreement": (got == ref).float().mean().item()}
    if kind == "multitask":
        return {"exact": exact, "mask_agreement": (got["road_mask"] == ref["road_mask"]).float().mean().item(),
                "occupancy_err": (got["box_occupancy"] - ref["box_occupancy"]).abs().max().item(),
                "occupancy_max": ref["box_occupancy"].abs().max().item()}
    if kind == "spatial":
        return {"exact": exact, "occupancy_err": (got - ref).abs().max().item(),
                "occupancy_max": ref.abs().max().item()}
    return {"exact": exact, "found_share": found_share(got, ref), "valid": int(ref["valid"].sum())}


def on_device(arrays) -> list:
    """Host request arrays -> the f32 device tensors Served makes of them."""
    return [torch.div(torch.from_numpy(a).cuda().float(), torch.tensor(255.0, device="cuda"))
            if a.dtype == np.uint8 else torch.from_numpy(a).cuda() for a in arrays]


def restore(a: dict):
    """The artifact's model from its checkpoint, at its precision."""
    if a["kind"] == "roadmap":
        from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model

        return load_roadmap_model(a["ckpt"], a["precision"], device="cuda")
    if a["kind"] == "detection":
        from driving_dirty_tpu_torch.cli.eval_boxes import load_detection_task

        return load_detection_task(a["ckpt"], a["precision"], device="cuda")
    return ddx.load_task_ckpt(a["ckpt"], a["precision"], device="cuda")


def http_round_trip(served, images) -> dict:
    srv = cli_serve.make_server(served, 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        buf = io.BytesIO()
        np.savez(buf, images=images)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r, np.load(io.BytesIO(r.read())) as z:
            masks = z["masks"]
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        srv.shutdown()
        srv.server_close()
    same = bool(np.array_equal(masks, served(images).cpu().numpy().astype(np.uint8)))
    return {"port": port, "ms": ms, "healthz_task": health["task"], "masks_equal_served": same}


def swap_check(served, ckpt, images) -> dict:
    before = served(images)
    blob = ckpt_io.load(ckpt, opt_state=False)
    served.swap_params(blob["params"], state=blob["state"])
    swapped = served(images)
    ref = restore({"kind": "roadmap", "ckpt": ckpt, "precision": 32}).predict(*on_device([images]))
    try:
        served.swap_params(blob["params"], state=tree_map(lambda v: np.asarray(v) + 1.0, blob["state"]))
        refused = False
    except ValueError:
        refused = True
    return {"exact": torch.equal(swapped, ref), "mask_agreement": (swapped == ref).float().mean().item(),
            "changed_share": (swapped != before).float().mean().item(), "drifted_state_refused": refused}


def run(spec: dict) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("serve_artifacts needs a CUDA card")
    smi = device_line()
    batch, n, pool = spec["batch"], spec["requests"], spec["pool"]
    loaded, out = {}, {"card": smi, "artifacts": {}}
    for a in spec["artifacts"]:
        t0 = time.perf_counter()
        loaded[a["name"]] = ddx.load(a["path"])
        out["artifacts"][a["name"]] = {"load_s": time.perf_counter() - t0}
    out["model_modules_after_load"] = sorted(m for m in sys.modules
                                             if m.startswith("driving_dirty_tpu_torch.models"))
    print(f"serve_artifacts ({smi}): {len(loaded)} artifacts loaded; model modules imported by then: "
          f"{out['model_modules_after_load']}", flush=True)
    rng = np.random.RandomState(spec["seed"])
    images = [rng.randint(0, 256, size=(batch, 6, 256, 306, 3), dtype=np.uint8) for _ in range(pool)]
    roads = [detection_scenes(spec["seed"] + i, batch, 100, ROAD)["road"] for i in range(pool)]
    with np.load(spec["calib"]) as z:
        calib = torch.from_numpy(z["images"]).cuda()
    for a in spec["artifacts"]:
        served, rec = loaded[a["name"]], out["artifacts"][a["name"]]
        rm = len(served.input_specs) == 2
        distinct = [(x, r) if rm else (x,) for x, r in zip(images, roads)]
        requests = [distinct[i % pool] for i in range(n)]
        model = restore(a)
        if a["precision"] == 8:
            model.calibrate_int8(calib)

        def direct(*req, model=model):
            return model.predict(*on_device(req))

        paths = {"served": served, "predict": direct}
        ms = {path: [] for path in paths}
        answers, launches = {}, [0, 0, 0]
        for fn in paths.values():
            window(fn, requests[:1])
        for path in WINDOWS:
            before = launch_counts()
            outs, times = window(paths[path], requests, keep=0 if path in answers else pool)
            if path == "served":
                launches = [s + c - b for s, c, b in zip(launches, launch_counts(), before)]
            answers.setdefault(path, outs)
            ms[path].append(times)
        rec["launches_per_request"] = [c / len(ms["served"]) / n for c in launches]
        for path in paths:
            rec[path] = window_stats(ms[path], batch)
        agreement = compare(a["kind"], batched(answers["served"]), batched(answers["predict"]))
        rec.update(agreement)
        rec["profile"] = {path: profiled(fn, distinct) for path, fn in paths.items()}
        served_rec, direct_rec = rec["served"], rec["predict"]
        print(f"{a['name']} ({smi}): {len(WINDOWS) // 2} alternating windows of {n} requests a path; scenes/s "
              f"median (range) served {served_rec['scenes_per_s']:.1f} "
              f"({served_rec['scenes_per_s_range'][0]:.1f}-{served_rec['scenes_per_s_range'][1]:.1f}), "
              f"predict {direct_rec['scenes_per_s']:.1f} "
              f"({direct_rec['scenes_per_s_range'][0]:.1f}-{direct_rec['scenes_per_s_range'][1]:.1f}); "
              f"ms a request median [p10, p90] served {served_rec['ms_median']:.2f} "
              f"[{served_rec['ms_p10']:.2f}, {served_rec['ms_p90']:.2f}], predict {direct_rec['ms_median']:.2f} "
              f"[{direct_rec['ms_p10']:.2f}, {direct_rec['ms_p90']:.2f}]; (B1, B1-int8, B3) a request "
              f"{rec['launches_per_request']}; loaded in {rec['load_s']:.2f} s; against predict on the "
              f"{pool} distinct requests {agreement}",
              flush=True)
        for path, p in rec["profile"].items():
            print(f"  {path} under torch.profiler ({pool} requests): {p['wall_ms']:.2f} ms wall, "
                  f"{p['busy_ms']:.2f} ms device-busy (idle {p['idle_share']:.3f}), {p['device_ops']:.0f} "
                  f"device ops a request; top {p['top']}", flush=True)
        del model, direct, paths, answers
        torch.cuda.empty_cache()
    roadmap = next(a["name"] for a in spec["artifacts"] if a["kind"] == "roadmap" and a["precision"] == 32)
    out["http"] = http_round_trip(loaded[roadmap], images[0])
    print(f"HTTP ({smi}): {out['http']}", flush=True)
    out["swap"] = swap_check(loaded[roadmap], spec["swap"], images[0])
    print(f"swap_params ({smi}): {out['swap']}", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    spec = json.loads(Path(argv[0]).read_text())
    Path(spec["out"]).write_text(json.dumps(run(spec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
