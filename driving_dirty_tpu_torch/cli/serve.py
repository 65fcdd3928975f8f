"""Serve an exported .ddx artifact: batch inference with no model code
(driving_dirty_tpu/cli/serve.py).

Two modes over the same `export.load` handle:

  one-shot:  python -m driving_dirty_tpu_torch.cli.serve --artifact model.ddx \
                 --npz scenes.npz --out masks.npz [--device cuda]
             (scenes.npz holds one array per artifact input — `images`
              [N, 6, 256, 306, 3] for roadmap artifacts, plus `road`
              [N, 800, 800] for the rm variants; the N scenes are chunked
              to the artifact's batch size, the tail padded)

  http:      python -m driving_dirty_tpu_torch.cli.serve --artifact model.ddx \
                 --http 8787
             POST /predict with an npz body ({'images': ...}) -> npz
             response {'masks': [N, 800, 800] uint8} (or the artifact's named
             outputs); GET /healthz -> meta.

The process never imports model-building code: the artifact's program is
loaded by torch.export and run as it is (export.py). --device (default:
the device type the artifact was traced for) must be of that type.
"""
from __future__ import annotations

import argparse
import io
import json
import time

import numpy as np
import torch


def _numpy_tree(out, k):
    if isinstance(out, dict):
        return {name: _numpy_tree(v, k) for name, v in out.items()}
    return out[:k].cpu().numpy()


def predict_all(served, *inputs):
    """Batch-of-N inference through a fixed-batch artifact: each input
    [N, ...] is chunked to the artifact's batch (tail zero-padded, pad rows
    dropped). Output: roadmap artifacts -> {'masks': [N, 800, 800] uint8};
    the others -> their named output arrays."""
    n = inputs[0].shape[0]
    if n == 0:
        raise ValueError("no scenes: first input has length 0")
    b = served.batch_size
    chunks = []
    for i in range(0, n, b):
        part = [x[i:i + b] for x in inputs]
        k = part[0].shape[0]
        if k < b:
            part = [np.concatenate([x, np.zeros((b - k, *x.shape[1:]), x.dtype)]) for x in part]
        # original dtypes: Served normalizes raw-uint8 images itself
        chunks.append(_numpy_tree(served(*part), k))
    if isinstance(chunks[0], dict):
        return {name: np.concatenate([c[name] for c in chunks]) for name in chunks[0]}
    return {"masks": np.concatenate(chunks).astype(np.uint8)}


def make_server(served, port):
    """Build (not run) the HTTP server, so that tests can bind port 0, drive
    requests and shut it down. Threaded so /healthz answers while a long
    /predict runs; device calls are serialized by a lock (one program at a
    time: queueing requests beats interleaving them)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    predict_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps(served.meta).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n))) as npz:
                    inputs = [npz[s["name"]] for s in served.input_specs]
                t0 = time.perf_counter()
                with predict_lock:
                    outputs = predict_all(served, *inputs)
                dt = time.perf_counter() - t0
                buf = io.BytesIO()
                np.savez_compressed(buf, **outputs)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/npz")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Scenes-Per-Sec", f"{inputs[0].shape[0] / dt:.2f}")
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:  # a malformed request must not kill the server
                self.send_error(400, str(e))

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def _http_serve(served, port):
    srv = make_server(served, port)
    print(f"serving {served.meta['task']} on http://127.0.0.1:{srv.server_address[1]} "
          f"(batch {served.batch_size}, {served.device}); POST /predict, GET /healthz", flush=True)
    srv.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True, help=".ddx file (cli.export)")
    ap.add_argument("--npz", default=None, help="one-shot input npz ('images')")
    ap.add_argument("--out", default=None, help="one-shot output npz path")
    ap.add_argument("--http", type=int, default=None, help="serve on this port")
    ap.add_argument("--swap_params", default=None,
                    help="framework .ckpt whose weights replace the artifact's "
                         "(same architecture; no re-export)")
    ap.add_argument("--device", type=str, default=None,
                    help="where to serve (default: the device type the artifact was traced for)")
    args = ap.parse_args(argv)

    from driving_dirty_tpu_torch import export as ddx

    served = ddx.load(args.artifact, device=args.device)
    if args.swap_params:
        from driving_dirty_tpu_torch.checkpoints import io as ckpt_io

        blob = ckpt_io.load(args.swap_params, opt_state=False)
        # the state rides along so that a fine-tune whose BN statistics
        # drifted past the baked ones is refused (export.Served.swap_params)
        served.swap_params(blob["params"], state=blob.get("state"))

    if args.http is not None:
        _http_serve(served, args.http)
        return None
    if not args.npz or not args.out:
        ap.error("need --npz and --out (or --http PORT)")
    with np.load(args.npz) as npz:
        inputs = [npz[s["name"]] for s in served.input_specs]
    t0 = time.perf_counter()
    outputs = predict_all(served, *inputs)
    if served.device.type == "cuda":
        torch.cuda.synchronize(served.device)
    dt = time.perf_counter() - t0
    np.savez_compressed(args.out, **outputs)
    print(f"{inputs[0].shape[0]} scenes -> {args.out} "
          f"[{', '.join(outputs)}]  ({inputs[0].shape[0] / dt:.2f} scenes/s)")
    return outputs


if __name__ == "__main__":
    main()
