"""Serving-host benchmark: requests/s and latency through the batching
engine and the HTTP server, on a serving artifact on the card.

    python -m refinedet_tpu_torch.tools.bench_serve [--size 320]
        [--num_classes 21] [--clients 64] [--requests 256]
        [--max_batch 32] [--max_delay_ms 5] [--artifact path.rdtpu]
        [--fused_nms] [--uint8_wire] [--int8] [--skip_http]
        [--device cuda]

The port of ``tools/bench_serve.py``. Two legs, so the HTTP overhead is
attributable:

  engine  ``--clients`` threads submit images straight into
          ``BatchingEngine.submit`` and block on the futures;
  http    the same load through the HTTP wire format (POST /detect with
          raw wire-dtype bytes, f32 or uint8 with ``--uint8_wire``; .npz
          response).

The artifact is ``--artifact``, or else random weights of seed 0 (the
throughput does not depend on their values) exported on the device with
``save_serving``: ``--fused_nms`` bakes the decode and the per-class NMS
(K1) into it, ``--uint8_wire`` takes raw pixels (mean-subtracted inside),
``--int8`` quantizes the weights first (calibrated on 4 random images) to
serve the int8 twin on the int8 kernels. The float network is float32,
as the JAX tool's (under torch's defaults, where cuDNN's convolutions
use TF32); the int8 twin keeps its unquantized layers in bf16. Each of
the engine's buckets is warmed by ``ServingModel.warm_up``, one CUDA
graph per bucket on the card. The engine leg runs twice and the second
is kept (:171-178). Failed requests are counted, not raised. The last
line is one JSON object: per leg the requests served, errors, req/s,
p50/p99 ms, and the realized-batch histogram.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.quant import quantize_model
from refinedet_tpu_torch.serve import BatchingEngine, Server
from refinedet_tpu_torch.serve.export import load_serving, save_serving
from refinedet_tpu_torch.serve.server import client_detect
from refinedet_tpu_torch.tools.fixture_train import kernel_launches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=320, choices=(320, 512, 896))
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--artifact", default=None,
                   help="a serving artifact of tools/export_serving.py; "
                        "default: random weights exported to a temporary "
                        "file (throughput does not depend on values)")
    p.add_argument("--fused_nms", action="store_true",
                   help="with the default export: decode and per-class "
                        "NMS (K1) inside the artifact, dets[C-1, K, 5] "
                        "out instead of raw heads")
    p.add_argument("--uint8_wire", action="store_true",
                   help="with the default export: raw uint8 pixels on the "
                        "wire, mean-subtracted inside the artifact")
    p.add_argument("--int8", action="store_true",
                   help="with the default export: the PTQ int8 twin of "
                        "the random weights")
    p.add_argument("--skip_http", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def drive(submit_fn, images, n_clients, n_requests):
    """``n_clients`` threads take turns at ``n_requests`` submissions;
    returns (wall seconds, successful-request latencies, error list)."""
    lat = [None] * n_requests
    errors = []
    idx_lock = threading.Lock()
    next_idx = [0]

    def worker():
        while True:
            with idx_lock:
                i = next_idx[0]
                if i >= n_requests:
                    return
                next_idx[0] += 1
            t0 = time.monotonic()
            try:
                submit_fn(images[i % len(images)])
            except Exception as e:  # count, don't crash the measurement
                with idx_lock:
                    errors.append(f"req {i}: {e!r}")
                continue
            lat[i] = time.monotonic() - t0

    threads = [threading.Thread(target=worker) for _ in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return (time.monotonic() - t0,
            np.array([v for v in lat if v is not None]), errors)


def _leg_stats(lat, wall, errors):
    out = {
        "ok": int(lat.size),
        "errors": len(errors),
        "req_per_s": round(lat.size / wall, 1) if lat.size else 0.0,
    }
    if lat.size:
        out["p50_ms"] = round(float(np.median(lat)) * 1e3, 1)
        out["p99_ms"] = round(float(np.percentile(lat, 99)) * 1e3, 1)
    if errors:
        out["first_error"] = errors[0]
        print(f"  {len(errors)} failed requests; first: {errors[0]}",
              file=sys.stderr, flush=True)
    return out


def export_random(args, dev: torch.device, path: str) -> None:
    """Random weights of seed 0 as the artifact ``args`` ask for."""
    model = build_refinedet("test", args.size, args.num_classes,
                            device=dev)
    if args.int8:
        calib = [np.random.RandomState(1).uniform(
            -120, 130, (4, args.size, args.size, 3)).astype(np.float32)]
        model, _ = quantize_model(model, calib)
    save_serving(model, None, path, fused_nms={} if args.fused_nms else None,
                 uint8_input=args.uint8_wire)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    tmp = None
    artifact = args.artifact
    if artifact is None:
        tmp = tempfile.mkdtemp(prefix="bench_serve_")
        artifact = os.path.join(tmp, f"refinedet{args.size}.rdtpu")
        export_random(args, dev, artifact)
    try:
        serving = load_serving(artifact, device=str(dev))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    size = serving.meta["input_size"]
    wire_dtype = serving.input_dtype

    rng = np.random.RandomState(0)
    if wire_dtype == np.uint8:  # raw-pixel wire
        images = [rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
                  for _ in range(8)]
    else:
        images = [rng.uniform(-120, 130, (size, size, 3)).astype(np.float32)
                  for _ in range(8)]

    engine = BatchingEngine(serving, (size, size, 3),
                            max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            input_dtype=wire_dtype)
    t0 = time.monotonic()
    serving.warm_up(engine.buckets)
    print(f"warmed {len(engine.buckets)} buckets {list(engine.buckets)} in "
          f"{time.monotonic() - t0:.1f}s", file=sys.stderr, flush=True)

    results = {}
    before = kernel_launches()
    with engine:
        # time twice, keep the second
        for tag in ("engine-warm", "engine"):
            wall, lat, errs = drive(lambda im: engine.submit(im).result(),
                                    images, args.clients, args.requests)
            results[tag] = _leg_stats(lat, wall, errs)
            print(f"  leg {tag}: {results[tag]}", file=sys.stderr,
                  flush=True)
        stats_engine = engine.stats()

        if not args.skip_http:
            cd = "u1" if wire_dtype == np.uint8 else "<f4"
            with Server(engine, serving.meta, port=0) as srv:
                wall, lat, errs = drive(
                    lambda im: client_detect("127.0.0.1", srv.port, im,
                                             timeout=600, dtype=cd),
                    images, args.clients, args.requests)
                results["http"] = _leg_stats(lat, wall, errs)
                print(f"  leg http: {results['http']}", file=sys.stderr,
                      flush=True)
    after = kernel_launches()
    out = {
        "size": size,
        "fused_nms": serving.meta.get("fused_nms") is not None,
        "int8": bool(serving.meta.get("int8", False)),
        "wire_dtype": wire_dtype.name,
        "dtype": serving.meta.get("dtype"),
        "device": str(serving.device),
        "clients": args.clients,
        "requests": args.requests,
        "max_batch": args.max_batch,
        "results": results,
        "batch_size_hist": stats_engine["batch_size_hist"],
        "launches": {k: after[k] - before[k] for k in after},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
