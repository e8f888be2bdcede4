#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (refinedet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit and no result line:

  1. device: the card, torch/CUDA versions, the K1 build (nvcc, ptxas -v);
  2. K1 against its plain version on the card, exact keep masks, on
     candidates from the model's real post-softmax scores and on synthetic
     boxes, both area conventions, edge cases, ragged K (1, 63, 64, 65,
     129, 1000, 1024 for one group) and K = the kernel's limit;
  3. the serving slice: RefineDet320 (VOC, 21 classes, 6375 priors) with
     seeded weights, fused-NMS serving through BatchingEngine from several
     client threads and over HTTP; K1's launch count must rise;
  4. kernel path against plain path on the same heads (exact), and the
     card's f32 heads against the CPU's on a small input;
  5. timings on the card: K1's device time per launch at the serving and
     detect shapes (a CUDA graph of 50 launches, replayed between CUDA
     events, so the wrapper's host cost is left out and printed on its own
     line), its plain version's (CUDA events), and per batch of 32 in f32
     and bf16 the forward, the fused post-process (CUDA events) and
     end-to-end serving (host clock, numpy in to numpy out).

The line before the last is the card's name and power limit from
nvidia-smi; the last is {"ok": true, "device": {...}}. TF32 is off for
convolutions and matmuls, so f32 means f32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

NUM_CLASSES = 21          # VOC table
SIZE = 320
SERVE_BATCH = 32          # G = 20 * 32 groups at the serving shape
NMS_TOP_K = 200           # fused serving default
DETECT_TOP_K = 1000       # DetectConfig.top_k
MAX_BATCH = 8             # BatchingEngine in phase 3
ENGINE_REQUESTS = 16      # from 4 client threads
HTTP_REQUESTS = 2
# Operations of one IoU test as the kernel computes it: 2 min, 2 max,
# 2 sub, 2 add, 2 clamp, mul, add, sub, div, compare.
IOU_OPS = 15
RAGGED_K = (1, 63, 64, 65, 129, 1000, 1024)  # one group each
LIMIT_GROUPS = 3                              # at K = the kernel's limit
H100_BYTES_PER_S = 3.35e12   # HBM3, data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, data sheet


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean host time of ``fn()``, which must end synchronized."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs "
              "one card", file=sys.stderr)
        return 1

    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.ops import nms_cuda
    from refinedet_tpu_torch.ops.nms import nms_sweep_reference
    from refinedet_tpu_torch.serve import (BatchingEngine, Server,
                                           client_detect, make_serving_fn)
    from refinedet_tpu_torch.serve.export import (fused_nms_settings,
                                                  fused_postprocess)
    from refinedet_tpu_torch.tools.k1_bench import (graph_ms, noise_images,
                                                    serving_candidates,
                                                    uniform_candidates)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{count}")
    log("device", f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    kernel = nms_cuda.load_kernel()
    log("device", f"K1 built in {kernel.build_seconds:.2f} s -> "
        f"{kernel.path.name} (max K {kernel.max_k})")
    for line in kernel.build_log.splitlines():
        log("device", f"  {line}")

    # -- 2. K1 against its plain version ------------------------------------
    model = build_refinedet("test", SIZE, NUM_CLASSES, device=dev, seed=0)
    check(model.priors.shape == (6375, 4), f"priors {model.priors.shape}")
    opts = fused_nms_settings(NUM_CLASSES, {})
    mismatches, compared, max_err = 0, 0, 0.0

    def compare(boxes, valid, plus_one, label):
        nonlocal mismatches, compared, max_err
        got = nms_cuda.nms_sweep(boxes, valid, opts.nms_thresh, plus_one)
        want = nms_sweep_reference(boxes, valid, opts.nms_thresh, plus_one)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mismatches += bad
        compared += 1
        max_err = max(max_err, float(bad > 0))  # |keep - keep'| of 0/1
        log("k1", f"{label} G={boxes.shape[0]} K={boxes.shape[1]} "
            f"plus_one={plus_one}: kept {int(got.sum())}, "
            f"mismatches {bad}")

    with torch.inference_mode():
        for name, imgs in (("noise", noise_images(rng, SERVE_BATCH)),
                           ("randn", rng.randn(SERVE_BATCH, SIZE, SIZE, 3)
                            .astype(np.float32))):
            cands = serving_candidates(model, imgs,
                                       (NMS_TOP_K, 256, DETECT_TOP_K),
                                       opts.conf_thresh)
            for top_k, (cand, valid) in cands.items():
                for plus_one in (False, True):
                    # +1 areas are pixel-space: scale to the image first.
                    b = cand * SIZE if plus_one else cand
                    compare(b, valid, plus_one, f"model/{name}")
                if name == "noise" and top_k == NMS_TOP_K:
                    serve_cand, serve_valid = cand, valid  # timed in 5.
                elif name == "noise" and top_k == DETECT_TOP_K:
                    detect_cand, detect_valid = cand, valid
        shapes = [("uniform", 20 * SERVE_BATCH, 256),
                  ("uniform", 20 * 8, 1024)]
        shapes += [("ragged", 1, k) for k in RAGGED_K]
        shapes += [("limit", LIMIT_GROUPS, kernel.max_k)]
        for label, g, k in shapes:
            for plus_one in (False, True):
                b, valid = uniform_candidates(g, k, 0.8, seed=g + k,
                                              scale=SIZE if plus_one else 1.0)
                compare(b, valid, plus_one, label)
        same = torch.tensor([10.0, 10.0, 50.0, 60.0], device=dev).expand(
            4, 256, 4).contiguous()
        zero = torch.tensor([5.0, 5.0, 5.0, 5.0], device=dev).expand(
            4, 256, 4).contiguous()
        # widths of -0 and +0: the plain version's + 0.0 makes them +0
        signed = torch.tensor([[-0.0, -0.0, 0.0, 0.0], [0.0, 0.0, -0.0, 1.0],
                               [-0.0, 0.0, 1.0, -0.0], [0.0, -0.0, 0.0, 2.0]],
                              device=dev).repeat(4, 64, 1)
        idx = torch.arange(256, device=dev)
        masks = {"all": torch.ones(4, 256, dtype=torch.bool, device=dev),
                 "none": torch.zeros(4, 256, dtype=torch.bool, device=dev),
                 "sparse": (idx % 7 == 3).expand(4, 256).contiguous()}
        for bname, b in (("identical", same), ("zero-area", zero),
                         ("signed-zero", signed)):
            for mname, m in masks.items():
                for plus_one in (False, True):
                    compare(b, m, plus_one, f"edge/{bname}/{mname}")
        one = nms_cuda.nms_sweep(same, masks["all"], 0.45)
        check(int(one.sum()) == 4 and bool(one[:, 0].all()),
              "identical boxes must keep exactly the first of each group")
    check(mismatches == 0, f"K1 disagrees with its plain version in "
          f"{mismatches} entries")
    log("k1", f"{compared} comparisons, all keep masks equal")

    # -- 3. the serving slice -------------------------------------------------
    fn = make_serving_fn(model, None, fused_nms={})
    for b in (1, 2, 4, 8):  # warm every bucket: cuDNN picks per shape
        fn(np.zeros((b, SIZE, SIZE, 3), np.float32))
    engine = BatchingEngine(fn, (SIZE, SIZE, 3), max_batch=MAX_BATCH,
                            max_delay_ms=20.0)
    server = Server(engine, {"format": "refinedet-tpu-torch-serving",
                             "input_size": SIZE,
                             "num_classes": NUM_CLASSES})
    requests = noise_images(rng, ENGINE_REQUESTS + HTTP_REQUESTS)
    results, errors = {}, []

    def client(tid):
        try:
            futs = [(i, engine.submit(requests[i]))
                    for i in range(tid, ENGINE_REQUESTS, 4)]
            for i, f in futs:
                results[i] = f.result(timeout=300)[0]
        except Exception as e:  # noqa: BLE001 - reported and checked below
            errors.append(repr(e))

    nms_cuda.nms_sweep.launches = 0
    server.start()
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for i in range(ENGINE_REQUESTS, ENGINE_REQUESTS + HTTP_REQUESTS):
            (results[i],) = client_detect("127.0.0.1", server.port,
                                          requests[i], timeout=300)
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "a client thread did not finish")
        stats = engine.stats()
    finally:
        server.stop()
    launches = nms_cuda.nms_sweep.launches
    log("serve", f"stats {json.dumps(stats)}")
    check(not errors, f"client errors: {errors}")
    check(stats["errors"] == 0, f"engine errors: {stats['errors']}")
    n_req = ENGINE_REQUESTS + HTTP_REQUESTS
    check(len(results) == n_req and stats["requests"] == n_req,
          f"{len(results)} results, {stats['requests']} served of {n_req}")
    for i, dets in results.items():
        check(dets.shape == (NUM_CLASSES - 1, NMS_TOP_K, 5),
              f"request {i}: dets shape {dets.shape}")
        check(bool(np.isfinite(dets).all()), f"request {i}: non-finite")
    kept = int(sum((d[..., 4] > 0).sum() for d in results.values()))
    check(launches >= stats["batches"] > 0,
          f"K1 launched {launches} times for {stats['batches']} batches")
    log("serve", f"{n_req} requests ({HTTP_REQUESTS} over HTTP) in "
        f"{stats['batches']} device batches, 0 errors, {kept} detections; "
        f"K1 launches {launches}")

    # -- 4. kernel path against plain path, same heads -----------------------
    imgs = noise_images(rng, SERVE_BATCH)
    x = torch.from_numpy(imgs).to(dev)
    with torch.inference_mode():
        heads = model.raw_forward(x)
        dets_k = fused_postprocess(heads, model.priors, opts)
        dets_p = fused_postprocess(heads, model.priors, opts, plain=True)
        check(torch.equal(dets_k, dets_p),
              "kernel-path and plain-path detections differ")
        log("e2e", f"kernel and plain post-process equal on the same heads "
            f"({int((dets_k[..., 4] > 0).sum())} detections, batch "
            f"{SERVE_BATCH})")
        cpu_model = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu",
                                    seed=0)
        small = torch.from_numpy(rng.randn(1, SIZE, SIZE, 3).astype(
            np.float32))
        h_cpu = cpu_model.raw_forward(small)
        h_gpu = model.raw_forward(small.to(dev))
        worst = 0.0
        for a, b in zip(h_cpu, h_gpu):
            err = float((b.cpu() - a).abs().max())
            scale = float(a.abs().max())
            worst = max(worst, err / scale)
            # cuDNN and oneDNN sum in different orders.
            check(err <= 1e-4 * scale, f"card vs CPU heads: max abs err "
                  f"{err} for max |head| {scale}")
        log("e2e", f"f32 heads on the card match the CPU's: max abs err "
            f"{worst:.3g} of max |head| (limit 1e-4)")
    check(all(bool(torch.isfinite(h).all()) for h in heads),
          "non-finite heads")

    # -- 5. timings ----------------------------------------------------------
    def time_sweep(cand, valid, label):
        """K1's device ms per launch and the plain version's ms on these
        candidates, and K1's bound."""
        g, k = valid.shape
        with torch.inference_mode():
            ms = graph_ms(lambda: nms_cuda.nms_sweep(
                cand, valid, opts.nms_thresh))
            plain = cuda_ms(lambda: nms_sweep_reference(
                cand, valid, opts.nms_thresh), 3, warmup=1)
            keep = nms_cuda.nms_sweep(cand, valid, opts.nms_thresh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                nms_cuda.nms_sweep(cand, valid, opts.nms_thresh)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        kept_g = keep.sum(1).double()
        valid_g = valid.sum(1).double()
        kept = int(kept_g.sum())
        nbytes = g * k * (16 + 1 + 1)  # boxes + valid in, keep out
        # The least greedy NMS can test: each kept column against every
        # earlier kept row, each suppressed column at least once.
        tests = int((kept_g * (kept_g - 1) / 2 + (valid_g - kept_g)).sum())
        ops = IOU_OPS * tests
        all_ops = IOU_OPS * kept * k  # every column against every kept row
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = ops / H100_F32_OPS_PER_S * 1e3
        all_bound = max(bytes_ms, all_ops / H100_F32_OPS_PER_S * 1e3)
        log("time", f"K1 {label} G={g} K={k}: {ms:.4f} ms a launch (device, "
            f"graph of 50); plain {plain:.3f} ms; kept {kept}; bound "
            f"{max(bytes_ms, ops_ms):.6f} ms ({nbytes} B, {tests} IoU "
            f"tests, {ops} ops); counting every column against every kept "
            f"row: {all_bound:.6f} ms ({all_ops} ops)")
        log("time", f"K1 {label} wrapper: {host_us:.1f} us host time a call "
            f"(checks, allocation, ctypes launch)")
        return ms, plain, max(bytes_ms, ops_ms), \
            "bytes" if bytes_ms >= ops_ms else "operations"

    k1_ms, plain_ms, bound_ms, bound_by = time_sweep(
        serve_cand, serve_valid, "serving")
    k1_detect, plain_detect, bound_detect, _ = time_sweep(
        detect_cand, detect_valid, "detect")

    timings = {"k1_serve_ms": k1_ms, "plain_serve_ms": plain_ms,
               "bound_serve_ms": bound_ms, "k1_detect_ms": k1_detect,
               "plain_detect_ms": plain_detect,
               "bound_detect_ms": bound_detect}
    for dtype in (torch.float32, torch.bfloat16):
        m = model if dtype == torch.float32 else build_refinedet(
            "test", SIZE, NUM_CLASSES, device=dev, dtype=dtype, seed=0)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: m.raw_forward(x), 10)
            h = m.raw_forward(x)
            post = cuda_ms(lambda: fused_postprocess(h, m.priors, opts), 10)
        serve_fn = make_serving_fn(m, None, fused_nms={})
        before = nms_cuda.nms_sweep.launches
        e2e = host_ms(lambda: serve_fn(imgs), 10)
        per_call = (nms_cuda.nms_sweep.launches - before) / 12
        name = "f32" if dtype == torch.float32 else "bf16"
        timings[f"forward_{name}_ms"] = fwd
        timings[f"postprocess_{name}_ms"] = post
        timings[f"serve_{name}_ms"] = e2e
        log("time", f"{name}: forward {fwd:.2f} ms, fused post-process "
            f"{post:.2f} ms, end-to-end serving {e2e:.2f} ms per batch of "
            f"{SERVE_BATCH}; K1 launches per batch {per_call:g}")
        check(per_call == 1, f"expected one K1 launch per batch, got "
              f"{per_call}")
    log("time", "library_ms: n/a, no single PyTorch call computes greedy "
        "NMS (torchvision is absent, and its NMS would be a library "
        "kernel)")
    log("time", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"timings": timings}), flush=True)

    print(json.dumps({"kernels": [{
        "name": "nms_sweep",
        "route": "cuda",
        "source": "refinedet_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "refinedet_tpu/ops/nms_pallas.py:40",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
