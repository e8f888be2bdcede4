"""The detect driver: offline detection through the port's serving
artifact, a closed loop of batches, numpy uint8 in and ``dets`` out.

Set-up makes the pool of images and the weights from the seed, builds the
artifact (``serving.artifact``; the int8 twin where the traffic asks for
it), captures its graph at the cell's batch and makes ``warm_calls``
calls. The window calls it on the pool's batches in turn; every image
whose detections reached the host counts, over the whole window.

The comparison takes, for each pool batch, one call of the window drawn
from the seed among its first rounds (the pool cycles, so each batch is
served many times; a window too short for the round drawn gives its last
call), and holds its rows against the reference's rows of the same
images.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops, harness, serving

CHECK_ROUNDS = 4


def run(ctx: harness.Ctx) -> harness.Outcome:
    cfg, tf = ctx.cfg, ctx.traffic
    dev = ctx.device
    b = tf["batch"]
    int8 = bool(tf.get("int8", False))
    inp = serving.pool(ctx)
    art = serving.artifact(ctx, inp, int8, [b])
    spans = serving.Spans(art, ctx.trace)
    host = inp["host"]
    nb = tf["pool_images"] // b
    rng = np.random.default_rng([ctx.seed % 2 ** 64, 13])
    rounds = rng.integers(CHECK_ROUNDS, size=nb)
    for k in range(tf["warm_calls"]):
        art(host[(k % nb) * b:(k % nb + 1) * b])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.start

    got = {}

    def call(i):
        k = i % nb
        out = spans(host[k * b:(k + 1) * b])
        if i // nb <= rounds[k]:  # the drawn round, or the last before it
            got[k] = out

    win = harness.until(ctx.seconds, call,
                        tf["trace_calls"] if ctx.trace else 0,
                        torch.cuda.synchronize)
    peak = torch.cuda.max_memory_allocated()
    record = {"window": win, "batch": b, "cfg": cfg, "traffic": tf}
    if ctx.trace:
        record["outside_share"] = spans.outside_share(
            0, win["untraced_steps"])
    del spans, art
    torch.cuda.empty_cache()

    ref = serving.reference(ctx, inp, int8)
    rows = sorted(got)
    want = torch.cat([ref["dets"][k * b:(k + 1) * b] for k in rows])
    checks = serving.judge_rows(ctx, serving.as_tensor(
        [got[k] for k in rows], dev).flatten(0, 1), want)

    paths = serving.int8_paths(tf["quant_skip"]) if int8 else {}
    fwd = flops.forward_flops(cfg["size"], cfg["num_classes"], b,
                              set(paths.values()))
    record["least_s_per_call"] = fwd["float"] / flops.BF16_FLOPS + \
        fwd["int8"] / flops.INT8_OPS
    if ctx.trace:
        traced = range(win["untraced_steps"], win["steps"])
        record["k1_bound_s"] = sum(serving.k1_bound_s(
            ref, range((i % nb) * b, (i % nb + 1) * b),
            cfg["detect"]["nms_top_k"]) for i in traced)
        if int8:
            shapes = [s for s in flops.conv_shapes(cfg["size"],
                                                   cfg["num_classes"], b)
                      if s["path"] in set(paths.values())]
            record["int8_conv_bound_s"] = len(traced) * sum(
                flops.int8_conv_bound_s(s) for s in shapes)
            record["int8_quantize_bound_s"] = len(traced) * sum(
                flops.int8_quantize_bound_s(s) for s in shapes)
    complete = len(got) == nb
    return harness.Outcome(
        attempted=win["steps"] * b, failed=0,
        e2e={"setup_s": setup_s,
             "detect_images_per_s": win["steps"] * b / win["seconds"]},
        record=record, checks=checks, memory_peak_bytes=peak,
        correct=complete)
