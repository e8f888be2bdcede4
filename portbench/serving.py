"""What the detect driver and the control readings share: the seeded image
pool, the program's serving artifact built, written, loaded and warmed up
as a user deploys it, the spans the benchmark records around it, and the
reference's detections of the pool.

The artifact is the port's: ``save_serving`` of a test-phase model in the
configuration's dtype (or its int8 twin, calibrated by the port's PTQ on
the pool's first images), uint8 wire with the configuration's mean, fused
NMS with its settings; ``load_serving`` on the card, ``warm_up`` at the
batch sizes the cell uses (one CUDA graph each). It is written under
``TMPDIR`` and deleted once loaded.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import flops, harness, judge, weights
from portbench.reference import detect as ref_detect
from portbench.reference import quant as ref_quant
from portbench.reference.boxes import priors
from portbench.reference.net import quantizable


def pool(ctx: harness.Ctx) -> dict:
    """The seeded image pool (uint8 on the card and on the host) and the
    weights."""
    cfg, tf = ctx.cfg, ctx.traffic
    dev = ctx.device
    gen = harness.generator(tf["generator"])
    images = gen.make(tf["scene"], weights.generator(ctx.seed, 2, dev),
                      tf["pool_images"], cfg["size"], cfg["num_classes"],
                      tf["max_objects"])[0]
    mean_rgb = torch.tensor(cfg["mean_bgr"][::-1], device=dev)
    state = weights.make_state(cfg, ctx.seed, images[:2].float() - mean_rgb,
                               dev)
    return {"images": images, "host": images.cpu().numpy(),
            "mean_rgb": mean_rgb, "state": state}


def calib_batches(ctx: harness.Ctx, inp: dict) -> List[torch.Tensor]:
    """The calibration batches of the int8 twin: the pool's first
    ``calib_images``, preprocessed as served, in ``calib_batch`` rows."""
    n, b = ctx.traffic["calib_images"], ctx.traffic["calib_batch"]
    x = inp["images"][:n].float() - inp["mean_rgb"]
    return [x[i:i + b] for i in range(0, n, b)]


def fused_settings(cfg: dict) -> dict:
    d = cfg["detect"]
    return {"nms_thresh": d["nms_thresh"], "conf_thresh": d["conf_thresh"],
            "objectness_thresh": d["objectness_thresh"],
            "nms_top_k": d["nms_top_k"]}


def artifact(ctx: harness.Ctx, inp: dict, int8: bool, batches: Sequence[int]):
    """The program's loaded, warmed-up serving artifact. Prints the
    seconds of each phase of its set-up on standard error."""
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.quant import quantize_model
    from refinedet_tpu_torch.serve import load_serving, save_serving

    cfg = ctx.cfg
    dtype = getattr(torch, cfg["dtype"])
    marks = [("run start to here", ctx.start), ("", time.perf_counter())]
    model = build_refinedet("test", cfg["size"], cfg["num_classes"],
                            dtype=dtype, device=ctx.device)
    model.net.load_state_dict(inp["state"])
    marks.append(("build", time.perf_counter()))
    if int8:
        model, _ = quantize_model(model, calib_batches(ctx, inp), dtype=dtype,
                                  quant_skip=tuple(ctx.traffic["quant_skip"]))
        marks.append(("quantize", time.perf_counter()))
    fd, path = tempfile.mkstemp(suffix=".rdtorch")
    os.close(fd)
    try:
        save_serving(model, None, path, batch_size=None,
                     fused_nms=fused_settings(cfg), uint8_input=True,
                     input_mean=cfg["mean_bgr"],
                     platforms=(ctx.device.type,))
        marks.append(("save", time.perf_counter()))
        del model
        serving = load_serving(path, ctx.device.type)
        marks.append(("load", time.perf_counter()))
    finally:
        os.remove(path)
    serving.warm_up(batches)
    marks.append(("warm_up", time.perf_counter()))
    print("set-up, the artifact: " + ", ".join(
        f"{name or marks[0][0]} {t - marks[k][1]:.2f} s"
        for k, (name, t) in enumerate(marks[1:])), file=sys.stderr)
    return serving


class Spans:
    """Host-clock spans of each call into the artifact, and CUDA-event
    spans of each graph replay inside it (benchmark instrumentation: the
    graphs' ``replay`` is wrapped, nothing of the program changes)."""

    def __init__(self, serving, on: bool):
        self.serving, self.on = serving, on
        self.calls: List[float] = []
        self.events: List[tuple] = []
        if on:
            for g in serving.graphs.values():
                g.graph = _TimedGraph(g.graph, self.events)

    def __call__(self, images: np.ndarray):
        if not self.on:
            return self.serving(images)
        t0 = time.perf_counter()
        out = self.serving(images)
        self.calls.append(time.perf_counter() - t0)
        return out

    def outside_share(self, first: int = 0, last: int = None) -> float:
        """1 - device time of the replays / host time of the calls, over
        calls ``first`` to ``last``, as a percentage."""
        torch.cuda.synchronize()
        dev = sum(a.elapsed_time(b) for a, b in self.events[first:last]) / 1e3
        host = sum(self.calls[first:last])
        return 100.0 * (1.0 - dev / host)


class _TimedGraph:
    def __init__(self, graph, events: list):
        self.graph, self.events = graph, events

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self.events.append((a, b))


@torch.no_grad()
def reference(ctx: harness.Ctx, inp: dict, int8: bool, levels: int = 127,
              emulate: str = None) -> dict:
    """The reference's served rows for every pool image, and per image
    and class the kept and valid candidate counts. ``int8``: PTQ worked
    out again in float32 from the calibration images, the quantized convs
    exact at ``levels``."""
    cfg, tf = ctx.cfg, ctx.traffic
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = weights.reference_net(cfg["num_classes"], dev).eval()
    net.load_state_dict(inp["state"])
    net.emulate = emulate
    if int8:
        net.levels = levels
        net.quant = ref_quant.quantize(
            net, ref_quant.calibrate(net, calib_batches(ctx, inp),
                                     tf["quant_skip"]), levels)
    pri = torch.from_numpy(priors(cfg["size"])).to(dev)
    post = dict(cfg["detect"], variance=(0.1, 0.2))
    rows, kept, valid = [], [], []
    block = tf.get("reference_block", 8)
    for i in range(0, tf["pool_images"], block):
        x = inp["images"][i:i + block].float() - inp["mean_rgb"]
        c = ref_detect.candidates(net(x), pri, post)
        rows.append(ref_detect.dets(c, x.shape[0], post["nms_top_k"]))
        kept.append(c.keep.sum(-1).view(x.shape[0], -1))
        valid.append(c.valid.sum(-1).view(x.shape[0], -1))
    return {"dets": torch.cat(rows), "kept": torch.cat(kept).cpu(),
            "valid": torch.cat(valid).cpu()}


def k1_bound_s(ref: dict, images: Sequence[int], top_k: int) -> float:
    """K1's least seconds over the calls that served ``images`` (one
    launch per call, each image's classes one group each)."""
    groups = [(int(k), int(v)) for i in images
              for k, v in zip(ref["kept"][i], ref["valid"][i])]
    return flops.k1_bound_s(groups, top_k)


def judge_rows(ctx: harness.Ctx, got: torch.Tensor,
               want: torch.Tensor) -> Dict[str, float]:
    """``judge.det_gaps`` with the cell's ``min_score``, ``score_tol`` and,
    where it has one, ``logit_tol``."""
    j = ctx.traffic["judge"]
    return judge.det_gaps(got, want, j["min_score"], j["score_tol"],
                          j.get("logit_tol"))


def as_tensor(rows: Sequence[np.ndarray], device) -> torch.Tensor:
    return torch.from_numpy(np.stack(rows)).to(device)


def int8_paths(quant_skip: Sequence[str]) -> Dict[str, str]:
    return {n: p for n, p in quantizable().items() if n not in quant_skip}
