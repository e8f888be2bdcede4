"""The train driver: the port's ``make_train_step`` with on-device
augmentation, in a closed loop over a pool of staged batches on the card.

Set-up makes the staged pool (uint8 canvases at the staging size, their
boxes in staging pixels) and the weights from the seed, builds one step
(``build_refinedet`` in the configuration's dtype, ``make_optimizer`` with
the traffic's lr, momentum, weight decay and global-norm clip,
``make_train_step`` with ``on_device_augment``), and drives it through its
first ``check_steps`` steps on pool batches that all differ: the initial
weights, the momentum buffers after the first step (the clipped gradient
plus the decay) and the weights after the last are kept. Then it warms up
``warm_steps`` more. The same step object runs the window, one step per
pool batch in turn, and ``train_images_per_s`` is every image stepped
over the whole window, which ends in a synchronize.

Afterwards the program is freed and the reference repeats the checked
steps in float32 (TF32 off): the same staged batches, the augmentation
draws worked out again from (seed, step), the same initial weights.
"""

from __future__ import annotations

import math
import sys
import time
from typing import List, Optional

import torch

from portbench import flops, harness, judge, weights
from portbench.reference import augment as ref_aug
from portbench.reference.boxes import priors
from portbench.reference.loss import Sgd, refinedet_loss

GIB = float(1 << 30)


def inputs(ctx: harness.Ctx) -> dict:
    """The staged pool and the float32 weights, from the seed."""
    cfg, tf = ctx.cfg, ctx.traffic
    dev = ctx.device
    b, pool = tf["batch"], tf["batch"] * tf["pool_batches"]
    gen = harness.generator(tf["generator"])
    images, boxes, labels, valid = gen.make(
        tf["scene"], weights.generator(ctx.seed, 2, dev), pool,
        tf["staging"], cfg["num_classes"], tf["max_boxes"])
    mean_rgb = torch.tensor(cfg["mean_bgr"][::-1], device=dev)
    size = cfg["size"]
    calib = torch.nn.functional.interpolate(
        images[:2].permute(0, 3, 1, 2).float(), size=(size, size),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1) - mean_rgb
    state = weights.make_state(cfg, ctx.seed, calib, dev)
    return {"images": images, "boxes": boxes, "labels": labels,
            "valid": valid, "state": state, "batch": b,
            "batches": tf["pool_batches"]}


def batch(inp: dict, k: int):
    b = inp["batch"]
    k %= inp["batches"]
    rows = slice(k * b, (k + 1) * b)
    return (inp["images"][rows], inp["boxes"][rows], inp["labels"][rows],
            inp["valid"][rows])


def reference_steps(ctx: harness.Ctx, inp: dict, steps: int,
                    emulate: Optional[str] = None, rows: Optional[int] = None,
                    frozen: bool = False) -> dict:
    """The checked steps by the reference in float32: losses, the first
    step's clipped gradient per leaf, the change of each leaf. ``emulate``
    ("fp8", "int8") runs its convolutions in a precision below bfloat16;
    ``rows`` keeps only the first rows of each batch and ``frozen`` leaves
    the weights as they were, the optimizer given nothing (faults)."""
    cfg, tf = ctx.cfg, ctx.traffic
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = weights.reference_net(cfg["num_classes"], dev)
    net.load_state_dict(inp["state"])
    net.emulate = emulate
    params = dict(net.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    sgd = Sgd(params, tf["lr"], tf["momentum"], tf["weight_decay"],
              tf["clip"])
    pri = torch.from_numpy(priors(cfg["size"])).to(dev)
    losses = []
    for s in range(steps):
        images, boxes, labels, valid = batch(inp, s)
        draws = ref_aug.sample_draws(
            ref_aug.step_generator(ctx.seed, s, dev), images.shape[0])
        if rows is not None:
            images, boxes, labels, valid = (t[:rows] for t in
                                            (images, boxes, labels, valid))
            draws = ref_aug.Draws(*(t[:rows] for t in draws))
        img, bx, vd = ref_aug.augment_batch(images, boxes, valid, draws,
                                            cfg["size"], cfg["mean_bgr"])
        loss = refinedet_loss(net(img), pri, bx, labels, vd,
                              cfg["num_classes"])
        losses.append(float(loss.detach()))
        if frozen:
            continue
        loss.backward()
        sgd.step()
    with torch.no_grad():
        delta = {n: params[n] - start[n] for n in params}
    grad = {n: torch.zeros_like(p) for n, p in params.items()} if frozen \
        else sgd.first_grad
    return {"losses": losses, "grad": grad, "delta": delta}


def run(ctx: harness.Ctx) -> harness.Outcome:
    from refinedet_tpu_torch.config import TrainConfig
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step)

    cfg, tf = ctx.cfg, ctx.traffic
    dev = ctx.device
    inp = inputs(ctx)
    model = build_refinedet("train", cfg["size"], cfg["num_classes"],
                            dtype=getattr(torch, cfg["dtype"]), device=dev)
    model.net.load_state_dict(inp["state"])
    opt = make_optimizer(model.net.parameters(), lambda t: tf["lr"],
                         tf["momentum"], tf["weight_decay"], tf["clip"])
    train_cfg = TrainConfig(batch_size=inp["batch"],
                            max_boxes=tf["max_boxes"],
                            grad_clip_norm=tf["clip"],
                            on_device_augment=True,
                            mean=tuple(cfg["mean_bgr"]), seed=ctx.seed)
    step = make_train_step(model, opt, train_cfg)
    state = create_train_state(model, opt)
    names = {p: n for n, p in model.net.named_parameters()}

    # The checked steps, through the window's own call and feed.
    start = {n: p.detach().clone() for p, n in names.items()}
    losses = []
    for s in range(tf["check_steps"]):
        state, m = step(state, *batch(inp, s))
        losses.append(m["loss"])
        if s == 0:  # no buffer: the optimizer got no gradient
            grad = {n: opt.state[p].get("momentum_buffer", 0.0 * p)
                    - tf["weight_decay"] * start[n]
                    for p, n in names.items()}
    end = {n: p.detach().clone() for p, n in names.items()}
    prog_losses = [float(x) for x in losses]
    for s in range(tf["warm_steps"]):
        state, m = step(state, *batch(inp, state.step))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.start
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    window_losses: List[torch.Tensor] = []

    def one(i):
        nonlocal state
        state, m = step(state, *batch(inp, state.step))
        window_losses.append(m["loss"])

    win = harness.until(ctx.seconds, one,
                        tf["trace_steps"] if ctx.trace else 0,
                        torch.cuda.synchronize)
    window_peak = torch.cuda.max_memory_allocated()
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    del step, state, opt, model, m, names
    torch.cuda.empty_cache()

    ref = reference_steps(ctx, inp, tf["check_steps"])
    delta = {n: end[n] - start[n] for n in start}
    checks = judge.train_gaps(prog_losses, ref["losses"], grad, ref["grad"],
                              delta, ref["delta"])
    print(f"losses: program {prog_losses}, reference {ref['losses']}; "
          f"worst leaf: gradient {judge.worst_leaf(grad, ref['grad'])}, "
          f"change {judge.worst_leaf(delta, ref['delta'])}",
          file=sys.stderr)
    b = inp["batch"]
    e2e = {"setup_s": setup_s,
           "train_images_per_s": win["steps"] * b / win["seconds"],
           "train_peak_gib": window_peak / GIB}
    record = {"window": win, "batch": b, "cfg": cfg, "traffic": tf,
              "step_flops": flops.train_step_flops(
                  cfg["size"], cfg["num_classes"], b, tf["staging"])}
    return harness.Outcome(attempted=win["steps"], failed=failed, e2e=e2e,
                           record=record, checks=checks,
                           memory_peak_bytes=max(setup_peak, window_peak),
                           correct=failed == 0 and all(
                               math.isfinite(v) for v in checks.values()))
