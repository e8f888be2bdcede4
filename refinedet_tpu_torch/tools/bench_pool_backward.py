"""The 2x2 max pools' two backwards inside the full train step, on the card.

    python -m refinedet_tpu_torch.tools.bench_pool_backward [BATCH] [ITERS]
        [--device cuda]

The port of ``tools/bench_pool_backward.py`` (batch 128, 10 iterations by
default): RefineDet320, 2 classes, bf16, ``max_boxes`` 8, the JAX tool's
fixed boxes and labels on seeded images, SGD at lr 1e-4
(``tools/profile_train_step.py:train_setup``); ``make_train_step``'s full
step under ``models/layers.py:POOL_BACKWARD`` "select_scatter" (ATen's
``max_pool2d`` backward, which keeps int64 indices) and "slice"
(``MaxPool2dSlice``: keeps the pooled output, the backward as strided
slices, compares and an interleave). Each mode steps a model of its own,
both from the same seed, so every timed step starts from a like state.

Timing: CUDA events over ``ITERS`` back-to-back steps after a warm-up
step, the two modes in turns A, B, B, A on one card
(``tools/ab_turns.py``); each turn's peak memory, which is where the
slice backward should differ most. Then the same for the step's five
pools alone, forward and backward at their shapes in the step (bf16,
channels-last, seeded values), beside the least time the card could
take: each input and output once (x, y, dy, dx) over 3.35 TB/s. The JAX
tool chained the steps inside one XLA program through a fetched scalar
accumulator, a workaround for its TPU's remote-execution relay. Without
a card the tool stops: it times nothing on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from refinedet_tpu_torch.models import layers
from refinedet_tpu_torch.models.refinedet import vgg_layout
from refinedet_tpu_torch.tools.ab_turns import card, in_turns, report
from refinedet_tpu_torch.tools.profile_train_step import (NUM_CLASSES, SIZE,
                                                          train_setup)
from refinedet_tpu_torch.train.train_step import (create_train_state,
                                                  make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=128)
    p.add_argument("iters", nargs="?", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def stepper(mode: str, batch: int, dev):
    """A closure taking one train step under ``POOL_BACKWARD = mode`` on
    a model of its own (seed 0) and the JAX tool's batch."""
    model, optimizer, cfg, images, boxes, labels, valid = train_setup(
        batch, dev)
    step = make_train_step(model, optimizer, cfg)
    state = [create_train_state(model, optimizer)]

    def run():
        with layers.pool_backward(mode):
            state[0], metrics = step(state[0], images, boxes, labels, valid)
        return metrics["loss"]
    return run


H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet


def pool_inputs(batch: int, size: int = SIZE):
    """(NCHW shape, ceil mode) of each pool's input in the trunk."""
    out, c, h = [], 3, size
    for entry in vgg_layout():
        if entry[0] == "conv":
            c = entry[3]
            kw = entry[4]
            h = h + 2 * kw.get("padding", 0) - kw.get("dilation", 1) * (
                kw["kernel_size"] - 1)
        elif entry[0] == "pool":
            out.append(((batch, c, h, h), entry[1]))
            h = -(-h // 2) if entry[1] else h // 2
    return out


def pools_alone(batch: int, dev):
    """A closure per mode running the trunk's pools forward and backward
    on seeded bf16 channels-last inputs, and the bytes floor in ms."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, nbytes = [], 0
    for shape, ceil in pool_inputs(batch):
        x = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        pool = layers.MaxPool2x2(ceil)
        with torch.no_grad():
            g = torch.randn(pool(x).shape, generator=gen, device=dev).to(
                torch.bfloat16)
        cases.append((pool, x.requires_grad_(), g))
        nbytes += 2 * (x.numel() + g.numel()) * x.element_size()

    def run(mode):
        def call():
            with layers.pool_backward(mode):
                for pool, x, g in cases:
                    x.grad = None
                    pool(x).backward(g)
        return call
    return {mode: run(mode) for mode in layers.POOL_BACKWARDS}, \
        nbytes / H100_BYTES_PER_S * 1e3


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev, smi = card(args.device, "bench_pool_backward")
    print(f"card: {smi}; RefineDet{SIZE}, {NUM_CLASSES} classes, bf16, "
          f"batch {args.batch}, {args.iters} steps a turn", flush=True)
    results = in_turns({mode: stepper(mode, args.batch, dev)
                        for mode in layers.POOL_BACKWARDS}, args.iters, dev)
    report(results, args.batch, "step")
    torch.cuda.empty_cache()
    fns, bound_ms = pools_alone(args.batch, dev)
    pools = in_turns(fns, args.iters, dev)
    print(f"the five pools alone, forward and backward (bound {bound_ms:.3f} "
          "ms by bytes):", flush=True)
    report(pools, args.batch, "batch")
    return {"card": smi, "batch": args.batch, "iters": args.iters,
            "results": results, "pools": pools, "pools_bound_ms": bound_ms}


if __name__ == "__main__":
    main()
