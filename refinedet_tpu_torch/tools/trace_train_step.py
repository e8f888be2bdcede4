"""Capture a ``torch.profiler`` trace of the real train step and
summarize it.

    python -m refinedet_tpu_torch.tools.trace_train_step [BATCH] [STEPS]
        [--device cuda]
    python -m refinedet_tpu_torch.tools.trace_train_step --summarize DIR

The port of ``tools/trace_train_step.py`` (batch 128, 3 steps by
default): ``train/train_step.py:make_train_step``'s step on RefineDet320,
2 classes, bf16, ``max_boxes`` 8, the JAX tool's fixed boxes and labels
(``profile_train_step.train_setup``). Three warm-up steps, then ``STEPS``
steps issued back to back, each under the step's own ``train.step``
span, the host waiting only at the end, under ``profile_trace``. The
summary (``utils/trace_summary.py``) gives each step's device ms, the
device's idle gaps between steps, the idle % of the traced window and
the split of device time by the aten op that launched each kernel. It
is printed and written beside the trace directory (``<dir>.md``),
which is a fresh temporary directory; ``--summarize`` re-reads an
existing one.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.tools.profile_train_step import (device_name,
                                                          train_setup)
from refinedet_tpu_torch.train.train_step import (create_train_state,
                                                  make_train_step)
from refinedet_tpu_torch.utils.timer import profile_trace
from refinedet_tpu_torch.utils.trace_summary import summarize

WARMUP = 3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=128)
    p.add_argument("steps", nargs="?", type=int, default=3)
    p.add_argument("--summarize", metavar="DIR",
                   help="summarize an existing trace directory")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def capture(logdir: str, batch: int, steps: int, device) -> str:
    """Trace ``steps`` train steps into ``logdir``; returns the device's
    name."""
    dev = resolve_device(device)
    model, optimizer, cfg, images, boxes, labels, valid = train_setup(
        batch, dev)
    step = make_train_step(model, optimizer, cfg)
    state = create_train_state(model, optimizer)
    for _ in range(WARMUP):
        state, metrics = step(state, images, boxes, labels, valid)
    float(metrics["loss"])
    with profile_trace(logdir, dev):
        for _ in range(steps):  # back to back; the scope waits at its end
            state, metrics = step(state, images, boxes, labels, valid)
    return device_name(dev)


def main(argv: Optional[list] = None) -> str:
    args = parse_args(argv)
    if args.summarize:
        summary = summarize(args.summarize, args.batch, args.device)
        print(summary)
        return summary
    resolve_device(args.device)
    logdir = tempfile.mkdtemp(prefix="trace_train_")
    name = capture(logdir, args.batch, args.steps, args.device)
    summary = summarize(logdir, args.batch, args.device)
    print(summary, flush=True)
    with open(logdir + ".md", "w") as f:
        f.write(f"# torch.profiler trace: RefineDet320 train step, batch "
                f"{args.batch}, {args.steps} steps back to back ({name})\n\n"
                "Captured by python -m refinedet_tpu_torch.tools."
                f"trace_train_step; trace under {logdir}.\n\n```\n"
                + summary + "\n```\n")
    print(f"\nwrote {logdir}.md (trace dir: {logdir})")
    return summary


if __name__ == "__main__":
    main()
