"""Capture a ``torch.profiler`` trace of the inference path and
summarize it.

    python -m refinedet_tpu_torch.tools.trace_infer [BATCH] [ITERS]
        [--device cuda]
    python -m refinedet_tpu_torch.tools.trace_infer --summarize DIR

The port of ``tools/trace_infer.py`` (batch 128, 4 executions by
default): RefineDet320, 21 classes, bf16 in channels-last, weights of
seed 0, the full test-phase ``RefineDetModel.apply`` (backbone and
heads, softmax, the objectness filter and the cascade decode, the
reference's live ``Detect_RefineDet`` path) on seeded images uniform in
[-120, 130). Three warm-up calls, then ``ITERS`` calls issued back to
back, each under a ``span``, the host waiting only at the end,
under ``profile_trace``. The summary (``utils/trace_summary.py``) says
how much of the device time is convolution and how much the rest
(pooling, L2Norm, layout copies, the decode and softmax), each
execution's device ms, the gaps between them and the idle %. It is
printed and written beside the trace directory (``<dir>.md``), a fresh
temporary directory; ``--summarize`` re-reads an existing one.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.tools.profile_train_step import device_name
from refinedet_tpu_torch.utils.timer import profile_trace, span
from refinedet_tpu_torch.utils.trace_summary import summarize

SIZE = 320
NUM_CLASSES = 21
WARMUP = 3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=128)
    p.add_argument("iters", nargs="?", type=int, default=4)
    p.add_argument("--summarize", metavar="DIR",
                   help="summarize an existing trace directory")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def capture(logdir: str, batch: int, iters: int, device) -> str:
    """Trace ``iters`` inference calls into ``logdir``; returns the
    device's name."""
    dev = resolve_device(device)
    model = build_refinedet("test", SIZE, NUM_CLASSES, dtype=torch.bfloat16,
                            device=dev, seed=0)
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        -120, 130, (batch, SIZE, SIZE, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        for _ in range(WARMUP):
            out = model.apply(images)
        out[0].cpu()
        with profile_trace(logdir, dev):
            for i in range(iters):  # back to back; the scope waits at its end
                with span(f"infer/{i}"):
                    model.apply(images)
    return device_name(dev)


def main(argv: Optional[list] = None) -> str:
    args = parse_args(argv)
    if args.summarize:
        summary = summarize(args.summarize, args.batch, args.device)
        print(summary)
        return summary
    resolve_device(args.device)
    logdir = tempfile.mkdtemp(prefix="trace_infer_")
    name = capture(logdir, args.batch, args.iters, args.device)
    summary = summarize(logdir, args.batch, args.device)
    print(summary, flush=True)
    with open(logdir + ".md", "w") as f:
        f.write(f"# torch.profiler trace: RefineDet320 inference, batch "
                f"{args.batch}, {args.iters} executions back to back "
                f"({name})\n\nCaptured by python -m refinedet_tpu_torch."
                f"tools.trace_infer; trace under {logdir}.\n\n```\n"
                + summary + "\n```\n")
    print(f"\nwrote {logdir}.md (trace dir: {logdir})")
    return summary


if __name__ == "__main__":
    main()
