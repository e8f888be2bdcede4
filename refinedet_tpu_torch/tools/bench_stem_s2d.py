"""The space-to-depth stem twin against the standard model, on the card.

    python -m refinedet_tpu_torch.tools.bench_stem_s2d [--batch 128]
        [--iters 20] [--size 320] [--device cuda]

The port of ``tools/bench_stem_s2d.py``: RefineDet (21 classes, bf16,
weights of seed 0) and its ``stem_s2d`` twin with the same weights folded
(``models/stem_s2d.py``), each running ``RefineDetModel.apply`` (the
forward, softmax and the cascade decode) on seeded images uniform in
[-120, 130). Does the blocked 256-channel stem and the folded pool1 pay
for the stem's 16/9 FLOPs?

Timing: CUDA events over ``--iters`` back-to-back calls after a warm-up,
the two models in turns A, B, B, A on one card (``tools/ab_turns.py``);
each turn's peak memory. Then the same for the stems alone
(``RefineDet.stem``: conv1_1 to pool1, or the twin's blocked form, on
the same images under the same autocast), the one part the twin
changes. The JAX tool chained the iterations inside one
XLA program through a fetched scalar accumulator, a workaround for its
TPU's remote-execution relay; eager PyTorch runs every call it is given.
Without a card the tool stops: it times nothing on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.tools.ab_turns import card, in_turns, report

NUM_CLASSES = 21


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev, smi = card(args.device, "bench_stem_s2d")
    models = {name: build_refinedet("test", args.size, NUM_CLASSES,
                                    dtype=torch.bfloat16, device=dev,
                                    seed=0, stem_s2d=stem)
              for name, stem in (("standard", False), ("stem_s2d", True))}
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        -120, 130, (args.batch, args.size, args.size, 3)).astype(
            np.float32)).to(dev)
    print(f"card: {smi}; RefineDet{args.size}, {NUM_CLASSES} classes, "
          f"bf16, batch {args.batch}, {args.iters} iterations a turn",
          flush=True)
    nchw = images.permute(0, 3, 1, 2)  # the net's channels-last view

    def stem(model):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return model.net.stem(nchw)

    with torch.inference_mode():
        results = in_turns({name: (lambda m=m: m.apply(images))
                            for name, m in models.items()}, args.iters, dev)
        stems = in_turns({name: (lambda m=m: stem(m))
                          for name, m in models.items()}, args.iters, dev)
    for label, res in (("forward and detect", results), ("stem alone",
                                                          stems)):
        print(f"{label}:", flush=True)
        report(res, args.batch, "batch")
        ms = {name: sum(r["ms"]) / len(r["ms"]) for name, r in res.items()}
        print(f"        speedup: {ms['standard'] / ms['stem_s2d']:.3f}x "
              f"(stem_s2d images/s over standard's)", flush=True)
    return {"card": smi, "batch": args.batch, "size": args.size,
            "iters": args.iters, "results": results, "stems": stems}


if __name__ == "__main__":
    main()
