"""Int8 calibration-count study: does more calibration data close the
strict-AP gap?

    python -m refinedet_tpu_torch.tools.calib_study [--size 320] \\
        [--steps 2500] [--seed 0] [--batch 16] [--device cuda]

The port of ``tools/calib_study.py``: one 64-image fixture of ``--seed``
trained from scratch as ``ablate_int8`` trains it (the same trained
weights, from its cache when a run of it holds them), then the
int8-default twin (``quantize_model`` at its defaults) calibrated on the
first 8, 16, 32 and 64 images, in batches of 16, each scored against
bf16 on the train set. The JAX tool slices ``range(0, n, 16)`` into
whole batches of 16, so its "8" row calibrates on 16 images; here the
8-image row takes 8.
"""

from __future__ import annotations

import argparse
import json

import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.quant import quantize_model
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.ablate_int8 import N_IMAGES
from refinedet_tpu_torch.tools.fixtures import coco_fixture

CALIB_COUNTS = (8, 16, 32, 64)
CALIB_BATCH = 16


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", default=320, type=int)
    p.add_argument("--steps", default=2500, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--batch", default=16, type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ds = coco_fixture(N_IMAGES, args.seed, args.size, dev)
    state = ft.trained_state(args.seed, args.size, args.steps, args.batch,
                             ds, dev)
    model = build_refinedet("test", args.size, 2, dtype=torch.bfloat16,
                            device=dev)
    out = {"bf16": ft.ap_of(model, state, ds)}
    print(f"bf16:      AP {out['bf16']['ap']:.4f}  "
          f"AP50 {out['bf16']['ap50']:.4f}", flush=True)
    model.net.load_state_dict(state, strict=True)
    images = ft.eval_images(ds, len(ds))
    for n in CALIB_COUNTS:
        calib = [images[i:min(i + CALIB_BATCH, n)]
                 for i in range(0, n, CALIB_BATCH)]
        model_q, state_q = quantize_model(model, calib)
        out[f"int8-calib{n}"] = ap = ft.ap_of(model_q, state_q, ds)
        del model_q
        print(f"int8 calib={n:3d}: AP {ap['ap']:.4f}  AP50 {ap['ap50']:.4f}",
              flush=True)
    result = {"tool": "calib_study", "size": args.size,
              "steps": args.steps, "seed": args.seed, "arms": out,
              "launches": ft.kernel_launches()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
