"""Int8 accuracy smoke: bf16 against the int8 PTQ twin on a trained model.

    python -m refinedet_tpu_torch.tools.smoke_int8 [STEPS] [--device cuda]

The port of ``tools/smoke_int8.py``: RefineDet320 trained from scratch
(weights of seed 0, bf16) on the 64-image SSDD-like fixture of seed 3 in
4 rotating batches of 16 (generalization, not pure memorization) for
``STEPS`` steps (default 3000; the 1e-5 -> 5e-4 ramp, 5e-5 from 75%),
then the train-set AP served in bf16, with the matched weight-noise
control (one int8 step of uniform noise on every conv the full int8 set
would quantize, ``RandomState(0)``: how perturbation-sensitive the
fixture is at all), and as the int8 twin (``quantize_model`` at its
defaults, the default ``quant_skip``, calibrated on 16 images) on the
port's int8 conv and quantize kernels.
"""

from __future__ import annotations

import argparse
import json

import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.quant import quantize_model
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.ablate_int8 import CALIB_IMAGES, noise_state
from refinedet_tpu_torch.tools.fixtures import coco_fixture

SIZE, N_IMAGES, BATCH, FIXTURE_SEED, LOG_EVERY = 320, 64, 16, 3, 500


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("steps", nargs="?", default=3000, type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ds = coco_fixture(N_IMAGES, FIXTURE_SEED, SIZE, dev)
    model, _ = ft.train_from_scratch(0, SIZE, 2, args.steps, BATCH, ds,
                                     ft.decay_schedule(args.steps), dev,
                                     log_every=LOG_EVERY)
    state = ft.net_state(model.net)
    del model
    out = {}

    def report(tag, model, st):
        out[tag] = ft.ap_of(model, st, ds)
        print(f"{tag} TRAIN-SET AP: {out[tag]['ap']:.4f} "
              f"AP50: {out[tag]['ap50']:.4f}", flush=True)

    fmodel = build_refinedet("test", SIZE, 2, dtype=torch.bfloat16,
                             device=dev)
    report("bf16", fmodel, state)
    report("bf16+noise-ctl", fmodel, noise_state(state, 0, ()))
    fmodel.net.load_state_dict(state, strict=True)
    model_q, state_q = quantize_model(
        fmodel, [ft.eval_images(ds, CALIB_IMAGES)])
    report("int8", model_q, state_q)
    d_q = out["int8"]["ap"] - out["bf16"]["ap"]
    d_n = out["bf16+noise-ctl"]["ap"] - out["bf16"]["ap"]
    print(f"AP delta (int8 - bf16): {d_q:+.4f} (noise-control delta "
          f"{d_n:+.4f})", flush=True)
    result = {"tool": "smoke_int8", "steps": args.steps, "arms": out,
              "launches": ft.kernel_launches()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
