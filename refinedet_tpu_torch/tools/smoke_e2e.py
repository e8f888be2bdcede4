"""End-to-end learnability smoke: train RefineDet320 from scratch, score
the train set.

    python -m refinedet_tpu_torch.tools.smoke_e2e [--device cuda]

The port of ``tools/smoke_e2e.py``: the 16-image SSDD-like fixture of
seed 3 (``fixtures.coco_fixture``) as one fixed batch, 600 bf16 steps
from the weights of seed 0 (lr ramped from 1e-5 to 5e-4 over 100 steps,
then held; clip 5), the loss printed every 100 steps, then the train-set
AP/AP50 through the Evaluator (K1 on the card) and the port's COCOeval.
It exercises the whole pipeline: staging, matching, the ARM/ODM losses,
SGD, NMS and COCOeval. The JAX tool takes no flags; ``--device`` picks
the device (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.fixtures import coco_fixture

SIZE, IMAGES, FIXTURE_SEED, STEPS, LOG_EVERY = 320, 16, 3, 600, 100


def run(device="cuda", log: Callable[[str], None] = print) -> dict:
    """Train and score; returns ``{"logged": [(it, loss)], "ap", "ap50",
    "state", "ds"}`` (the trained CPU state_dict and the fixture)."""
    dev = resolve_device(device)
    ds = coco_fixture(IMAGES, FIXTURE_SEED, SIZE, dev)
    model, logged = ft.train_from_scratch(0, SIZE, 2, STEPS, IMAGES, ds,
                                          ft.warmup_schedule(), dev,
                                          log_every=LOG_EVERY, log=log)
    state = ft.net_state(model.net)
    del model
    test = build_refinedet("test", SIZE, 2, dtype=torch.bfloat16,
                           device=dev)
    ap = ft.ap_of(test, state, ds)
    log(f"TRAIN-SET AP: {ap['ap']:.4f} AP50: {ap['ap50']:.4f}")
    return {"logged": logged, **ap, "state": state, "ds": ds}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(args.device)
    print(json.dumps({"tool": "smoke_e2e", "ap": out["ap"],
                      "ap50": out["ap50"], "logged": out["logged"],
                      "launches": ft.kernel_launches()}), flush=True)
    return out


if __name__ == "__main__":
    main()
