"""Int8 accuracy on ``smoke_e2e``'s trained weights, scored on the card and
again on the host CPU through the plain versions.

    python -m refinedet_tpu_torch.tools.int8_witness [--device cuda]

Trains ``smoke_e2e`` at its defaults on ``--device`` (the 16 images of
seed 3, 600 bf16 steps), then scores the trained weights on the same
images as the arms bf16, noise-ctl-default and int8-default
(``ablate_int8.score_arms``: one calibration of 16 images, the noise
control drawn from seed 0) twice: on ``--device``, where
the int8 conv, the activation quantize and K1 are the hand-written
kernels, and on the CPU, where each op computes its plain version
(``int8_conv_reference``, ``int8_quantize_reference``,
``nms_sweep_reference``) and oneDNN runs the bf16 convs. An AP50 loss that
both show belongs to the weights, not to the kernels.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.tools import ablate_int8, smoke_e2e
from refinedet_tpu_torch.tools import fixture_train as ft

ARMS = ("bf16", "noise-ctl-default", "int8-default")


def run(device="cuda", log: Callable[[str], None] = print) -> Dict:
    """``{"smoke_e2e": {ap, ap50}, "<device>": {arm: {ap, ap50}}, "cpu":
    {...}}``: the arms of one trained weight set on each device."""
    dev = resolve_device(device)
    e2e = smoke_e2e.run(dev, log=log)
    out = {"smoke_e2e": {"ap": e2e["ap"], "ap50": e2e["ap50"]}}
    for where in dict.fromkeys((dev, torch.device("cpu"))):
        arms = ablate_int8.score_arms(e2e["state"], e2e["ds"],
                                      smoke_e2e.SIZE, ARMS, seed=0,
                                      device=where)
        for tag, ap in arms.items():
            log(f"{where.type}: {tag:>20s} AP {ap['ap']:.4f} AP50 "
                f"{ap['ap50']:.4f} (dAP {ap['ap'] - arms['bf16']['ap']:+.4f}"
                f", dAP50 {ap['ap50'] - arms['bf16']['ap50']:+.4f})")
        out[where.type] = arms
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(args.device)
    print(json.dumps({"tool": "int8_witness", **out,
                      "launches": ft.kernel_launches()}), flush=True)
    return out


if __name__ == "__main__":
    main()
