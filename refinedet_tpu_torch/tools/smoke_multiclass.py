"""Multi-class end-to-end learnability smoke (3 foreground classes).

    python -m refinedet_tpu_torch.tools.smoke_multiclass [--device cuda]

The port of ``tools/smoke_multiclass.py``, the complement of
``smoke_e2e``: classes are colour-coded rectangles
(``fixtures.multiclass_fixture``), so the ODM classifier must separate
classes and the per-class NMS and eval paths run with C = 4 (K1 at G =
16 x 3 groups a batch). 16 images as one fixed batch, 1600 bf16 steps
from the weights of seed 0 (the 1e-5 -> 5e-4 ramp over 100 steps, 5e-4
from 100, 5e-5 from 1200; clip 5), the mean 98.13 of the JAX tool, the
loss printed every 400 steps, then the train-set AP/AP50. The JAX tool
takes no flags; ``--device`` picks the device.
"""

from __future__ import annotations

import argparse
import json

import torch

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.fixtures import multiclass_fixture

SIZE, CLASSES, STEPS, LOG_EVERY = 320, 4, 1600, 400
MEAN = (98.13,) * 3  # tools/smoke_multiclass.py:63


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ds = multiclass_fixture(SIZE, dev)
    assert ds.num_classes == CLASSES
    model, logged = ft.train_from_scratch(
        0, SIZE, CLASSES, STEPS, len(ds), ds, ft.multiclass_schedule(), dev,
        torch.bfloat16, MEAN, log_every=LOG_EVERY)
    state = ft.net_state(model.net)
    del model
    test = build_refinedet("test", SIZE, CLASSES, dtype=torch.bfloat16,
                           device=dev)
    ap = ft.ap_of(test, state, ds, MEAN)
    print(f"MULTI-CLASS TRAIN-SET AP: {ap['ap']:.4f} AP50: {ap['ap50']:.4f}",
          flush=True)
    out = {"tool": "smoke_multiclass", **ap, "logged": logged,
           "launches": ft.kernel_launches()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
