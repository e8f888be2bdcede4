"""Multi-seed EMA accuracy ablation on the card.

    python -m refinedet_tpu_torch.tools.ablate_ema --size 320 --seeds 5 \\
        --steps 2500

The port of ``tools/ablate_ema.py``, under ``ablate_int8``'s protocol:
per seed, RefineDet trained from scratch on the seed's 64-image fixture
in rotating batches while shadow EMAs of the parameters at each decay
of ``--decays`` are carried along (training does not depend on them, so
one run serves every decay); then the train-set AP/AP50 of the final raw
weights against each EMA, and mean ± std over seeds with the deltas
against raw.

Each shadow follows the train step's EMA schedule: after step t (t = 1,
2, ...) ``e = e * d + p * (1 - d)`` with ``d = min(decay, (1 + t) / (10 +
t))`` on the post-update parameters, ``d`` and ``1 - d`` computed in f32
as JAX computes them (``ablate_ema.py:80-84``).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from refinedet_tpu_torch.device import DeviceLike, resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.ablate_int8 import N_IMAGES
from refinedet_tpu_torch.tools.fixtures import coco_fixture

DECAYS = (0.99, 0.999, 0.9998)


def ema_decay(decay: float, t: int) -> np.float32:
    """``jnp.minimum(jnp.float32(decay), (1.0 + t) / (10.0 + t))`` with
    t the f32 step count after the update."""
    t = np.float32(t)
    return np.minimum(np.float32(decay),
                      (np.float32(1.0) + t) / (np.float32(10.0) + t))


def ema_update_(ema: List[torch.Tensor], params: List[torch.Tensor],
                decay: float, t: int) -> None:
    """One shadow update in place: ``e = e * d + p * (1 - d)``."""
    d = ema_decay(decay, t)
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, params, alpha=float(np.float32(1.0) - d))


class Shadows:
    """The shadow EMAs of a net's parameters, one per decay, as the
    ``on_step`` of ``fixture_train.train_from_scratch``."""

    def __init__(self, decays: Sequence[float]):
        self.decays = tuple(decays)
        self.names: List[str] = []
        self.emas: Dict[float, List[torch.Tensor]] = {}

    def __call__(self, t: int, net) -> None:
        named = list(net.named_parameters())
        params = [p.detach() for _, p in named]
        if t == 0:
            self.names = [n for n, _ in named]
            self.emas = {d: [p.clone() for p in params]
                         for d in self.decays}
            return
        for d in self.decays:
            ema_update_(self.emas[d], params, d, t)

    def state(self, decay: float, net) -> Dict[str, torch.Tensor]:
        """``net``'s state_dict with the parameters of the ``decay``
        shadow."""
        state = ft.net_state(net)
        for name, e in zip(self.names, self.emas[decay]):
            state[name] = e.detach().cpu().clone()
        return state


def run_seed(seed: int, size: int, steps: int, batch: int,
             decays: Sequence[float], device: DeviceLike = "cuda",
             log: Callable[[str], None] = print) -> Dict[str, Dict]:
    """``{raw, ema-<decay>...: {ap, ap50}}`` of one seed."""
    dev = resolve_device(device)
    ds = coco_fixture(N_IMAGES, seed, size, dev)
    shadows = Shadows(decays)
    model, _ = ft.train_from_scratch(
        seed, size, 2, steps, batch, ds, ft.decay_schedule(steps), dev,
        on_step=shadows, log=lambda line: log(f"seed {seed}: {line}"))
    states = {"raw": ft.net_state(model.net)}
    for d in decays:
        states[f"ema-{d}"] = shadows.state(d, model.net)
    del model, shadows
    test = build_refinedet("test", size, 2, dtype=torch.bfloat16,
                           device=dev)
    out = {k: ft.ap_of(test, st, ds) for k, st in states.items()}
    log(f"seed {seed}: " + "  ".join(
        f"{k}={v['ap']:.4f}/{v['ap50']:.4f}" for k, v in out.items()))
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", default=320, type=int, choices=(320, 512))
    p.add_argument("--seeds", default=5, type=int)
    p.add_argument("--steps", default=2500, type=int)
    p.add_argument("--batch", default=16, type=int)
    p.add_argument("--decays", default=",".join(map(str, DECAYS)))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    decays = tuple(float(d) for d in args.decays.split(","))
    dev = resolve_device(args.device)
    rows = [run_seed(s, args.size, args.steps, args.batch, decays, dev)
            for s in range(args.seeds)]
    print(f"\n== EMA ablation, RefineDet{args.size}, {args.seeds} seeds, "
          f"{args.steps} steps ==", flush=True)
    summary = ft.summarize(rows, "raw", width=12)
    print(json.dumps({"tool": "ablate_ema", "size": args.size,
                      "seeds": args.seeds, "steps": args.steps,
                      "batch": args.batch, "summary": summary,
                      "launches": ft.kernel_launches()}), flush=True)
    return {"rows": rows, "summary": summary}


if __name__ == "__main__":
    main()
