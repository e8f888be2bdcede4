"""The shared core of the tools that train on a synthetic fixture.

The JAX repo's five training tools each repeat the same fixture ->
collate -> schedule -> train -> Evaluator code. Here it is written once,
and ``smoke_e2e``, ``smoke_multiclass``, ``smoke_int8``, ``ablate_int8``,
``calib_study`` and ``ablate_ema`` are thin front ends to it:

  * ``rotating_batches``: the fixture's samples (``BaseTransform`` at the
    model's size and the SSDD mean, the JAX tools' normalized targets)
    collated with ``max_boxes=8`` into batches that the steps take in
    turn, uploaded to the device once;
  * the tools' three learning-rate schedules as plain ``lr(t)`` functions
    of the step count t (before the step, as optax counts) for the port's
    ``SGD``: ``warmup_schedule`` (``smoke_e2e.py:34``),
    ``multiclass_schedule`` (``smoke_multiclass.py:81``) and
    ``decay_schedule`` (``smoke_int8.py:56``, ``ablate_int8.py``,
    ``calib_study.py:64``, ``ablate_ema.py``), joined as
    ``optax.join_schedules`` joins them: a later piece sees ``t -
    boundary``;
  * ``train_from_scratch``: bf16 weights from ``reset_parameters`` with
    ``torch.Generator().manual_seed(seed)`` (``build_refinedet(seed=)``),
    trained by ``train``: ``TrainConfig(max_boxes=8, lr=5e-4,
    grad_clip_norm=5.0)`` and the port's ``make_train_step``; the loop
    waits for the card only at the every-N loss print it is asked for;
  * ``trained_state``: ``train_from_scratch`` with the decay schedule
    behind a cache of trained weights, keyed on (size, seed, steps,
    batch), shared by ``ablate_int8`` and ``calib_study``;
  * ``ap_of``: the port's ``Evaluator`` (K1 on the card) with
    ``batch_size=16`` and ``nms_top_k=128`` and the COCO stats,
    ``{ap, ap50}``;
  * ``summarize``: the mean ± std (numpy, ddof 0) over seeds and the
    deltas against a base arm, printed as the JAX tools print them.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from refinedet_tpu_torch.config import MEANS, DetectConfig, TrainConfig
from refinedet_tpu_torch.data.augmentations import BaseTransform
from refinedet_tpu_torch.data.collate import detection_collate
from refinedet_tpu_torch.device import DeviceLike, resolve_device
from refinedet_tpu_torch.eval.evaluator import Evaluator
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.ops import int8_conv, nms_cuda
from refinedet_tpu_torch.train.train_step import (create_train_state,
                                                  make_optimizer,
                                                  make_train_step)

LR = 5e-4
MAX_BOXES = 8
GRAD_CLIP = 5.0
WARMUP_INIT, WARMUP_STEPS = 1e-5, 100
EVAL_BATCH, EVAL_NMS_TOP_K = 16, 128
# Trained weights of the ablation tools, one file per (size, seed, steps,
# batch); not in git.
CACHE_DIR = osp.join(osp.dirname(osp.abspath(__file__)), ".ablate_ckpt")

Schedule = Callable[[int], float]


def linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule(init, end, steps)``."""
    def lr(t: int) -> float:
        frac = 1.0 - min(max(t, 0), steps) / steps
        return (init - end) * frac + end
    return lr


def constant_schedule(value: float) -> Schedule:
    return lambda t: value


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: from ``boundaries[i]`` on, the piece
    ``schedules[i + 1]`` at ``t - boundaries[i]``."""
    def lr(t: int) -> float:
        out = schedules[0](t)
        for boundary, piece in zip(boundaries, schedules[1:]):
            if t >= boundary:
                out = piece(t - boundary)
        return out
    return lr


def warmup_schedule(lr: float = LR) -> Schedule:
    """``tools/smoke_e2e.py:34``: 1e-5 -> lr over 100 steps, then held."""
    return linear_schedule(WARMUP_INIT, lr, WARMUP_STEPS)


def multiclass_schedule(lr: float = LR) -> Schedule:
    """``tools/smoke_multiclass.py:81``: the ramp, lr from 100, lr * 0.1
    from 1200."""
    return join_schedules([warmup_schedule(lr), constant_schedule(lr),
                           constant_schedule(lr * 0.1)], [100, 1200])


def decay_schedule(steps: int, lr: float = LR) -> Schedule:
    """``tools/smoke_int8.py:56`` (and the ablations): the ramp, then
    lr * 0.1 from ``int(0.75 * steps)``."""
    return join_schedules([warmup_schedule(lr), constant_schedule(lr * 0.1)],
                          [int(steps * 0.75)])


def eval_images(ds, n: int, mean: Sequence[float] = MEANS) -> np.ndarray:
    """The first ``n`` fixture images as the Evaluator feeds them, float32
    ``[n, size, size, 3]``: the calibration stream of the int8 tools."""
    bt = BaseTransform(ds.size, mean)
    return np.stack([bt(ds.pull_image(i)[0]) for i in range(n)])


def rotating_batches(ds, batch: int, device: DeviceLike,
                     mean: Sequence[float] = MEANS) -> List[tuple]:
    """The fixture as batches of ``batch`` images (the last may be
    shorter), each (images, boxes, labels, valid) on ``device``: the
    images through ``BaseTransform`` at the held size (mean-subtracted
    RGB), the JAX tools' targets."""
    bt = BaseTransform(ds.size, mean)
    samples = [(bt(img), *target)
               for img, target in zip(ds.images, ds.targets)]
    dev = resolve_device(device)
    out = []
    for b in range(0, len(samples), batch):
        collated = detection_collate(samples[b:b + batch],
                                     max_boxes=MAX_BOXES)
        out.append(tuple(torch.from_numpy(a).to(dev) for a in collated))
    return out


def train(model, ds, batch: int, steps: int, schedule: Schedule,
          mean: Sequence[float] = MEANS, log_every: int = 0,
          on_step: Optional[Callable] = None,
          log: Callable[[str], None] = print) -> List[tuple]:
    """``steps`` steps of the train-phase ``model`` (from its current
    weights, step count 0 for ``schedule``) on ``ds``'s rotating batches
    of ``batch``; returns the ``(it, loss)`` pairs printed every
    ``log_every`` steps (0: none), the last step's appended.
    ``on_step(t, net)`` is called with t = 0 before the first step and
    with the step count after each step."""
    batches = rotating_batches(ds, batch, model.device, mean)
    cfg = TrainConfig(batch_size=batch, max_boxes=MAX_BOXES, lr=LR,
                      grad_clip_norm=GRAD_CLIP)
    opt = make_optimizer(model.net.parameters(), schedule, cfg.momentum,
                         cfg.weight_decay, cfg.grad_clip_norm)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    if on_step is not None:
        on_step(0, model.net)
    logged = []
    t0 = time.perf_counter()
    for it in range(steps):
        state, m = step(state, *batches[it % len(batches)])
        if on_step is not None:
            on_step(it + 1, model.net)
        if log_every and it % log_every == 0:
            logged.append((it, float(m["loss"])))
            log(f"it {it}: loss {logged[-1][1]:.3f} odm_c "
                f"{float(m['odm_loss_c']):.3f} npos "
                f"{float(m['num_pos_odm']):.0f}")
    final = float(m["loss"])
    logged.append((steps - 1, final))
    log(f"{steps} steps in {time.perf_counter() - t0:.0f}s, final loss "
        f"{final:.3f}")
    return logged


def train_from_scratch(seed: int, size: int, num_classes: int, steps: int,
                       batch: int, ds, schedule: Schedule,
                       device: DeviceLike = "cuda",
                       dtype: torch.dtype = torch.bfloat16,
                       mean: Sequence[float] = MEANS, log_every: int = 0,
                       on_step: Optional[Callable] = None,
                       log: Callable[[str], None] = print):
    """RefineDet``size`` (``num_classes``) from the weights of ``seed``,
    trained by ``train``; returns ``(model, logged)``, the train-phase
    model and ``train``'s logged losses."""
    model = build_refinedet("train", size, num_classes, dtype=dtype,
                            device=resolve_device(device), seed=seed)
    return model, train(model, ds, batch, steps, schedule, mean, log_every,
                        on_step, log)


def net_state(net) -> Dict[str, torch.Tensor]:
    """A detached CPU copy of ``net``'s state_dict."""
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def trained_state(seed: int, size: int, steps: int, batch: int, ds,
                  device: DeviceLike = "cuda",
                  cache_dir: Optional[str] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  log: Callable[[str], None] = print
                  ) -> Dict[str, torch.Tensor]:
    """The 2-class RefineDet``size`` of ``seed`` trained ``steps`` steps
    on ``ds`` at ``batch`` with the decay schedule (CPU state_dict), from
    the cache when it holds it, else trained and cached
    (``torch.save``)."""
    cache_dir = CACHE_DIR if cache_dir is None else cache_dir
    path = osp.join(cache_dir,
                    f"refinedet{size}_s{seed}_st{steps}_b{batch}.pt")
    if osp.exists(path):
        mtime = time.strftime("%Y-%m-%d %H:%M",
                              time.localtime(osp.getmtime(path)))
        # The cache is keyed on size/seed/steps/batch only: delete the
        # directory after a change to models/ or train/.
        log(f"seed {seed}: restored trained params from {path} (trained "
            f"{mtime}; cache is NOT code-versioned)")
        return torch.load(path, map_location="cpu")
    model, _ = train_from_scratch(seed, size, 2, steps, batch, ds,
                                  decay_schedule(steps), device, dtype,
                                  log=lambda line: log(f"seed {seed}: "
                                                       f"{line}"))
    state = net_state(model.net)
    os.makedirs(cache_dir, exist_ok=True)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return state


def ap_of(model, state: Optional[Mapping[str, torch.Tensor]], ds,
          mean: Sequence[float] = MEANS) -> Dict[str, float]:
    """Train-set ``{ap, ap50}`` of the test-phase ``model`` with ``state``
    loaded (strict; None keeps its weights): the port's Evaluator at
    ``nms_top_k=128`` with +1 areas (batches of 16, or of the whole set
    when it is smaller), and ``ds.evaluate_detections``."""
    ev = Evaluator(model, ds, DetectConfig(num_classes=model.num_classes),
                   BaseTransform(ds.size, mean),
                   batch_size=min(EVAL_BATCH, len(ds)),
                   nms_top_k=EVAL_NMS_TOP_K, log=lambda line: None)
    stats = ds.evaluate_detections(ev.run(state), None)
    return {"ap": float(stats[0]), "ap50": float(stats[1])}


def summarize(rows: Sequence[Mapping], base: str,
              keys: Optional[Sequence[str]] = None, width: int = 13,
              log: Callable[[str], None] = print) -> Dict:
    """Per arm and metric (ap, ap50), the mean ± std over ``rows`` (one
    ``{arm: {ap, ap50}}`` per seed; numpy, ddof 0) and of the deltas
    against the arm ``base``, printed in the JAX tools' layout."""
    keys = list(rows[0]) if keys is None else list(keys)
    out: Dict = {k: {} for k in keys}
    for metric in ("ap", "ap50"):
        ref = np.array([r[base][metric] for r in rows])
        for k in keys:
            v = np.array([r[k][metric] for r in rows])
            d = v - ref
            out[k][metric] = {"mean": float(v.mean()), "std": float(v.std()),
                              "delta_mean": float(d.mean()),
                              "delta_std": float(d.std())}
            log(f"{k:>{width}s}: {metric.upper():>4s} {v.mean():.4f} "
                f"+- {v.std():.4f}   delta vs {base} {d.mean():+.4f} "
                f"+- {d.std():.4f}")
    return out


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' launch counters (K1, the int8 conv, the
    activation quantize)."""
    return {"nms_sweep": nms_cuda.nms_sweep.launches,
            "int8_conv": int8_conv.int8_conv.launches,
            "int8_quantize": int8_conv.int8_quantize.launches}
