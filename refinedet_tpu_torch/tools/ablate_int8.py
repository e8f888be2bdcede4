"""Multi-seed int8 PTQ accuracy ablation on the card.

    python -m refinedet_tpu_torch.tools.ablate_int8 --size 320 --seeds 5 \\
        --steps 2500
    python -m refinedet_tpu_torch.tools.ablate_int8 --size 512 --seeds 5 \\
        --steps 2000

The port of ``tools/ablate_int8.py``. For each seed (a fresh 64-image
fixture, ``fixtures.coco_fixture(64, seed)``, and fresh weights of the
seed): train RefineDet from scratch on 4 rotating batches of 16 (bf16,
the decay schedule), then score the train set served as

  bf16              the baseline;
  int8-default      ``DEFAULT_QUANT_SKIP`` (early VGG convs kept bf16);
  int8-full         every quantizable conv quantized;
  *-bc              plus DFQ-style bias correction from the calibration
                    means;
  *-gptq            plus GPTQ weight rounding (Hessians from the same
                    calibration stream);
  noise-ctl-*       bf16 with weight noise matched to the int8 step on
                    exactly the convs the matching int8 arm quantizes
                    (the fixture's own sensitivity to perturbation);

and print mean ± std over seeds and the deltas against bf16 per arm.

Noise controls draw as JAX draws (``noise_params``, :160-173): the flax
names in flax order (sorted, as ``jax.device_get`` returns the trained
tree), ``uniform(-0.5, 0.5)`` in the HWIO shape, the per-output-channel
max over HWI; the perturbed HWIO weight goes back to OIHW through
``models/convert.py``'s name map, so a seed perturbs the same weights by
the same bits in both packages. One calibration pass (16 images) feeds
every int8 arm: the amax, the means for bias correction and the Hessians
for GPTQ, with one ``gptq_cache`` per seed.

Trained weights are cached (``torch.save`` of the state_dict) per (size,
seed, steps, batch) under ``fixture_train.CACHE_DIR``; a JSON sidecar
there resumes a cut run per seed and per arm. ``--configs`` picks a
subset of arms (bf16 always runs: it is the delta base). An arm that
raises fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence)

import numpy as np
import torch

from refinedet_tpu_torch.device import DeviceLike, resolve_device
from refinedet_tpu_torch.models.builder import build_refinedet
from refinedet_tpu_torch.models.convert import module_names
from refinedet_tpu_torch.quant import DEFAULT_QUANT_SKIP, calibrate_amax, \
    quantize_variables
from refinedet_tpu_torch.quant.gptq import accumulate_hessians
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.fixtures import coco_fixture

N_IMAGES, CALIB_IMAGES = 64, 16


def resolve_quant_skip(skip):
    """An ``INT8_CONFIGS`` skip entry as ``build_refinedet``'s
    ``quant_skip``: None (the default arms) is ``DEFAULT_QUANT_SKIP``,
    since ``build_refinedet``'s own default, (), quantizes everything."""
    return DEFAULT_QUANT_SKIP if skip is None else skip


# tag -> (quant_skip or None for the default, bias_correct, gptq)
INT8_CONFIGS = {
    "int8-default": (None, False, False),
    "int8-default-bc": (None, True, False),
    "int8-default-gptq": (None, False, True),
    "int8-default-gptq-bc": (None, True, True),
    "int8-full": ((), False, False),
    "int8-full-bc": ((), True, False),
    "int8-full-gptq": ((), False, True),
    "int8-full-gptq-bc": ((), True, True),
}
ALL_CONFIGS = ("bf16", "noise-ctl-default", "noise-ctl-full",
               *INT8_CONFIGS)
NOISE_SKIP = {"noise-ctl-default": DEFAULT_QUANT_SKIP, "noise-ctl-full": ()}


def noise_state(state: Mapping[str, torch.Tensor], seed: int,
                extra_skip: Sequence[str], use_bn: bool = False,
                num_sources: int = 4) -> Dict[str, torch.Tensor]:
    """``state`` with every conv the matching int8 arm quantizes
    perturbed by uniform noise of one int8 step of its output channel,
    drawn from ``RandomState(seed)`` as ``noise_params`` draws."""
    rng = np.random.RandomState(seed)
    out = dict(state)
    names = module_names(use_bn, num_sources)
    for name in sorted(names):
        path, kind = names[name]
        if kind != "conv" or name.startswith(("arm_", "odm_")) \
                or name == "vgg_conv1_1" or name in extra_skip:
            continue
        w = np.ascontiguousarray(np.transpose(
            state[path + ".weight"].detach().cpu().float().numpy(),
            (2, 3, 1, 0)))  # HWIO
        s = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
        w = w + rng.uniform(-0.5, 0.5, w.shape).astype(np.float32) * s
        out[path + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    return out


def score_arms(state: Mapping[str, torch.Tensor], ds, size: int,
               configs: Iterable[str], seed: int,
               device: DeviceLike = "cuda",
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Dict]:
    """``{arm: {ap, ap50}}`` of the trained 2-class ``state`` served as
    each arm of ``configs`` on ``ds``, in ``ALL_CONFIGS``' order; the
    float arms and the int8 twins' unquantized layers in ``dtype``."""
    dev = resolve_device(device)
    configs = set(configs)
    unknown = configs - set(ALL_CONFIGS)
    if unknown:
        raise ValueError(f"unknown configs: {sorted(unknown)}")
    model = build_refinedet("test", size, 2, dtype=dtype, device=dev)
    out = {}
    if "bf16" in configs:
        out["bf16"] = ft.ap_of(model, state, ds)
    for tag, skip in NOISE_SKIP.items():
        if tag in configs:
            out[tag] = ft.ap_of(model, noise_state(state, seed, skip), ds)
    int8_arms = [(t, *INT8_CONFIGS[t]) for t in INT8_CONFIGS if t in configs]
    if not int8_arms:
        return out
    model.net.load_state_dict(state, strict=True)
    calib = [ft.eval_images(ds, min(CALIB_IMAGES, len(ds)))]
    amax, means = calibrate_amax(model, calib, return_means=True)
    hessians = None
    if any(gptq for _, _, _, gptq in int8_arms):
        hessians = accumulate_hessians(model, calib)
    # One GPTQ solve per conv: the arms share weights and calibration.
    gptq_cache: Dict = {}
    del model
    for tag, skip, bc, gptq in int8_arms:
        mq = build_refinedet("test", size, 2, dtype=dtype,
                             device=dev, quant=True,
                             quant_skip=resolve_quant_skip(skip))
        sq = quantize_variables(mq, state, amax,
                                means=means if bc else None,
                                hessians=hessians if gptq else None,
                                gptq_cache=gptq_cache)
        out[tag] = ft.ap_of(mq, sq, ds)
        del mq
    return out


def run_seed(seed: int, size: int, steps: int, batch: int,
             configs: Iterable[str], have: Iterable[str] = (),
             device: DeviceLike = "cuda",
             cache_dir: Optional[str] = None,
             dtype: torch.dtype = torch.bfloat16, n_images: int = N_IMAGES,
             log: Callable[[str], None] = print) -> Dict[str, Dict]:
    """Train (or restore) seed ``seed`` on its ``n_images`` fixture and
    score the arms of ``configs`` not in ``have`` (the sidecar's results
    for this seed)."""
    dev = resolve_device(device)
    ds = coco_fixture(n_images, seed, size, dev)
    state = ft.trained_state(seed, size, steps, batch, ds, dev, cache_dir,
                             dtype, log)
    out = score_arms(state, ds, size, set(configs) - set(have), seed, dev,
                     dtype)
    log(f"seed {seed}: " + "  ".join(
        f"{k}={v['ap']:.4f}/{v['ap50']:.4f}" for k, v in out.items()))
    return out


def run_seeds(seeds: Iterable[int], size: int, steps: int, batch: int,
              configs: Iterable[str], device: DeviceLike = "cuda",
              cache_dir: Optional[str] = None,
              dtype: torch.dtype = torch.bfloat16, n_images: int = N_IMAGES,
              log: Callable[[str], None] = print) -> List[Dict]:
    """``run_seed`` over ``seeds``, one row each, through the JSON sidecar
    in ``cache_dir``: a seed whose arms it holds is not run again, and a
    seed's new arms are written as soon as they are scored."""
    cache_dir = ft.CACHE_DIR if cache_dir is None else cache_dir
    configs = set(configs)
    res_path = osp.join(cache_dir,
                        f"results_{size}_st{steps}_b{batch}.json")
    done = {}
    if osp.exists(res_path):
        with open(res_path) as f:
            done = json.load(f)
    rows = []
    for s in seeds:
        cached = done.get(str(s))
        if cached is not None and configs <= set(cached):
            log(f"seed {s}: restored results from {res_path}")
            rows.append(cached)
            continue
        out = run_seed(s, size, steps, batch, configs,
                       have=set(cached or {}), device=device,
                       cache_dir=cache_dir, dtype=dtype, n_images=n_images,
                       log=log)
        done[str(s)] = {**(cached or {}), **out}
        os.makedirs(cache_dir, exist_ok=True)
        with open(res_path, "w") as f:
            json.dump(done, f, indent=1)
        rows.append(done[str(s)])
    return rows


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", default=320, type=int, choices=(320, 512))
    p.add_argument("--seeds", default=5, type=int)
    p.add_argument("--steps", default=2500, type=int)
    p.add_argument("--batch", default=16, type=int)
    p.add_argument("--configs", default="all",
                   help="comma-separated subset of serving arms "
                        f"({','.join(ALL_CONFIGS)}); bf16 always runs "
                        "(it is the delta base)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.configs == "all":
        configs = set(ALL_CONFIGS)
    else:
        configs = {c for c in args.configs.split(",") if c}
        unknown = configs - set(ALL_CONFIGS)
        if unknown:
            p.error(f"unknown configs: {sorted(unknown)}")
        configs.add("bf16")
    rows = run_seeds(range(args.seeds), args.size, args.steps, args.batch,
                     configs, resolve_device(args.device))
    keys = [k for k in ALL_CONFIGS if k in configs]
    print(f"\n== int8 ablation, RefineDet{args.size}, {args.seeds} seeds, "
          f"{args.steps} steps ==", flush=True)
    summary = ft.summarize(rows, "bf16", keys)
    print(json.dumps({"tool": "ablate_int8", "size": args.size,
                      "seeds": args.seeds, "steps": args.steps,
                      "batch": args.batch, "summary": summary,
                      "launches": ft.kernel_launches()}), flush=True)
    return {"rows": rows, "summary": summary}


if __name__ == "__main__":
    main()
