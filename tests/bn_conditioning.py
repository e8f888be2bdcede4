"""How far apart two float32 runs of a random-init BN train step land.

    JAX_PLATFORMS=cpu python tests/bn_conditioning.py

Prints, on the CPU (~3 min on 8 cores):

  1. RefineDet320-BN on ``test_torch_port_train``'s two batches, the
     setting of ``test_torch_port_bn.py``'s two-step test: the worst
     relative L2 difference of a parameter's update between the JAX
     package and the port, with torch's default thread count and with 3,
     and between the port's float32 and float64 steps;
  2. RefineDet512-BN on ``chip_smoke.py`` 8a's batch: the port's float32
     step with 8 threads against 3 (running statistics, updates,
     positives), which is why 8a compares card and CPU in float64.

Conv biases that feed a BN have a zero gradient and are left out.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import test_torch_port_bn as T  # noqa: E402
from test_torch_port_train import LR, STEP_CFG, _batch  # noqa: E402

from refinedet_tpu_torch.config import TrainConfig  # noqa: E402
from refinedet_tpu_torch.models import build_refinedet_bn  # noqa: E402
from refinedet_tpu_torch.tools.train_check import (  # noqa: E402
    biases_before_bn, one_step, separated_batch, update_rel_errors)
from refinedet_tpu_torch.train import (create_train_state,  # noqa: E402
                                       make_optimizer, make_train_step)


def worst(rel):
    name = max(rel, key=rel.get)
    return f"{rel[name]:.4f} ({name})"


def port_steps(dtype):
    """The port's two steps of the test's setting; states after each."""
    model = build_refinedet_bn("train", 320, T.NUM_CLASSES, device="cpu",
                               seed=0)
    model.net.to(dtype)
    opt = make_optimizer(model.net.parameters(), lambda t: LR,
                         grad_clip_norm=STEP_CFG["grad_clip_norm"])
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, opt, TrainConfig(**STEP_CFG))
    out = [{k: v.double().clone()
            for k, v in model.net.state_dict().items()}]
    for seed in (0, 1):
        images, *targets = _batch(seed)
        state, _ = step(state, torch.from_numpy(images).to(dtype),
                        *(torch.from_numpy(x) for x in targets))
        out.append({k: v.double().clone()
                    for k, v in model.net.state_dict().items()})
    return model, out


def moves(states, names):
    return [{k: s[k] - states[0][k] for k in names} for s in states[1:]]


def main():
    default = torch.get_num_threads()
    for threads in (default, 3):
        torch.set_num_threads(threads)
        start, steps, model, _ = T.bn_steps.__wrapped__()
        names = {k for k, _ in model.net.named_parameters()}
        names -= biases_before_bn(model.net)
        for n, got in enumerate(steps, 1):
            rel = update_rel_errors(
                {k: got["state"][k] - start[k] for k in names},
                {k: got["jax_state"][k] - start[k] for k in names})
            print(f"320-BN, JAX vs port, {threads} threads, step {n}: "
                  f"worst update {worst(rel)}", flush=True)
    torch.set_num_threads(default)
    model, f32 = port_steps(torch.float32)
    _, f64 = port_steps(torch.float64)
    names = {k for k, _ in model.net.named_parameters()}
    names -= biases_before_bn(model.net)
    for n, (a, b) in enumerate(zip(moves(f32, names), moves(f64, names)),
                               1):
        print(f"320-BN, port f32 vs f64, step {n}: worst update "
              f"{worst(update_rel_errors(a, b))}", flush=True)

    cfg = TrainConfig(max_boxes=60)
    model = build_refinedet_bn("train", 512, 2, device="cpu", seed=0)
    _, batch = separated_batch(model, 2, 60, 2, cfg.theta,
                               cfg.overlap_thresh)
    results = []
    for threads in (8, 3):
        torch.set_num_threads(threads)
        model = build_refinedet_bn("train", 512, 2, device="cpu", seed=0)
        metrics, ups = one_step(model, batch, cfg, lr=cfg.lr)
        results.append((metrics, ups, model.net.state_dict()))
    (m8, u8, s8), (m3, u3, s3) = results
    names = {k for k, _ in model.net.named_parameters()}
    names -= biases_before_bn(model.net)
    stats = max(float((s8[k] - s3[k]).abs().max() / s8[k].abs().max())
                for k in s8 if ".running_" in k)
    rel = update_rel_errors({k: u3[k] for k in names},
                            {k: u8[k] for k in names})
    print(f"512-BN, chip_smoke 8a's batch, port f32 at 8 vs 3 threads: "
          f"running statistics {stats:.3g} of max; worst update "
          f"{worst(rel)}; positives ARM {m8['num_pos_arm']:g}/"
          f"{m3['num_pos_arm']:g} ODM {m8['num_pos_odm']:g}/"
          f"{m3['num_pos_odm']:g}", flush=True)


if __name__ == "__main__":
    main()
