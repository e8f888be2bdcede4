"""Readings that set the limits of a cell's comparison, on the card.

    python3 -m portbench.control --workload NAME --seeds S1 S2 S3 ...

For each seed, the cell's own inputs and weights (as its run makes them)
and the numbers the comparison gives for:

  * ``control``: the precision below the configuration's in the
    program's place. The bfloat16 detection cell: the program's own int8
    twin (PTQ on the pool's first images, default ``quant_skip``), with
    ``fp8`` beside it, the reference with every convolution's input and
    weight in float8 e4m3. The bfloat16 train cell, for which the program
    has no lower-precision path: the reference in fp8 (in training the
    convolutions' gradients in e5m2). The int8 cell: the reference at
    int4 (activations and weights on +/-7);
  * the faults the cell can have, planted in what the program produced
    (detection) or in the reference put in its place (training):
    ``half_left_out`` (the second half of each batch's rows zeroed; in
    training, the step on the first half of the batch, its mean over
    those rows), ``answer_altered`` (every box moved right by 2% of the
    image) and, for training, ``state_unchanged`` (steps that leave the
    weights as they were and give the optimizer nothing);
  * ``sound``: the program as the window runs it (detection: every pool
    batch once, through the same artifact).

Each line of output is one JSON object: workload, seed, case, numbers.
The benchmark's own runs never run this; ``tests/test_control.py`` runs
it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, judge, serving

DETECT_INT8 = {"quant_skip": ["vgg_conv1_2", "vgg_conv2_1"],
               "calib_images": 16, "calib_batch": 4}


def ctx_for(workload: str, seed: int, overrides: dict = None) -> harness.Ctx:
    bench = harness.benchmark()
    cell = harness.cell(bench, workload)
    cfg = harness.load_json(harness.config_path(cell["config"]))
    tf = harness.load_json(harness.traffic_path(cell["traffic"]))
    tf.update(overrides or {})
    return harness.Ctx(workload, seed, 0.0, False, cfg, tf,
                       harness.load_json(harness.limits_path(workload)),
                       torch.device("cuda", 0), time.perf_counter())


def train_readings(ctx: harness.Ctx) -> dict:
    train = harness.load_module(harness.driver_path("train"), "train_drv")
    inp = train.inputs(ctx)
    steps = ctx.traffic["check_steps"]
    ref = train.reference_steps(ctx, inp, steps)

    def gaps(other):
        return judge.train_gaps(other["losses"], ref["losses"],
                                other["grad"], ref["grad"], other["delta"],
                                ref["delta"])

    return {
        "control": gaps(train.reference_steps(ctx, inp, steps,
                                              emulate="fp8")),
        "half_left_out": gaps(train.reference_steps(
            ctx, inp, steps, rows=inp["batch"] // 2)),
        "state_unchanged": gaps(train.reference_steps(ctx, inp, steps,
                                                      frozen=True)),
    }


def serve_batches(art, host, b: int):
    """The artifact's rows of every pool batch of ``b`` images."""
    return torch.cat([torch.from_numpy(art(host[i:i + b]))
                      for i in range(0, host.shape[0], b)])


def detect_readings(ctx: harness.Ctx) -> dict:
    cfg, tf = ctx.cfg, ctx.traffic
    int8 = bool(tf.get("int8", False))
    b = tf.get("batch", tf.get("max_batch"))
    inp = serving.pool(ctx)
    art = serving.artifact(ctx, inp, int8, [b])
    sound = serve_batches(art, inp["host"], b)
    del art
    out = {}
    if not int8:
        art = serving.artifact(ctx, inp, True, [b])
        control = serve_batches(art, inp["host"], b)
        del art
    torch.cuda.empty_cache()
    ref = serving.reference(ctx, inp, int8)["dets"]
    if int8:
        control = serving.reference(ctx, inp, True, levels=7)["dets"]
    else:
        out["fp8"] = serving.judge_rows(ctx, serving.reference(
            ctx, inp, False, emulate="fp8")["dets"], ref)
    half = sound.clone().view(-1, b, *sound.shape[1:])
    half[:, b // 2:] = 0.0
    moved = sound.clone()
    moved[..., 0:4:2] += torch.where(moved[..., 4:5] > 0, 0.02, 0.0)
    out.update(sound=serving.judge_rows(ctx, sound, ref),
               control=serving.judge_rows(ctx, control, ref),
               half_left_out=serving.judge_rows(ctx, half.flatten(0, 1), ref),
               answer_altered=serving.judge_rows(ctx, moved, ref))
    return out


def readings(workload: str, seed: int, overrides: dict = None) -> dict:
    ctx = ctx_for(workload, seed, overrides)
    if ctx.traffic["driver"] == "train":
        return train_readings(ctx)
    if not ctx.traffic.get("int8"):
        ctx.traffic = dict(DETECT_INT8, **ctx.traffic)
    return detect_readings(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for case, numbers in readings(args.workload, seed).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "case": case, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
