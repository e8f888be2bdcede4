"""21-class VOC end-to-end smoke through the port's real CLIs.

    python -m refinedet_tpu_torch.tools.smoke_voc_e2e [--max_epoch N]
        [--threshold F] [--skip_int8] [--ema_decay D] [--root DIR]
        [--device cuda]

The port of ``tools/smoke_voc_e2e.py``, with its flags and defaults plus
``--device`` (the card unless ``--device cpu``). It writes a synthetic
VOCdevkit of four classes coded by silhouette (``fixtures.
make_voc_dataset``: 2007 and 2012 trainval for training, the reference's
VOC0712 recipe, and 2007 test, all at 160 px), trains through ``python -m
refinedet_tpu_torch.train --dataset VOC --input_size 320`` (21 classes,
VOC means, ``SSDAugmentation``, the warmup schedule, checkpoints),
evaluates the final checkpoint through ``python -m
refinedet_tpu_torch.eval.cli_voc`` (no +1 areas, per-class result files,
11-point AP), and fails unless the mean AP over the four classes present
clears ``--threshold``. With ``--ema_decay`` above 0 it adds a pass that
evaluates the EMA weights (``--use_ema``); unless ``--skip_int8`` it
re-evaluates the checkpoint as the int8 PTQ twin (``--int8
--calib_images 16``) and fails if the mean-AP drop exceeds
``--int8_max_drop``. Each CLI runs through its ``main(argv)`` with the
JAX tool's arguments plus ``--device``.

The dataset is JPEG files read through cv2: the tool needs cv2 and stops
without it, so it runs where an image decoder is installed (the CPU with
``--device cpu``, or a card whose host has one). It prints the JAX tool's
lines, then one JSON line: per-class and mean AP, the EMA and int8
figures, the seconds of each pass, the check that failed (the line is
printed before the tool stops) and the hand-written kernels' launch
counts.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import time
from typing import Dict, List, Optional

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.eval import cli_voc
from refinedet_tpu_torch.tools import fixture_train as ft
from refinedet_tpu_torch.tools.fixtures import make_voc_dataset, need_cv2
from refinedet_tpu_torch.train import __main__ as train_cli

# Four classes coded by silhouette (filled rect, ellipse, triangle, thick
# cross): colour-coded classes are unlearnable through SSDAugmentation's
# hue jitter and channel shuffle, fine textures vanish in Expand's shrink.
CLASSES = ("aeroplane", "bicycle", "boat", "car")
FIXTURE_SIZE = 160


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--max_epoch", default=150, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--num_train", default=64, type=int)
    p.add_argument("--num_test", default=16, type=int)
    p.add_argument("--threshold", default=0.30, type=float,
                   help="min mean AP over the present classes")
    p.add_argument("--skip_int8", action="store_true",
                   help="skip the int8 re-evaluation pass")
    p.add_argument("--int8_max_drop", default=0.10, type=float,
                   help="max tolerated (bf16 - int8) mean-AP delta")
    p.add_argument("--root", default=None, help="reuse a fixture/workdir")
    p.add_argument("--seed", default=0, type=int,
                   help="training seed (init + augmentation stream), "
                        "handed to the train CLI; the fixture stays fixed")
    p.add_argument("--ema_decay", default=0.0, type=float,
                   help=">0: train with an EMA of the weights and add an "
                        "eval pass serving them (--use_ema)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def write_fixture(voc_root: str, num_train: int, num_test: int) -> None:
    """The JAX tool's three splits: 2007 and 2012 trainval (seeds 3 and
    4, half the training images each) and 2007 test (seed 77)."""
    half = num_train // 2
    for year, image_set, n, seed in (("2007", "trainval", half, 3),
                                     ("2012", "trainval", num_train - half, 4),
                                     ("2007", "test", num_test, 77)):
        make_voc_dataset(voc_root, year=year, image_set=image_set,
                         num_images=n, img_size=FIXTURE_SIZE, seed=seed,
                         classes=CLASSES, class_patterns=True)


def mean_present(aps: Dict[str, float]) -> float:
    return sum(aps[c] for c in CLASSES) / len(CLASSES)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)
    need_cv2("smoke_voc_e2e")
    device = ["--device", args.device]

    work = args.root or tempfile.mkdtemp(prefix="voc_e2e_")
    voc_root = osp.join(work, "VOCdevkit")
    if not osp.exists(osp.join(voc_root, "VOC2007")):
        write_fixture(voc_root, args.num_train, args.num_test)
    save = osp.join(work, "weights") + "/"
    seconds: Dict[str, float] = {}

    t0 = time.time()
    train_cli.main(["--dataset", "VOC", "--input_size", "320",
                    "--dataset_root", voc_root,
                    "--batch_size", str(args.batch_size),
                    "--lr", str(args.lr), "--grad_clip", "5.0",
                    "--max_epoch", str(args.max_epoch),
                    "--ema_decay", str(args.ema_decay),
                    "--seed", str(args.seed),
                    "--num_workers", "2", "--save_folder", save] + device)
    seconds["train"] = time.time() - t0
    ckpt = osp.join(save, "RefineDet320_VOC_epoches_final.pth")
    if not osp.exists(ckpt):
        raise RuntimeError(f"training left no final checkpoint: {ckpt}")

    def evaluate(folder: str, before: List[str] = (),
                 after: List[str] = ()) -> Dict[str, float]:
        return cli_voc.main(["--input_size", "320", "--voc_root", voc_root,
                             "--trained_model", ckpt,
                             "--batch_size", str(args.batch_size), *before,
                             "--save_folder", osp.join(work, folder) + "/",
                             *after, *device])

    t0 = time.time()
    aps = evaluate("eval")
    seconds["eval"] = time.time() - t0
    present = {c: float(aps[c]) for c in CLASSES}
    mean = mean_present(aps)
    print(f"VOC e2e: train {seconds['train']:.0f}s, eval "
          f"{seconds['eval']:.0f}s; per-class AP over present classes: "
          f"{ {k: round(v, 4) for k, v in present.items()} }")
    print(f"VOC e2e: mean AP (present classes) = {mean:.4f} "
          f"(threshold {args.threshold})")
    out = {"tool": "smoke_voc_e2e", "ap": present, "mean_ap": mean,
           "threshold": args.threshold, "ema": None, "int8": None,
           "seconds": seconds, "failed": None}

    def report(failed: Optional[str] = None) -> dict:
        # the JSON line holds what the run reached, a failed check too
        out.update(failed=failed, launches=ft.kernel_launches())
        print(json.dumps(out), flush=True)
        if failed:
            raise RuntimeError(failed)
        return out

    if mean < args.threshold:
        report(f"mean AP {mean:.4f} below {args.threshold}")

    if args.ema_decay > 0:
        # the same checkpoint; --use_ema evaluates its EMA weights
        t0 = time.time()
        aps_ema = evaluate("eval_ema", before=["--use_ema"])
        seconds["ema"] = time.time() - t0
        mean_ema = mean_present(aps_ema)
        out["ema"] = {"decay": args.ema_decay,
                      "ap": {c: float(aps_ema[c]) for c in CLASSES},
                      "mean_ap": mean_ema, "delta": mean_ema - mean}
        print(f"VOC e2e EMA(d={args.ema_decay}): eval {seconds['ema']:.0f}s; "
              f"mean AP (present) = {mean_ema:.4f}  "
              f"delta vs raw = {mean_ema - mean:+.4f}")

    if not args.skip_int8:
        # the int8 PTQ twin of the same trained checkpoint, through the
        # same CLI (p9999 activation statistics, the default quant_skip)
        t0 = time.time()
        aps8 = evaluate("eval_int8",
                        after=["--int8", "--calib_images", "16"])
        seconds["int8"] = time.time() - t0
        mean8 = mean_present(aps8)
        drop = mean - mean8
        out["int8"] = {"ap": {c: float(aps8[c]) for c in CLASSES},
                       "mean_ap": mean8, "drop": drop,
                       "max_drop": args.int8_max_drop}
        print(f"VOC e2e int8: eval {seconds['int8']:.0f}s; mean AP (present) "
              f"= {mean8:.4f}  delta vs bf16 = {drop:+.4f} "
              f"(max tolerated drop {args.int8_max_drop})")
        if drop > args.int8_max_drop:
            report(f"int8 mean-AP drop {drop:.4f} exceeds "
                   f"{args.int8_max_drop}")

    print("VOC e2e smoke PASSED")
    return report()


if __name__ == "__main__":
    main()
