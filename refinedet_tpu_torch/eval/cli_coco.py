"""COCO/SSDD evaluation CLI: ``python -m refinedet_tpu_torch.eval.cli_coco``.

Port of the JAX package's ``eval_refinedet_coco.py`` (the reference's
``eval_refinedet_coco.py``), with its flags and defaults plus ``--device``
(the card unless ``--device cpu``). Flow: checkpoint sweep over trained
epochs (or one ``--trained_model``) -> batched inference with per-class
NMS on the device (kernel K1 on the card) -> numpy COCOeval stats ->
ap_stats.json + best-epoch report + FPS/p50.

Reads the port's checkpoints (``train/checkpoints.py``), bare
reference-format ``.pth`` state_dicts, and the int8 files
``--save_quantized`` writes. ``--int8`` evaluates the int8 PTQ twin
(``quant/``): per checkpoint, calibration on ``--calib_images`` eval
images, then int8 trunk and TCB (the kernel ``csrc/int8_conv.cu`` on the
card), or a pre-quantized checkpoint as it is.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from refinedet_tpu_torch import config as C
from refinedet_tpu_torch.config import DetectConfig
from refinedet_tpu_torch.data import BaseTransform, COCODetection
from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.eval import Evaluator
from refinedet_tpu_torch.models import build_refinedet
from refinedet_tpu_torch.quant import (DEFAULT_QUANT_SKIP,
                                       accumulate_hessians,
                                       calib_batches_from_dataset,
                                       calibrate_amax, quantize_variables)
from refinedet_tpu_torch.quant.ptq import check_quantized_set
from refinedet_tpu_torch.utils.plot import plot_map

try:
    import cv2
except ImportError:  # a host without cv2 can still import the module
    cv2 = None

def add_int8_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' int8 flags, with their defaults."""
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 PTQ twin (refinedet_tpu_torch/"
                        "quant): per-checkpoint calibration on "
                        "--calib_images eval images, then int8 trunk/TCB "
                        "inference")
    p.add_argument("--calib_images", default=16, type=int)
    p.add_argument("--calib_act_stat", default="p9999",
                   choices=["amax", "p9999", "p999", "p99"],
                   help="activation clip point for int8 calibration")
    p.add_argument("--quant_skip", default=None,
                   help="comma-separated conv names kept bf16 under --int8 "
                        "(default: the early-VGG set, quant.DEFAULT_QUANT_"
                        "SKIP; pass '' to quantize everything)")
    p.add_argument("--bias_correct", action="store_true",
                   help="with --int8: fold the expected weight-rounding "
                        "output error into each quantized conv's bias "
                        "(DFQ-style, from the calibration input means)")
    p.add_argument("--weight_opt", default="none", choices=["none", "gptq"],
                   help="with --int8: weight rounding — round-to-nearest "
                        "(none) or the second-order GPTQ solver "
                        "(refinedet_tpu_torch/quant/gptq.py, needs the "
                        "calibration stream twice)")


def quant_skip_arg(text: Optional[str]) -> tuple:
    """``--quant_skip``: None is ``DEFAULT_QUANT_SKIP``, '' nothing."""
    if text is None:
        return DEFAULT_QUANT_SKIP
    return tuple(s for s in text.split(",") if s)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="RefineDet COCO/SSDD eval (PyTorch/CUDA port)")
    p.add_argument("--input_size", default="512", choices=["320", "512"])
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--image_set", default="test",
                   help="test / test_inshore / test_offshore")
    p.add_argument("--trained_model", default=None,
                   help="single checkpoint to evaluate")
    p.add_argument("--prefix", default="weights/",
                   help="checkpoint dir for --sweep")
    p.add_argument("--sweep", action="store_true",
                   help="evaluate the reference epoch schedule 200..295+final")
    p.add_argument("--save_folder", default="eval/")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--top_k", default=1000, type=int)
    p.add_argument("--keep_top_k", default=500, type=int)
    p.add_argument("--nms_top_k", default=0, type=int,
                   help="per-class pre-NMS candidate cap on the device "
                        "(default 0 = use --top_k, the reference's cap; "
                        "smaller trades recall for NMS speed)")
    p.add_argument("--confidence_threshold", default=0.01, type=float)
    p.add_argument("--nms_threshold", default=0.49, type=float)
    p.add_argument("--objectness_thre", default=0.01, type=float)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    add_int8_flags(p)
    p.add_argument("--save_quantized", default=None,
                   help="with --int8 --trained_model: save the calibrated "
                        "int8 state_dict (and its --quant_skip) as a torch "
                        "file here (restores without recalibration)")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA weights of a checkpoint from an "
                        "--ema_decay run instead of the raw weights")
    p.add_argument("--show_image", action="store_true",
                   help="write per-image PNGs with GT (green) vs "
                        "detections >= --vis_thres (red) to "
                        "<save_folder>/images (needs cv2; reference "
                        "eval_refinedet_coco.py:182-198,236-256)")
    p.add_argument("--vis_thres", default=0.3, type=float)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def draw_detections(dataset, all_boxes, out_dir, vis_thres=0.3):
    """GT (green) vs detections (red) overlays, one PNG per image."""
    if cv2 is None:
        raise RuntimeError("--show_image draws with cv2, which is not "
                           "installed")
    os.makedirs(out_dir, exist_ok=True)

    def clip_pts(vals, h, w):
        # clip before int(): degenerate detections can decode to values
        # beyond C-int range, which cv2 rejects
        x1, y1, x2, y2 = (float(np.nan_to_num(v)) for v in vals)
        return (int(np.clip(x1, 0, w - 1)), int(np.clip(y1, 0, h - 1)),
                int(np.clip(x2, 0, w - 1)), int(np.clip(y2, 0, h - 1)))

    for i in range(len(dataset)):
        img, gt = dataset.pull_image(i)
        img = img.copy()
        h, w = img.shape[:2]
        for row in gt:
            x1, y1, x2, y2 = clip_pts(row[:4], h, w)
            cv2.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 1)
        for cls_dets in all_boxes[1:]:
            for det in cls_dets[i]:
                if det[4] < vis_thres:
                    continue
                x1, y1, x2, y2 = clip_pts(det[:4], h, w)
                cv2.rectangle(img, (x1, y1), (x2, y2), (0, 0, 255), 1)
                cv2.putText(img, f"{det[4]:.2f}", (x1, max(y1 - 3, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.35, (0, 0, 255), 1)
        cv2.imwrite(osp.join(out_dir, f"{i:06d}.png"), img)


def make_loader(use_ema: bool = False
                ) -> Callable[[str], Dict[str, torch.Tensor]]:
    """Returns ``load_fn(path)`` -> a state_dict of the network, from

    * a port checkpoint (``train/checkpoints.py``: ``model``, and with
      ``use_ema`` its ``ema`` over the weights, which raises when the
      checkpoint carries none rather than silently falling back);
    * a bare reference-key ``.pth`` state_dict (or one under
      ``state_dict``), ``module.`` prefixes stripped.

    ``Evaluator.run(state)`` strict-loads it.
    """

    def load(path):
        path = str(path)
        if osp.isdir(path):
            raise ValueError(
                f"{path} is a directory, as an Orbax checkpoint of the JAX "
                "package is: the port reads torch checkpoints (.pth). "
                "Convert JAX weights with refinedet_tpu_torch.models."
                "convert.state_dict_from_flax and torch.save the result.")
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "model" in obj:
            state = dict(obj["model"])
            if use_ema:
                if obj.get("ema") is None:
                    raise ValueError(
                        f"--use_ema: checkpoint {path} has no EMA weights "
                        "(train with --ema_decay > 0)")
                state.update(obj["ema"])
        else:
            if use_ema:
                raise ValueError(
                    f"--use_ema: {path} is a bare state_dict with no EMA "
                    "weights; --use_ema needs a training checkpoint")
            if isinstance(obj, dict) and "state_dict" in obj:
                obj = obj["state_dict"]
            state = {k[len("module."):] if k.startswith("module.") else k: v
                     for k, v in obj.items()}
        return state

    return load


def int8_loader(load_f32: Callable, model, model_q, dataset, transform,
                args: argparse.Namespace) -> Callable:
    """``load_fn(path)`` -> the int8 twin's state_dict, as the JAX CLI
    makes it: a pre-quantized checkpoint (``--save_quantized``) as it is,
    after checking its quantized convs against ``--quant_skip``; any other
    is loaded into the float ``model``, calibrated on ``--calib_images``
    images of ``dataset`` and quantized with the int8 flags."""

    def load(path):
        state = load_f32(path)
        if any(k.endswith(".kernel_q") for k in state):
            check_quantized_set(state, model_q, str(path))
            print("restored pre-quantized checkpoint; --calib_images/"
                  "--calib_act_stat are ignored (scales were baked in at "
                  "--save_quantized time)")
            return state
        model.net.load_state_dict(state, strict=True)
        calib = calib_batches_from_dataset(dataset, transform,
                                           args.calib_images,
                                           args.batch_size)
        if args.weight_opt == "gptq":
            calib = list(calib)  # the Hessian pass re-consumes the stream
        means = None
        if args.bias_correct:
            amax, means = calibrate_amax(model, calib, return_means=True)
        else:
            amax = calibrate_amax(model, calib)
        hessians = None
        if args.weight_opt == "gptq":
            hessians = accumulate_hessians(model, calib)
        return quantize_variables(model_q, model.net.state_dict(), amax,
                                  act_stat=args.calib_act_stat, means=means,
                                  hessians=hessians)

    return load


def sweep_checkpoints(prefix: str, size: int):
    """The reference epoch schedule (eval_refinedet_coco.py:328-336):
    (paths, epochs) of the checkpoints that exist, printing each epoch
    swept and each one MISSING."""
    epochs = list(range(200, 300, 5))
    ckpts = [osp.join(prefix, f"RefineDet{size}_COCO_epoches_{e}")
             for e in epochs]
    ckpts.append(osp.join(prefix, f"RefineDet{size}_COCO_epoches_final"))
    epochs.append(300)
    paths, found = [], []
    for c, e in zip(ckpts, epochs):
        # port checkpoints end in .pth; a bare directory of that name is
        # an Orbax checkpoint, which the loader refuses with a reason
        path = c + ".pth" if osp.exists(c + ".pth") else c
        if osp.exists(path):
            print(f"sweep: epoch {e}: {c}")
            paths.append(path)
            found.append(e)
    for c, e in zip(ckpts, epochs):
        if e not in found:
            print(f"sweep: epoch {e}: MISSING ({c}[.pth]) — skipped")
    return paths, found


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    size = int(args.input_size)
    root = args.dataset_root or C.COCOroot
    dataset = COCODetection(root, [("sarship", args.image_set)], None)
    num_classes = dataset.num_classes

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_refinedet("test", size, num_classes, dtype=dtype,
                            device=device)
    cfg = DetectConfig(
        num_classes=num_classes, top_k=args.top_k,
        keep_top_k=args.keep_top_k, conf_thresh=args.confidence_threshold,
        nms_thresh=args.nms_threshold,
        objectness_thresh=args.objectness_thre)
    load_fn = make_loader(use_ema=args.use_ema)
    eval_model = model
    if args.int8:
        eval_model = build_refinedet("test", size, num_classes, dtype=dtype,
                                     device=device, quant=True,
                                     quant_skip=quant_skip_arg(
                                         args.quant_skip))
        load_fn = int8_loader(load_fn, model, eval_model, dataset,
                              BaseTransform(size, C.MEANS), args)
    evaluator = Evaluator(eval_model, dataset, cfg,
                          BaseTransform(size, C.MEANS),
                          batch_size=args.batch_size,
                          nms_top_k=args.nms_top_k,
                          max_per_image=args.keep_top_k)
    save_folder = osp.join(args.save_folder,
                           osp.basename(args.prefix.rstrip("/")))

    if args.sweep:
        ckpts, epochs = sweep_checkpoints(args.prefix, size)
        stats = evaluator.sweep(ckpts, load_fn, epochs, save_folder)
        if stats["epoch"]:
            plot_map(osp.join(save_folder, "ap_stats.json"),
                     osp.join(save_folder, "ap_curve.png"))
        return stats
    if not args.trained_model:
        raise SystemExit("--trained_model or --sweep required")
    state = load_fn(args.trained_model)
    print("Finished loading model!")
    if args.int8 and args.save_quantized:
        torch.save({"model": state,
                    "quant_skip": list(quant_skip_arg(args.quant_skip))},
                   args.save_quantized)
        print(f"quantized variables saved -> {args.save_quantized}")
    all_boxes = evaluator.run(state)
    if args.show_image:
        draw_detections(dataset, all_boxes, osp.join(save_folder, "images"),
                        args.vis_thres)
    print("Evaluating detections")
    stats = dataset.evaluate_detections(all_boxes, save_folder)
    print("AP stats:", np.round(stats[:6], 4))
    return stats


if __name__ == "__main__":
    main()
