"""VOC2007-test evaluation CLI: ``python -m refinedet_tpu_torch.eval.cli_voc``.

Port of the JAX package's ``eval_refinedet_voc.py`` (the reference's
``eval_refinedet_voc.py``), with its flags and defaults plus ``--device``
(the card unless ``--device cpu``): batched inference with per-class NMS
on the device (kernel K1 on the card; no +1 area convention, as the
reference's VOC path ran the torch NMS), the official per-class result
files, and 11-point (or AUC) AP through ``eval/voc_eval.py``. ``--int8``
evaluates the int8 PTQ twin, calibrated on ``--calib_images`` eval images
through ``quant.quantize_model``.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import List, Optional

import torch

from refinedet_tpu_torch import config as C
from refinedet_tpu_torch.config import DetectConfig
from refinedet_tpu_torch.data import BaseTransform, VOC_CLASSES, VOCDetection
from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.eval import (Evaluator, evaluate_voc,
                                      write_voc_results_files)
from refinedet_tpu_torch.eval.cli_coco import (add_int8_flags, make_loader,
                                               quant_skip_arg)
from refinedet_tpu_torch.models import build_refinedet
from refinedet_tpu_torch.quant import (calib_batches_from_dataset,
                                       quantize_model)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="RefineDet VOC eval (PyTorch/CUDA port)")
    p.add_argument("--input_size", default="320", choices=["320", "512"])
    p.add_argument("--trained_model", required=True)
    p.add_argument("--voc_root", default=None)
    p.add_argument("--year", default="2007")
    p.add_argument("--image_set", default="test")
    p.add_argument("--save_folder", default="eval/")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--confidence_threshold", default=0.01, type=float)
    p.add_argument("--nms_threshold", default=0.45, type=float)
    p.add_argument("--objectness_thre", default=0.01, type=float)
    p.add_argument("--top_k", default=1000, type=int)
    p.add_argument("--nms_top_k", default=300, type=int)
    p.add_argument("--det_shift", default=1.0, type=float,
                   help="detection-coordinate offset applied during AP "
                        "matching; 1.0 (default) reproduces the "
                        "reference chain's 1-based-result-file vs "
                        "0-based-GT quirk exactly, 0.0 evaluates "
                        "geometrically aligned")
    p.add_argument("--use_07_metric", default=True,
                   type=lambda v: v.lower() not in ("0", "false", "no"),
                   help="11-point VOC2007 AP (true) or every-point AUC AP "
                        "(false)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    add_int8_flags(p)
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA weights of a checkpoint from an "
                        "--ema_decay run instead of the raw weights")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    size = int(args.input_size)
    root = args.voc_root or C.VOC_ROOT
    dataset = VOCDetection(root, [(args.year, args.image_set)], None)
    num_classes = len(VOC_CLASSES) + 1

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_refinedet("test", size, num_classes, dtype=dtype,
                            device=device)
    cfg = DetectConfig(
        num_classes=num_classes, top_k=args.top_k, keep_top_k=args.top_k,
        conf_thresh=args.confidence_threshold,
        nms_thresh=args.nms_threshold,
        objectness_thresh=args.objectness_thre)
    state = make_loader(use_ema=args.use_ema)(args.trained_model)
    eval_model = model
    if args.int8:
        model.net.load_state_dict(state, strict=True)
        eval_model, state = quantize_model(
            model, calib_batches_from_dataset(
                dataset, BaseTransform(size, C.VOC_MEANS),
                args.calib_images, args.batch_size),
            dtype=dtype, act_stat=args.calib_act_stat,
            quant_skip=quant_skip_arg(args.quant_skip),
            bias_correct=args.bias_correct, weight_opt=args.weight_opt)
    # The reference VOC path ran the torch NMS (no +1 area convention,
    # box_utils.py:241), unlike the COCO path's C/CUDA NMS.
    evaluator = Evaluator(eval_model, dataset, cfg,
                          BaseTransform(size, C.VOC_MEANS),
                          batch_size=args.batch_size,
                          nms_top_k=args.nms_top_k, plus_one=False)
    print("Finished loading model!")
    all_boxes = evaluator.run(state)

    out_dir = osp.join(args.save_folder, f"voc{args.year}")
    write_voc_results_files(
        all_boxes, [i[1] for i in dataset.ids], VOC_CLASSES, out_dir)
    aps = evaluate_voc(all_boxes, dataset, VOC_CLASSES,
                       use_07_metric=args.use_07_metric,
                       det_shift=args.det_shift)
    # det_shift printed so logs are self-describing: 1.0 reproduces the
    # reference chain's 1-based-result-file vs 0-based-GT offset
    # (eval_refinedet_voc.py:160-162,117-120); --det_shift 0 opts out.
    print(f"mAP: {aps['mAP']:.4f} (det_shift={args.det_shift})")
    return aps


if __name__ == "__main__":
    main()
