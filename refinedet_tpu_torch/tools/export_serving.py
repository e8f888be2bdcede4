"""Export a checkpoint for deployment:
``python -m refinedet_tpu_torch.tools.export_serving``.

The port's counterpart of the JAX package's ``tools/export_serving.py``,
with its flags. Two targets, one CLI:

  serving  — a serving artifact (``serve/export.py:save_serving``): the
             whole inference function through ``torch.export``, weights
             inside, K1 as the op ``refinedet_tpu_torch::nms_sweep``; the
             serving host needs torch and ``refinedet_tpu_torch.ops``, no
             model class. Symbolic batch by default. One program per
             ``--platforms`` entry (``cuda,cpu`` by default, as the JAX
             exporter's ``tpu,cpu`` with the card for the TPU), each with
             its own copy of the weights; the loader takes the one of the
             device it is asked for.
  torch    — the reference-named ``state_dict`` as a ``.pth`` the reference
             nets strict-load (the EMA weights with ``--use_ema``).

Checkpoints are read as the eval CLIs read them
(``eval/cli_coco.py:make_loader``): a port training checkpoint or a bare
reference-key ``.pth``. ``--int8`` exports the int8 PTQ twin from a
pre-quantized checkpoint (written by ``python -m
refinedet_tpu_torch.eval.cli_coco --int8 --save_quantized``), whose
quantized convs must match ``--quant_skip``; each quantized conv is the op
``refinedet_tpu_torch::int8_conv`` in the artifact.

Examples::

  python -m refinedet_tpu_torch.tools.export_serving --checkpoint \\
      weights/RefineDet320_COCO_epoches_final.pth --input_size 320 \\
      --num_classes 2 --fused_nms --out refinedet320.rdtpu
  python -m refinedet_tpu_torch.tools.export_serving --int8 \\
      --checkpoint refinedet320_int8.pth --input_size 320 --num_classes 21 \\
      --fused_nms --out refinedet320_int8.rdtpu
  python -m refinedet_tpu_torch.tools.export_serving --format torch \\
      --checkpoint ... --out refinedet320.pth
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from refinedet_tpu_torch.eval.cli_coco import make_loader, quant_skip_arg
from refinedet_tpu_torch.models import build_refinedet
from refinedet_tpu_torch.quant.ptq import check_quantized_set
from refinedet_tpu_torch.serve.export import check_platforms, save_serving


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--format", choices=("serving", "torch"),
                   default="serving")
    p.add_argument("--checkpoint", required=True,
                   help="port training checkpoint or reference .pth")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--input_size", type=int, default=320,
                   choices=(320, 512, 896))
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--bn", action="store_true", help="BN variant")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="compute dtype of the artifact (the eval CLIs' "
                        "serving default)")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA weights of a training checkpoint "
                        "(an --ema_decay run) instead of the raw ones")
    p.add_argument("--int8", action="store_true",
                   help="serving: export the int8 PTQ twin from a "
                        "PRE-QUANTIZED checkpoint (written by python -m "
                        "refinedet_tpu_torch.eval.cli_coco --int8 "
                        "--save_quantized)")
    p.add_argument("--quant_skip", default=None,
                   help="with --int8: conv names kept bf16, matching the "
                        "checkpoint's set (default: quant.DEFAULT_QUANT_SKIP)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="serving: fixed batch; 0 = symbolic (any batch)")
    p.add_argument("--device", default="cuda",
                   help="the device the checkpoint is loaded and checked "
                        "on (default the card)")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="serving: comma-separated device types to write a "
                        "program for (cuda, cpu); the file holds the "
                        "weights once per platform")
    p.add_argument("--fused_nms", action="store_true",
                   help="serving: decode + per-class NMS (K1 on the card) "
                        "+ compaction inside the artifact; output dets[b, "
                        "C-1, K, 5] instead of raw (boxes, scores)")
    # None = the library defaults (DetectConfig.nms_thresh 0.49 etc.), so
    # a flagless export reproduces the Evaluator; only values the user
    # set are passed on.
    p.add_argument("--nms_top_k", type=int, default=None,
                   help="with --fused_nms: per-class survivors kept "
                        "(default 200)")
    p.add_argument("--nms_threshold", type=float, default=None,
                   help="default: DetectConfig.nms_thresh (0.49, COCO "
                        "eval); the VOC eval path uses 0.45")
    p.add_argument("--confidence_threshold", type=float, default=None,
                   help="default: DetectConfig.conf_thresh")
    p.add_argument("--uint8_wire", action="store_true",
                   help="serving: the artifact takes raw uint8 RGB pixels "
                        "and mean-subtracts on the device (4x less "
                        "host->device traffic, exact for integer pixels)")
    p.add_argument("--input_mean", default=None,
                   help="with --uint8_wire: comma-separated per-channel "
                        "mean in the reference's BGR convention (default "
                        "104,117,123; SAR/SSDD uses "
                        "98.13131,98.13131,98.13131)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.int8 and args.format == "torch":
        raise SystemExit("--int8 applies to --format serving only "
                         "(the reference stack has no int8 path)")
    platforms = None
    if args.format == "serving":
        try:
            platforms = check_platforms(
                s.strip() for s in args.platforms.split(","))
        except ValueError as e:
            raise SystemExit(f"--platforms: {e}") from None
    state = make_loader(use_ema=args.use_ema)(args.checkpoint)
    if args.int8 and not any(k.endswith(".kernel_q") for k in state):
        raise SystemExit(
            f"--int8: {args.checkpoint} holds no quantized convs; write one "
            "with python -m refinedet_tpu_torch.eval.cli_coco --int8 "
            "--save_quantized first")

    if args.format == "torch":
        # Strict-load into the network the flags name, so a checkpoint of
        # another variant or class count is refused here.
        net = build_refinedet("train", args.input_size, args.num_classes,
                              use_bn=args.bn, device="cpu").net
        net.load_state_dict(state, strict=True)
        torch.save({k: v.detach().clone().contiguous()
                    for k, v in net.state_dict().items()}, args.out)
        print(f"wrote reference-loadable state_dict: {args.out}")
        return

    fused = None
    if args.fused_nms:
        fused = {k: v for k, v in (
            ("nms_thresh", args.nms_threshold),
            ("conf_thresh", args.confidence_threshold),
            ("nms_top_k", args.nms_top_k)) if v is not None}
    mean = None
    if args.input_mean is not None:
        if not args.uint8_wire:
            raise SystemExit("--input_mean requires --uint8_wire")
        mean = tuple(float(s) for s in args.input_mean.split(","))
    model = build_refinedet("test", args.input_size, args.num_classes,
                            use_bn=args.bn, dtype=getattr(torch, args.dtype),
                            device=args.device, quant=args.int8,
                            quant_skip=quant_skip_arg(args.quant_skip)
                            if args.int8 else ())
    if args.int8:
        check_quantized_set(state, model, args.checkpoint)
    meta = save_serving(model, state, args.out,
                        batch_size=args.batch_size or None, fused_nms=fused,
                        uint8_input=args.uint8_wire, input_mean=mean,
                        platforms=platforms)
    size = os.path.getsize(args.out)
    print(f"wrote serving artifact: {args.out} ({size / 1e6:.1f} MB)")
    for k in ("input_size", "num_classes", "batch_size", "platforms",
              "dtype", "int8"):
        print(f"  {k}: {meta[k]}")


if __name__ == "__main__":
    main()
