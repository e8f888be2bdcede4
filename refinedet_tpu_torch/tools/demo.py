"""Single-image inference demo.

    python -m refinedet_tpu_torch.tools.demo [--image data/example.jpg]
        [--trained_model ckpt] [--input_size 320] [--num_classes 21]
        [--threshold 0.6] [--out demo_out.png] [--means voc|sar] [--int8]
        [--device cuda]

The port of ``demo/demo.py`` (the reference's ``demo/demo.ipynb``, cells
3-11): build the test-phase net, preprocess one image (resize,
mean-sub, BGR->RGB: ``data/augmentations.py:BaseTransform``), run the
forward and the per-class NMS (``detect/detection.py:
detect_refinedet_nms``, top_k 200, IoU 0.45, scores above 0.01), and
draw every detection at or above ``--threshold``. ``--int8`` serves the
int8 twin calibrated on this image (``quant/ptq.py:quantize_model``).
``--trained_model`` takes what ``eval/cli_coco.py:make_loader`` reads;
without it the weights are seed 0's.

The core, ``detect_image``, works on a numpy image and needs no cv2 (an
image at the model's size needs no resize). Only ``main`` reads, draws
and writes the image through cv2, which it needs: without cv2 it stops
with an error that says so.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from refinedet_tpu_torch.config import MEANS, VOC_MEANS, DetectConfig
from refinedet_tpu_torch.data.augmentations import BaseTransform
from refinedet_tpu_torch.data.voc import VOC_CLASSES
from refinedet_tpu_torch.detect.detection import detect_refinedet_nms

try:
    import cv2
except ImportError:  # the card's host has no image decoder
    cv2 = None

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
# Pixel coordinates are clipped before int(): random weights decode boxes
# far outside the image, beyond what cv2 draws.
PIXEL_CLIP = 10_000
# (class, score, (x1, y1, x2, y2) in pixels)
Row = Tuple[int, float, Tuple[int, int, int, int]]


def detect_config(num_classes: int) -> DetectConfig:
    """The demos' NMS: top_k and keep_top_k 200, scores above 0.01, IoU
    0.45."""
    return DetectConfig(num_classes=num_classes, top_k=200, keep_top_k=200,
                        conf_thresh=0.01, nms_thresh=0.45)


def need_cv2(tool: str) -> None:
    if cv2 is None:
        raise RuntimeError(f"{tool} reads and draws images through cv2 "
                           "(opencv-python), which is not installed; "
                           "detect_image runs without it")


def build_model(input_size: int, num_classes: int,
                trained_model: Optional[str], device):
    """The test-phase float32 net on ``device``, with ``trained_model``'s
    weights (``make_loader``'s formats) or seed 0's."""
    from refinedet_tpu_torch.eval.cli_coco import make_loader
    from refinedet_tpu_torch.models.builder import build_refinedet
    model = build_refinedet("test", input_size, num_classes, device=device)
    if trained_model:
        model.net.load_state_dict(make_loader()(trained_model), strict=True)
    return model


def detections(model, x: np.ndarray) -> np.ndarray:
    """``[B, C, 200, 5]`` rows (score, x1, y1, x2, y2), scores descending
    and zero-padded, of the preprocessed NHWC float32 batch ``x``."""
    with torch.inference_mode():
        images = torch.from_numpy(x).to(model.device)
        arm_loc, arm_conf, odm_loc, odm_conf = model.raw_forward(images)
        dets = detect_refinedet_nms(
            arm_loc, torch.softmax(arm_conf, -1), odm_loc,
            torch.softmax(odm_conf, -1), model.priors,
            detect_config(model.num_classes))
    return dets.cpu().numpy()


def rows_above(dets: np.ndarray, threshold: float, h: int,
               w: int) -> List[Row]:
    """The rows the JAX demo draws from one image's ``[C, K, 5]``: per
    class from 1 on, in score order until the first below
    ``threshold``, the box scaled to pixels and clipped to ±10 000."""
    out = []
    for cl in range(1, dets.shape[0]):
        for row in dets[cl]:
            score = float(row[0])
            if score < threshold:
                break
            px = np.clip(row[1:] * [w, h, w, h], -PIXEL_CLIP, PIXEL_CLIP)
            out.append((cl, score, tuple(int(v) for v in px)))
    return out


def detect_image(model, img_bgr: np.ndarray, threshold: float,
                 means: Sequence[float] = VOC_MEANS,
                 int8: bool = False) -> List[Row]:
    """The detections of one BGR uint8 image ``[H, W, 3]`` at or above
    ``threshold``, as ``(class, score, (x1, y1, x2, y2))`` in the image's
    pixels. ``int8`` calibrates the int8 twin on this image first."""
    h, w = img_bgr.shape[:2]
    x = BaseTransform(model.size, means)(img_bgr)[None]
    if int8:
        from refinedet_tpu_torch.quant import quantize_model
        model, _ = quantize_model(model, [x])
    return rows_above(detections(model, x)[0], threshold, h, w)


def label_of(cl: int, num_classes: int) -> str:
    return VOC_CLASSES[cl - 1] if num_classes == 21 else f"cls{cl}"


def draw(img: np.ndarray, rows: List[Row], num_classes: int,
         with_score: bool = True) -> None:
    """The JAX demos' boxes and labels, in red, onto ``img`` (cv2)."""
    for cl, score, (x1, y1, x2, y2) in rows:
        label = label_of(cl, num_classes)
        cv2.rectangle(img, (x1, y1), (x2, y2), (0, 0, 255), 2)
        if with_score:
            cv2.putText(img, f"{label} {score:.2f}", (x1, max(y1 - 5, 10)),
                        cv2.FONT_HERSHEY_DUPLEX, 0.5, (0, 0, 255))
        else:
            cv2.putText(img, label, (x1, y1), cv2.FONT_HERSHEY_DUPLEX, 0.5,
                        (0, 0, 255))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RefineDet single-image demo")
    p.add_argument("--image", default=osp.join(REPO, "data", "example.jpg"),
                   help="input image (default: data/example.jpg, as in the "
                        "reference demo/demo.ipynb)")
    p.add_argument("--trained_model", default=None,
                   help="checkpoint or .pth (random weights if unset)")
    p.add_argument("--input_size", default="320", choices=["320", "512"])
    p.add_argument("--num_classes", default=21, type=int)
    p.add_argument("--threshold", default=0.6, type=float)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--means", default="voc", choices=["voc", "sar"])
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 PTQ twin, calibrated on this image")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> List[Row]:
    args = parse_args(argv)
    need_cv2("demo")
    model = build_model(int(args.input_size), args.num_classes,
                        args.trained_model, args.device)
    if not args.trained_model:
        print("WARNING: no --trained_model, using random weights")
    img = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read {args.image}")
    rows = detect_image(model, img, args.threshold,
                        VOC_MEANS if args.means == "voc" else MEANS,
                        int8=args.int8)
    draw(img, rows, args.num_classes)
    cv2.imwrite(args.out, img)
    print(f"{len(rows)} detections >= {args.threshold} drawn -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
