"""Live webcam demo with an FPS counter.

    python -m refinedet_tpu_torch.tools.live [--trained_model ckpt]
        [--input_size 320] [--num_classes 21] [--threshold 0.35]
        [--camera 0] [--device cuda]

The port of ``demo/live.py`` (the reference's ``demo/live.py:20-66``):
each frame goes through ``tools/demo.py:detect_image`` (the forward and
the per-class NMS, VOC means) and its detections at or above
``--threshold`` are drawn with their class names; ``q`` quits. With no
camera at ``--camera`` it says so and returns before it builds the
model. Frames are read and shown through cv2, which ``main`` needs:
without cv2 it stops with an error that says so.
"""

from __future__ import annotations

import argparse
import time

from refinedet_tpu_torch.config import VOC_MEANS
from refinedet_tpu_torch.tools import demo


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RefineDet live demo")
    p.add_argument("--trained_model", default=None)
    p.add_argument("--input_size", default="320", choices=["320", "512"])
    p.add_argument("--num_classes", default=21, type=int)
    p.add_argument("--threshold", default=0.35, type=float)
    p.add_argument("--camera", default=0, type=int)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    demo.need_cv2("live")
    cv2 = demo.cv2
    cap = cv2.VideoCapture(args.camera)
    if not cap.isOpened():
        print(f"no camera at index {args.camera}; exiting")
        return
    model = demo.build_model(int(args.input_size), args.num_classes,
                             args.trained_model, args.device)

    fps, t_last = 0.0, time.time()
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            rows = demo.detect_image(model, frame, args.threshold, VOC_MEANS)
            demo.draw(frame, rows, args.num_classes, with_score=False)
            now = time.time()
            fps = 0.9 * fps + 0.1 / max(now - t_last, 1e-6)
            t_last = now
            cv2.putText(frame, f"FPS {fps:.1f}", (10, 20),
                        cv2.FONT_HERSHEY_DUPLEX, 0.6, (0, 255, 0))
            cv2.imshow("refinedet_tpu_torch live", frame)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
    finally:
        cap.release()
        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
