"""Device ms per train step of the convolutions, forward and backward
(the kernels launched under aten's convolution ops, cuDNN's bias adds
inside them included), in the traced stretch."""

LAYER = "convolutions"
UNIT = "ms"
CATEGORIES = ("convolution", "convolution backward")


def read(rec):
    w = rec["window"]
    tr = w.get("trace")
    steps = w["steps"] - w["untraced_steps"]
    if not tr or not steps:
        return None
    return sum(tr["categories"].get(c, 0) for c in CATEGORIES) / 1e6 / steps
