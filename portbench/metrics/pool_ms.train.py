"""Device ms per train step of the 2x2 max pools, forward and backward
(the kernels launched under aten's max_pool2d ops and their backward),
in the traced stretch."""

LAYER = "max pools"
UNIT = "ms"
CATEGORIES = ("max_pool2d", "max_pool2d backward")


def read(rec):
    w = rec["window"]
    tr = w.get("trace")
    steps = w["steps"] - w["untraced_steps"]
    if not tr or not steps:
        return None
    return sum(tr["categories"].get(c, 0) for c in CATEGORIES) / 1e6 / steps
