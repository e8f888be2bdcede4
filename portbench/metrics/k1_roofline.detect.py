"""Kernel K1's share of its roofline in the traced calls: the least time
of each launch (G·K·18 bytes at 3.35 TB/s, against 15 operations per IoU
test at 67 TFLOP/s over the least tests greedy NMS needs, counted from the
reference's keep sets of the same images) over the ``nms_sweep_kernel``
time the trace holds."""

from portbench.trace import kernel_ns

LAYER = "kernel K1"
UNIT = "%"


def read(rec):
    tr = rec["window"].get("trace")
    t = kernel_ns(tr, "nms_sweep_kernel") if tr else 0
    if not t or "k1_bound_s" not in rec:
        return None
    return 100.0 * rec["k1_bound_s"] / (t / 1e9)
