"""The activation quantize kernel's share of its roofline in the traced
calls: its bytes (the bf16 activation read once, int8 written once) at
3.35 TB/s over the ``int8_quantize_kernel`` time the trace holds."""

from portbench.trace import kernel_ns

LAYER = "int8 quantize kernel"
UNIT = "%"


def read(rec):
    tr = rec["window"].get("trace")
    t = kernel_ns(tr, "int8_quantize_kernel") if tr else 0
    if not t or "int8_quantize_bound_s" not in rec:
        return None
    return 100.0 * rec["int8_quantize_bound_s"] / (t / 1e9)
