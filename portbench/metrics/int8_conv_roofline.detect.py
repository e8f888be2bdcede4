"""The int8 convolution kernel's share of its roofline in the traced
calls: per conv the larger of 2·MACs at 1,979 TOP/s and (xq + w + bf16
out) bytes at 3.35 TB/s, over the time of ``int8_conv_kernel`` and its
split-K ``int8_conv_reduce`` the trace holds."""

from portbench.trace import kernel_ns

LAYER = "int8 conv kernel"
UNIT = "%"


def read(rec):
    tr = rec["window"].get("trace")
    t = kernel_ns(tr, "int8_conv_kernel", "int8_conv_reduce") if tr else 0
    if not t or "int8_conv_bound_s" not in rec:
        return None
    return 100.0 * rec["int8_conv_bound_s"] / (t / 1e9)
