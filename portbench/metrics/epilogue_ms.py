"""Device ms per traced step or call of the convolution epilogue, the
hand-written bias add and ReLU after cuDNN's convolutions
(``conv_bias_relu_kernel``). One reader for both groups:
``epilogue_ms.train`` and ``epilogue_ms.detect``. None where the trace
holds no such kernel (a program without the epilogue)."""

from portbench.trace import kernel_ns

LAYER = "convolutions"
UNIT = "ms"


def read(rec):
    w = rec["window"]
    tr = w.get("trace")
    steps = w["steps"] - w["untraced_steps"]
    t = kernel_ns(tr, "conv_bias_relu_kernel") if tr else 0
    if not t or not steps:
        return None
    return t / 1e6 / steps
