"""Device ms per train step of the optimizer, the clip, the SGD step and
the EMA (the span ``train.optimizer``), in the traced stretch. Holds the
card's idle time inside the span (``portbench/span_metric``)."""

from portbench.span_metric import read_span

LAYER = "optimizer"
UNIT = "ms"
SPAN = "train.optimizer"


def read(rec):
    return read_span(rec, SPAN)
