"""Device ms per train step of the augmentation, the draws and
``augment_batch`` (the span ``train.augment``), in the traced stretch.
Holds the card's idle time inside the span (``portbench/span_metric``)."""

from portbench.span_metric import read_span

LAYER = "augmentation"
UNIT = "ms"
SPAN = "train.augment"


def read(rec):
    return read_span(rec, SPAN)
