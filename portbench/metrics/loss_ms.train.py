"""Device ms per train step of matching and the mined losses,
``train_losses`` (the span ``train.loss``), in the traced stretch. Holds
the card's idle time inside the span (``portbench/span_metric``)."""

from portbench.span_metric import read_span

LAYER = "matching and losses"
UNIT = "ms"
SPAN = "train.loss"


def read(rec):
    return read_span(rec, SPAN)
