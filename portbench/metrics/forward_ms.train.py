"""Device ms per train step of the forward, ``zero_grad`` and the network
in train mode (the span ``train.forward``), in the traced stretch. Holds
the card's idle time inside the span (``portbench/span_metric``)."""

from portbench.span_metric import read_span

LAYER = "network forward"
UNIT = "ms"
SPAN = "train.forward"


def read(rec):
    return read_span(rec, SPAN)
