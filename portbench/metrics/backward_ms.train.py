"""Device ms per train step of the backward (the span ``train.backward``),
in the traced stretch. Holds the card's idle time inside the span
(``portbench/span_metric``): where the host under the profiler falls
behind the card, mostly here, the reading tracks ``idle_share.train``
more than the backward's work."""

from portbench.span_metric import read_span

LAYER = "backward"
UNIT = "ms"
SPAN = "train.backward"


def read(rec):
    return read_span(rec, SPAN)
