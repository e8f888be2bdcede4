"""Device ms per call of the copy of the call's images from the host into
the graph's input (the span ``serve.h2d``), in the traced stretch. Holds
the card's idle time inside the span (``portbench/span_metric``)."""

from portbench.span_metric import read_span

LAYER = "serving artifact"
UNIT = "ms"
SPAN = "serve.h2d"


def read(rec):
    return read_span(rec, SPAN)
