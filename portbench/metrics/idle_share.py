"""Share of the traced stretch of steps or calls in which no kernel, copy
or fill ran on the card (the union of device intervals, integer ns). One
reader for every group: ``idle_share.train``, ``idle_share.detect``."""

LAYER = "device"
UNIT = "%"


def read(rec):
    tr = rec["window"].get("trace")
    if not tr or not tr["window_ns"]:
        return None
    return 100.0 * (1.0 - tr["busy_ns"] / tr["window_ns"])
