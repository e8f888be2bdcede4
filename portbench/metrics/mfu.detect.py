"""The forward's share of the card's peak in offline detection: per call,
the least time of its convolutions (float ones at 989 TFLOP/s, int8 ones
at 1,979 TOP/s, 2·MACs over every tap), times the untraced calls of the
window, over their host-clock seconds. It reads the same work whatever
implements it."""

LAYER = "network forward"
UNIT = "%"


def read(rec):
    w = rec["window"]
    if not w["untraced_steps"]:
        return None
    return 100.0 * rec["least_s_per_call"] * w["untraced_steps"] / \
        w["untraced_seconds"]
