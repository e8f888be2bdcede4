"""The train step's share of the card's bf16 peak: the step's FLOPs
(``flops.train_step_flops``: the network's forward and backward, 2·MACs
over every tap, and the augmentation's resampling) times the untraced
steps of the window, over their host-clock seconds, against 989 TFLOP/s."""

from portbench.flops import BF16_FLOPS

LAYER = "train step"
UNIT = "%"


def read(rec):
    w = rec["window"]
    if not w["untraced_steps"]:
        return None
    return 100.0 * rec["step_flops"] * w["untraced_steps"] / \
        w["untraced_seconds"] / BF16_FLOPS
