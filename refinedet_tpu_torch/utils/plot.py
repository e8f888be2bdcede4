"""Training-curve plotting utilities.

The port's own copy of ``refinedet_tpu/utils/plot.py`` (the counterpart
of the reference's ``plot_curve.py:8-68``): parse the train script's
log.txt lines into loss curves, and plot the checkpoint-sweep AP stats
(ap_stats.json). matplotlib is optional — parsing works headless and
plotting degrades to a no-op with a warning if it is missing.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

_LOG_RE = re.compile(
    r"Iter: (\d+)/\d+ \|\| ARM_L Loss: ([\d.nan]+) ARM_C Loss: ([\d.nan]+) "
    r"ODM_L Loss: ([\d.nan]+) ODM_C Loss: ([\d.nan]+) loss: ([\d.nan]+) "
    r"\|\| LR: ([\d.e+-]+)")


def parse_log(path: str) -> Dict[str, np.ndarray]:
    """Extract per-iteration loss/LR series from a train log."""
    series: Dict[str, List[float]] = {
        "iter": [], "arm_loss_l": [], "arm_loss_c": [], "odm_loss_l": [],
        "odm_loss_c": [], "loss": [], "lr": []}
    with open(path) as f:
        for line in f:
            m = _LOG_RE.search(line)
            if not m:
                continue
            vals = m.groups()
            series["iter"].append(int(vals[0]))
            for key, v in zip(("arm_loss_l", "arm_loss_c", "odm_loss_l",
                               "odm_loss_c", "loss", "lr"), vals[1:]):
                series[key].append(float(v))
    return {k: np.asarray(v) for k, v in series.items()}


def _get_plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return None


def plot_loss(log_path: str, out_path: str = "loss_curve.png",
              smooth: int = 1) -> Optional[str]:
    """Loss curves from log.txt (plot_curve.py:8-41)."""
    plt = _get_plt()
    if plt is None:
        return None
    s = parse_log(log_path)
    fig, ax = plt.subplots(figsize=(10, 6))
    for key in ("arm_loss_l", "arm_loss_c", "odm_loss_l", "odm_loss_c",
                "loss"):
        y = s[key]
        x = s["iter"]
        if smooth > 1 and len(y) >= smooth:
            y = np.convolve(y, np.ones(smooth) / smooth, mode="valid")
            # trailing-window alignment: point i = mean of the smooth
            # iterations ENDING at x[i] (plotting against the leading
            # iterations would shift LR-step drops smooth-1 iters early)
            x = x[smooth - 1:]
        ax.plot(x, y, label=key)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_map(ap_stats_path: str, out_path: str = "ap_curve.png",
             keys: Sequence[str] = ("ap", "ap50", "ap75")) -> Optional[str]:
    """Epoch-vs-AP curves from ap_stats.json (plot_curve.py:44-68)."""
    plt = _get_plt()
    if plt is None:
        return None
    with open(ap_stats_path) as f:
        stats = json.load(f)
    fig, ax = plt.subplots(figsize=(10, 6))
    for key in keys:
        if stats.get(key):
            ax.plot(stats["epoch"], stats[key], marker="o", label=key)
    ax.set_xlabel("epoch")
    ax.set_ylabel("AP")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


class LivePlotter:
    """Live training-loss visualization.

    Headless counterpart of the reference's optional visdom loss windows
    (its ``train_refinedet.py:102-104,205-209,273-275,308-336``):
    instead of streaming to a visdom server, it
    accumulates per-iteration and per-epoch loss series in memory and
    re-renders them to PNGs on a cadence, so a dashboard (or just an image
    viewer / browser tab) can watch training progress without parsing
    log.txt. No-op (collect only) when matplotlib is unavailable.
    """

    _KEYS = ("arm_loss_l", "arm_loss_c", "odm_loss_l", "odm_loss_c", "loss")

    def __init__(self, out_dir: str, render_every: int = 50):
        import os
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.render_every = max(1, render_every)
        self.iters: List[int] = []
        self.series: Dict[str, List[float]] = {k: [] for k in self._KEYS}
        self.epochs: List[int] = []
        self.epoch_series: Dict[str, List[float]] = {k: [] for k in self._KEYS}
        self._epoch_acc: Dict[str, float] = {k: 0.0 for k in self._KEYS}
        self._epoch_n = 0

    def update(self, iteration: int, metrics: Dict[str, float]) -> None:
        """Record one iteration's losses (reference's iter_plot window)."""
        self.iters.append(int(iteration))
        for k in self._KEYS:
            v = float(metrics[k])
            self.series[k].append(v)
            self._epoch_acc[k] += v
        self._epoch_n += 1
        if len(self.iters) % self.render_every == 0:
            self.render()

    def end_epoch(self, epoch: int) -> None:
        """Fold the accumulated epoch means into the epoch plot
        (reference's epoch_plot window, train_refinedet.py:218-223)."""
        if self._epoch_n == 0:
            return
        self.epochs.append(int(epoch))
        for k in self._KEYS:
            self.epoch_series[k].append(self._epoch_acc[k] / self._epoch_n)
            self._epoch_acc[k] = 0.0
        self._epoch_n = 0
        self.render()

    def render(self) -> Optional[str]:
        import os
        plt = _get_plt()
        if plt is None:
            return None
        fig, axes = plt.subplots(1, 2, figsize=(14, 5))
        for k in self._KEYS:
            if self.iters:
                axes[0].plot(self.iters, self.series[k], label=k, lw=0.8)
            if self.epochs:
                axes[1].plot(self.epochs, self.epoch_series[k], marker="o",
                             label=k)
        axes[0].set_xlabel("iteration")
        axes[1].set_xlabel("epoch")
        for ax, has_data in zip(axes, (bool(self.iters), bool(self.epochs))):
            ax.set_ylabel("loss")
            if has_data:
                ax.legend(fontsize=8)
        out = os.path.join(self.out_dir, "live_loss.png")
        fig.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return out
