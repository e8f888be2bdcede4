"""Epoch checkpoints of the full train state, with ``torch.save``.

Port of ``refinedet_tpu/train/checkpoints.py``: the reference's naming
``RefineDet{size}_{dataset}_epoches_{tag}`` (plus ``.pth``), and the whole
state, not just the weights, so a resumed run keeps SGD's momentum. A
checkpoint is a dict::

    {"step": int, "model": net.state_dict(), "optimizer":
     optimizer.state_dict(), "ema": {param name: tensor} or None}

``model`` carries the reference network's key names, so it strict-loads
into the reference net; for the BN variant it holds the running
statistics, which the EMA (parameters only) does not. Files are written
to a temporary name and renamed, so a run killed mid-save leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any, Dict, Optional

import torch

SUFFIX = ".pth"


class CheckpointManager:
    """Epoch-indexed checkpoints in ``directory`` named
    ``{prefix}_epoches_{tag}.pth``."""

    def __init__(self, directory: str, prefix: str = "RefineDet320_COCO"):
        self.directory = osp.abspath(directory)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)

    def path(self, tag) -> str:
        return osp.join(self.directory,
                        f"{self.prefix}_epoches_{tag}{SUFFIX}")

    def save(self, state, tag) -> str:
        """Write ``state`` (a TrainState) under ``tag``; returns the path."""
        payload = {
            "step": int(state.step),
            "model": state.net.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
        }
        path = self.path(tag)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, tag) -> Dict[str, Any]:
        return self.restore_path(self.path(tag))

    @staticmethod
    def restore_path(path: str) -> Dict[str, Any]:
        """The saved dict, its tensors on the CPU."""
        return torch.load(osp.abspath(path), map_location="cpu",
                          weights_only=True)

    def latest_epoch(self) -> Optional[int]:
        pat = re.compile(re.escape(self.prefix) + r"_epoches_(\d+)"
                         + re.escape(SUFFIX) + "$")
        epochs = [int(m.group(1)) for m in map(pat.match,
                                               os.listdir(self.directory))
                  if m]
        return max(epochs) if epochs else None
