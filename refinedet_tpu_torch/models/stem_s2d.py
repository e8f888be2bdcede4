"""Space-to-depth stem weight folding (a serving transform).

Port of ``refinedet_tpu/models/stem_s2d.py``: turns a standard state_dict
into the one of the ``stem_s2d=True`` network (``models/refinedet.py``),
which computes conv1_1 / conv1_2 / pool1 in a 2x2-blocked spatial layout.
The two networks compute the same function up to the re-association of
the convolutions' sums.

Derivation (rows shown; columns are identical with dj/b/f):

* conv1_1 (3x3/s1, pad 1) emitting the blocked output: output block i,
  phase di, taps logical rows ``2i+di-1 .. 2i+di+1``. A 4x4/s2 conv with
  pad 1 sees rows ``2i-1 .. 2i+2`` at kernel index ``a``, so
  ``K1[a, b, cin, (di,dj,c)] = W1[a-di, b-dj, cin, c]`` wherever
  ``0 <= a-di <= 2``, zero elsewhere (16/9 the stem's FLOPs).

* conv1_2 (3x3/s1, pad 1) + pool1 (2x2/s2): pooled output (i, j) is the
  max of conv1_2 at the four phases (2i+di, 2j+dj). Each phase is a 2x2
  conv over the blocked features with pad (1-di, di): block tap ``a``
  covers logical row ``2(i - (1-di) + a) + e``, which is kernel row
  ``u+1`` for ``u = 2a + e - 2 + di`` (valid when ``0 <= u+1 <= 2``).
  The max over the four phases is pool1, and it commutes with the ReLU
  after it (both are maxes).

Blocked channel order everywhere: ``(e*2 + f)*C + c`` (position-major).
The fold works in the JAX package's HWIO layout, so every weight lands
where ``fold_stem_params`` puts it, then goes back to torch's OIHW: the
result equals ``state_dict_from_flax(fold_stem_variables(v))`` bit for
bit (a copy, no arithmetic).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# vgg indices of the plain trunk the stem replaces: conv1_1, its ReLU,
# conv1_2, its ReLU, pool1
STEM_VGG_LAYERS = 5
STEM_PHASES = ("00", "01", "10", "11")


def _hwio(w: torch.Tensor) -> np.ndarray:
    return np.transpose(w.detach().cpu().numpy().astype(np.float32),
                        (2, 3, 1, 0))


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k,
                                                              (3, 2, 0, 1))))


def fold_stem_state_dict(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Fold a standard plain-variant state_dict (``vgg.0`` = conv1_1,
    ``vgg.2`` = conv1_2, OIHW) into the ``stem_s2d`` layout:
    ``stem_conv1`` (4x4/s2, C_in -> 4C) and ``stem_conv2_{di}{dj}`` (2x2,
    4C -> C). Returns a new dict (CPU tensors for the stem, every other
    entry passed through as it is)."""
    out = dict(state)
    w1 = _hwio(out.pop("vgg.0.weight"))   # [3, 3, C_in, C]
    b1 = out.pop("vgg.0.bias").detach().cpu().numpy().astype(np.float32)
    w2 = _hwio(out.pop("vgg.2.weight"))   # [3, 3, C, C]
    b2 = out.pop("vgg.2.bias").detach().cpu().numpy().astype(np.float32)
    if w1.shape[:2] != (3, 3) or w2.shape[:2] != (3, 3):
        raise ValueError(f"expected 3x3 stem kernels, got {w1.shape} / "
                         f"{w2.shape}")
    cin, c = w1.shape[2], w1.shape[3]

    # conv1_1 -> 4x4/s2, C_in -> 4C, output channel group (di, dj, c)
    k1 = np.zeros((4, 4, cin, 4 * c), np.float32)
    b1b = np.zeros(4 * c, np.float32)
    for di in (0, 1):
        for dj in (0, 1):
            grp = slice((di * 2 + dj) * c, (di * 2 + dj + 1) * c)
            k1[di:di + 3, dj:dj + 3, :, grp] = w1
            b1b[grp] = b1
    out["stem_conv1.weight"] = _oihw(k1)
    out["stem_conv1.bias"] = torch.from_numpy(b1b)

    # conv1_2 -> four 2x2 phase convs over the blocked (e, f, c) channels
    for di in (0, 1):
        for dj in (0, 1):
            k = np.zeros((2, 2, 4 * c, c), np.float32)
            for a in (0, 1):
                for e in (0, 1):
                    u = 2 * a + e - 2 + di
                    if not 0 <= u + 1 <= 2:
                        continue
                    for b in (0, 1):
                        for f in (0, 1):
                            v = 2 * b + f - 2 + dj
                            if not 0 <= v + 1 <= 2:
                                continue
                            grp = slice((e * 2 + f) * c, (e * 2 + f + 1) * c)
                            k[a, b, grp, :] = w2[u + 1, v + 1]
            out[f"stem_conv2_{di}{dj}.weight"] = _oihw(k)
            out[f"stem_conv2_{di}{dj}.bias"] = torch.from_numpy(b2.copy())
    return out
