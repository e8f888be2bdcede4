"""Frozen plain copy of the port's on-device SSD augmentation.

A copy of ``refinedet_tpu_torch/data/augment.py`` as it stood when the
benchmark was written (the draws, their laws and the generator keyed by
(seed, step) included), so the reference of the train cell works out every
augmented batch again from the staged inputs and the step count, without
importing the program. Later changes to the program do not change it.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
# (min_iou, max_iou) of the 6 reference crop modes; mode 0 = no crop.
_MODE_MIN = (0.0, 0.1, 0.3, 0.7, 0.9, -float("inf"))
_MODE_MAX = (0.0,) + (float("inf"),) * 5
NUM_TRIALS = 50
_F32 = torch.float32


class Draws(NamedTuple):
    """Every random draw of ``augment_batch``, one row per image: flags
    bool [B], integers int64 [B] in 0..5, the rest unit uniforms in
    [0, 1) float32 ([B] unless noted)."""

    bright_on: torch.Tensor
    bright: torch.Tensor          # -> delta in [-32, 32)
    contrast_first: torch.Tensor  # contrast before the HSV step
    contrast_on: torch.Tensor
    contrast: torch.Tensor        # -> alpha in [0.5, 1.5)
    sat_on: torch.Tensor
    sat: torch.Tensor             # -> factor in [0.5, 1.5)
    hue_on: torch.Tensor
    hue: torch.Tensor             # -> shift in [-18, 18) degrees
    perm: torch.Tensor            # row of _PERMS
    perm_on: torch.Tensor
    expand_on: torch.Tensor
    ratio: torch.Tensor           # -> expand ratio in [1, 4)
    offset: torch.Tensor          # [B, 2]: expand left, top
    mode: torch.Tensor            # row of _MODE_MIN/_MODE_MAX
    trials: torch.Tensor          # [B, 4, T]: crop w, h, x, y per trial
    flip: torch.Tensor

    def to(self, device) -> "Draws":
        return Draws(*(t.to(device) for t in self))


class Trials(NamedTuple):
    """Every crop trial of each image, in canvas coordinates."""

    rects: torch.Tensor    # [B, T, 4] x1, y1, x2, y2
    passed: torch.Tensor   # [B, T] the trial passes every test
    aspect: torch.Tensor   # [B, T] its h / w, tested against [1/2, 2]
    centers: torch.Tensor  # [B, M, 2] the boxes' centers
    offset: torch.Tensor   # [B, 2] expand left, top (image origin)
    canvas: torch.Tensor   # [B, 4] the whole canvas, 0, 0, w, h


class Crop(NamedTuple):
    rect: torch.Tensor    # [B, 4] x1, y1, x2, y2 in canvas coordinates
    offset: torch.Tensor  # [B, 2] expand left, top (image origin in canvas)
    trial: torch.Tensor   # [B] the trial taken, -1 for the full canvas


def _lookup(idx: torch.Tensor, table: Sequence[float],
            dtype: torch.dtype) -> torch.Tensor:
    """``table[idx]`` for an integer tensor ``idx``, without a copy of the
    table to ``idx``'s device."""
    out = torch.full(idx.shape, table[0], dtype=dtype, device=idx.device)
    for k in range(1, len(table)):
        out = torch.where(idx == k, table[k], out)
    return out


def _scaled(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """A unit uniform mapped as ``jax.random.uniform(minval=lo,
    maxval=hi)`` maps its bits: max(lo, u·(hi − lo) + lo)."""
    x = u * (hi - lo) + lo
    return torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp_min(lo)


def _rgb_to_hsv(r, g, b):
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    c = maxc - minc
    s = torch.where(maxc > 0, c / maxc.clamp_min(1e-12), 0.0)
    safe_c = c.clamp_min(1e-12)
    hr = torch.remainder((g - b) / safe_c, 6.0)  # Python's sign, as jnp's
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    # A tie takes r before g before b.
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    return torch.where(c > 0, h * 60.0, 0.0), s, maxc


def _hsv_to_rgb(h, s, v):
    # / 60 as XLA and the card compute it: times the float32 reciprocal.
    h = torch.remainder(h, 360.0) * (1.0 / 60.0)
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32) % 6  # an h/60 that rounds to 6.0 is sector 0
    sector = [i == k for k in range(1, 6)]

    def pick(*vals):
        out = vals[0]
        for m, val in zip(sector, vals[1:]):
            out = torch.where(m, val, out)
        return out

    return pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), \
        pick(p, p, t, v, v, q)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB (any positive scale) -> HSV with H in [0, 360)."""
    return torch.stack(_rgb_to_hsv(*rgb.unbind(-1)), -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """[..., 3] HSV -> RGB; a saturation above 1 is not clamped."""
    return torch.stack(_hsv_to_rgb(*hsv.unbind(-1)), -1)


def photometric_apply(img: torch.Tensor, d: Draws) -> torch.Tensor:
    """The reference PhotometricDistort on [B, H, W, 3] RGB float32, with
    the draws ``d``."""
    b = img.shape[0]

    def per_image(t):
        return t.view(b, 1, 1)

    delta = _scaled(d.bright, -32.0, 32.0).view(b, 1, 1, 1)
    img = torch.where(d.bright_on.view(b, 1, 1, 1), img + delta, img)
    alpha = _scaled(d.contrast, 0.5, 1.5).view(b, 1, 1, 1)
    before = (d.contrast_on & d.contrast_first).view(b, 1, 1, 1)
    img = torch.where(before, img * alpha, img)
    h, s, v = _rgb_to_hsv(*img.clamp_min(0.0).unbind(-1))
    sat = torch.where(d.sat_on, _scaled(d.sat, 0.5, 1.5), 1.0)
    hue = torch.where(d.hue_on, _scaled(d.hue, -18.0, 18.0), 0.0)
    img = torch.stack(_hsv_to_rgb(h + per_image(hue), s * per_image(sat), v),
                      -1)
    after = (d.contrast_on & ~d.contrast_first).view(b, 1, 1, 1)
    img = torch.where(after, img * alpha, img)
    order = torch.stack([_lookup(d.perm, [p[j] for p in _PERMS],
                                 torch.int64) for j in range(3)], -1)
    order = torch.where(d.perm_on[:, None], order,
                        torch.arange(3, device=img.device))
    return img.gather(-1, order.view(b, 1, 1, 3).expand(img.shape))


def crop_trials(boxes: torch.Tensor, valid: torch.Tensor, d: Draws,
                w: float, h: float) -> Trials:
    """The expand and every crop trial of each image, all tested at once:
    boxes [B, M, 4] in image pixels, valid [B, M], an image of w x h."""
    ratio = torch.where(d.expand_on, _scaled(d.ratio, 1.0, 4.0), 1.0)
    off = torch.floor(torch.stack([d.offset[:, 0] * w, d.offset[:, 1] * h],
                                  1) * (ratio - 1)[:, None])
    cw_full, ch_full = (w * ratio)[:, None], (h * ratio)[:, None]
    cboxes = boxes + off.repeat(1, 2)[:, None, :]  # canvas coordinates

    u = d.trials
    tw = _scaled(u[:, 0], 0.3 * cw_full, cw_full)  # [B, T]
    th = _scaled(u[:, 1], 0.3 * ch_full, ch_full)
    tx = torch.floor(u[:, 2] * (cw_full - tw))
    ty = torch.floor(u[:, 3] * (ch_full - th))
    rects = torch.stack([tx, ty, tx + torch.floor(tw), ty + torch.floor(th)],
                        -1)  # [B, T, 4]
    aspect_ok = (th / tw >= 0.5) & (th / tw <= 2.0)

    # IoU of every box against every trial rect: [B, T, M]
    cb, rc = cboxes[:, None], rects[:, :, None]
    lt = torch.maximum(cb[..., :2], rc[..., :2])
    rb = torch.minimum(cb[..., 2:], rc[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_b = (cb[..., 2] - cb[..., 0]) * (cb[..., 3] - cb[..., 1])
    area_r = (rc[..., 2] - rc[..., 0]) * (rc[..., 3] - rc[..., 1])
    iou = inter / (area_b + area_r - inter).clamp_min(1e-12)
    vm = valid[:, None, :]
    iou_min = torch.where(vm, iou, float("inf")).amin(-1)
    iou_max = torch.where(vm, iou, -float("inf")).amax(-1)
    min_iou = _lookup(d.mode, _MODE_MIN, _F32)[:, None]
    max_iou = _lookup(d.mode, _MODE_MAX, _F32)[:, None]
    # Reference retry condition: overlap.min() < min_iou AND
    # max_iou < overlap.max().
    iou_ok = ~((iou_min < min_iou) & (max_iou < iou_max))

    centers = (cb[..., :2] + cb[..., 2:]) / 2.0
    inside = ((rc[..., 0] < centers[..., 0]) & (rc[..., 1] < centers[..., 1])
              & (rc[..., 2] > centers[..., 0])
              & (rc[..., 3] > centers[..., 1]) & vm)
    zero = torch.zeros_like(cw_full)
    return Trials(rects, aspect_ok & iou_ok & inside.any(-1), th / tw,
                  centers[:, 0], off,
                  torch.cat([zero, zero, cw_full, ch_full], 1))


def select_crop(boxes: torch.Tensor, valid: torch.Tensor, d: Draws,
                w: float, h: float) -> Crop:
    """Expand + IoU-constrained crop for each image (``crop_trials``'s
    arguments): the first trial that passes, by index; an image whose
    mode is 0, or where no trial passes (an all-invalid padded sample
    among them), keeps the whole canvas."""
    t = crop_trials(boxes, valid, d, w, h)
    num_trials = t.passed.shape[1]
    first = torch.where(t.passed,
                        torch.arange(num_trials, device=boxes.device),
                        num_trials).amin(-1)  # no argmax on a bool
    use_crop = (d.mode != 0) & (first < num_trials)
    first = first.clamp_max(num_trials - 1)
    chosen = t.rects.gather(1, first.view(-1, 1, 1).expand(-1, 1, 4))[:, 0]
    return Crop(torch.where(use_crop[:, None], chosen, t.canvas), t.offset,
                torch.where(use_crop, first, -1))


def crop_scale_translation(crop: Crop, out_size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``resample``'s scale and translation [B, 2], (y, x), that map the
    crop's source rect (canvas minus the expand offset) onto out_size²."""
    x1, y1, x2, y2 = crop.rect.unbind(-1)
    cw, ch = x2 - x1, y2 - y1
    ix1 = x1 - crop.offset[:, 0]
    iy1 = y1 - crop.offset[:, 1]
    s = torch.full_like(cw, float(out_size))
    return (torch.stack([s / ch, s / cw], 1),
            torch.stack([-iy1 * float(out_size) / ch,
                         -ix1 * float(out_size) / cw], 1))


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Per image, the [in, out] matrix of ``jax.image.scale_and_translate``
    (``compute_weight_mat``) with the linear kernel, antialiased: [B, in,
    out] for scale and translation [B]. A column whose sample lies outside
    [-0.5, in - 0.5] is zero; the op order of ``sample_f`` decides that
    edge test."""
    dev = scale.device
    inv_scale = torch.ones_like(scale) / scale
    kernel_scale = inv_scale.clamp_min(1.0)
    sample_f = ((torch.arange(out_size, dtype=_F32, device=dev) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None]
                - 0.5)  # [B, out]
    x = ((sample_f[:, None, :]
          - torch.arange(in_size, dtype=_F32, device=dev)[None, :, None])
         .abs() / kernel_scale[:, None, None])
    weights = (1 - x).clamp_min(0.0)  # the triangle kernel
    total = weights.sum(1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def resample(images: torch.Tensor, scale: torch.Tensor,
             translation: torch.Tensor, out_size: int) -> torch.Tensor:
    """``jax.image.scale_and_translate(img, (out, out, C), (0, 1), scale,
    translation, method="linear")`` for each image of [B, H, W, C];
    scale and translation [B, 2] float32 in (y, x) order. Two batched
    contractions in the images' dtype, as JAX casts the weights."""
    wy = resample_weights(images.shape[1], out_size, scale[:, 0],
                          translation[:, 0]).to(images.dtype)
    wx = resample_weights(images.shape[2], out_size, scale[:, 1],
                          translation[:, 1]).to(images.dtype)
    rows = torch.einsum("bhwc,bwq->bhqc", images, wx)
    return torch.einsum("bhqc,bhp->bpqc", rows, wy)


def augment_batch(images: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, draws: Draws, out_size: int = 320,
                  mean: Sequence[float] = (104.0, 117.0, 123.0)
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD chain on a staged batch, with the draws ``draws``.

    images [B, S0, S0, 3] uint8 or float32 RGB at pixel scale, boxes [B,
    M, 4] float32 point form in staging pixels, valid [B, M] bool;
    ``mean`` in the reference's BGR order (reversed here, the images being
    RGB). Returns float32 images [B, out, out, 3] minus the mean, boxes
    normalized to [0, 1], and the new valid. Runs in float32 whatever
    autocast is on; float64 images stay float64 (a reference for the
    float32 chain: the geometry is the same).
    """
    b, s0h, s0w = images.shape[:3]
    with torch.autocast(images.device.type, enabled=False):
        img = photometric_apply(
            images.to(torch.promote_types(images.dtype, _F32)), draws)
        img = img - _lookup(torch.arange(3, device=img.device), mean[::-1],
                            _F32)  # samples outside the image: the mean

        crop = select_crop(boxes, valid, draws, float(s0w), float(s0h))
        out = resample(img, *crop_scale_translation(crop, out_size),
                       out_size)

        # Boxes: canvas -> crop -> [0, 1], with the center-keep rule.
        cboxes = boxes + crop.offset.repeat(1, 2)[:, None, :]
        cx = (cboxes[..., 0] + cboxes[..., 2]) / 2.0
        cy = (cboxes[..., 1] + cboxes[..., 3]) / 2.0
        x1, y1, x2, y2 = (t[:, None] for t in crop.rect.unbind(-1))
        cw, ch = x2 - x1, y2 - y1
        valid = valid & (x1 < cx) & (y1 < cy) & (x2 > cx) & (y2 > cy)

        def clip(t, hi):
            return torch.minimum(t.clamp_min(0.0), hi)

        nb = torch.stack([
            clip(torch.maximum(cboxes[..., 0], x1) - x1, cw) / cw,
            clip(torch.maximum(cboxes[..., 1], y1) - y1, ch) / ch,
            clip(torch.minimum(cboxes[..., 2], x2) - x1, cw) / cw,
            clip(torch.minimum(cboxes[..., 3], y2) - y1, ch) / ch], -1)

        flip = draws.flip
        out = torch.where(flip.view(b, 1, 1, 1), out.flip(2), out)
        mirrored = torch.stack([1.0 - nb[..., 2], nb[..., 1],
                                1.0 - nb[..., 0], nb[..., 3]], -1)
        nb = torch.where(flip.view(b, 1, 1), mirrored, nb)
    return out, nb, valid


def sample_draws(generator: torch.Generator, batch: int,
                 num_trials: int = NUM_TRIALS) -> Draws:
    """Draws for ``batch`` images from ``generator``, on its device, with
    ``augment_jax``'s laws: every flag p = 1/2, the permutation and the
    mode uniform over 0..5, the rest unit uniforms."""
    kw = dict(generator=generator, device=generator.device)
    flags = torch.rand(batch, 8, **kw) < 0.5
    u = torch.rand(batch, 7 + 4 * num_trials, **kw)
    ints = torch.randint(0, 6, (batch, 2), **kw)
    return Draws(
        bright_on=flags[:, 0], bright=u[:, 0],
        contrast_first=flags[:, 1], contrast_on=flags[:, 2],
        contrast=u[:, 1], sat_on=flags[:, 3], sat=u[:, 2],
        hue_on=flags[:, 4], hue=u[:, 3], perm=ints[:, 0],
        perm_on=flags[:, 5], expand_on=flags[:, 6], ratio=u[:, 4],
        offset=u[:, 5:7], mode=ints[:, 1],
        trials=u[:, 7:].reshape(batch, 4, num_trials), flip=flags[:, 7])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step``: a function of (seed, step)
    alone, as the JAX step's ``fold_in(PRNGKey(seed), step)``, so a
    resumed run draws what an uninterrupted one would have drawn."""
    g = torch.Generator(device=device)
    state = np.random.SeedSequence([seed % 2 ** 64, step]).generate_state(
        1, np.uint64)[0]
    g.manual_seed(int(state))
    return g
