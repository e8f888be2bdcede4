"""Seeded VOC-like scenes, made on the device: uint8 RGB canvases with
their ground truth.

Each image is a smooth random background (a coarse random field,
upsampled) with fine pixel noise, and filled rectangles of random colour
at its ground-truth boxes. The number of objects per image follows VOC07+12
trainval's: one, plus a geometric tail of mean ``objects_mean`` - 1, cut at
``objects_max``. Box sides are log-uniform between ``side_min`` and
``side_max`` of the canvas, independently in width and height, the box
inside the canvas; labels are uniform over the foreground classes.
Everything comes from the generator given, so one seed gives one set.
"""

from __future__ import annotations

import math

import torch


def make(p: dict, gen: torch.Generator, count: int, size: int,
         num_classes: int, max_boxes: int):
    """(images uint8 [N, S, S, 3] RGB, boxes float32 [N, M, 4] point form
    in pixels, labels int64 [N, M] 1-based, valid bool [N, M]) with M =
    ``max_boxes``, all on ``gen``'s device."""
    dev = gen.device
    kw = dict(generator=gen, device=dev)
    m = max_boxes
    q = 1.0 / p["objects_mean"]  # P(stop) of the tail, mean 1 / q
    u = torch.rand(count, **kw).clamp_min(1e-12)
    n = 1 + torch.floor(torch.log(u) / math.log(1.0 - q))
    n = n.clamp(max=min(p["objects_max"], m)).long()
    valid = torch.arange(m, device=dev)[None] < n[:, None]
    lo, hi = math.log(p["side_min"]), math.log(p["side_max"])
    wh = torch.exp(lo + (hi - lo) * torch.rand(count, m, 2, **kw)) * size
    xy = torch.rand(count, m, 2, **kw) * (size - wh)
    boxes = torch.cat([xy, xy + wh], -1).floor()
    labels = torch.randint(1, num_classes, (count, m), **kw)
    coarse = torch.randn(count, 3, 12, 12, **kw) * 45.0 + 115.0
    img = torch.nn.functional.interpolate(coarse, size=(size, size),
                                          mode="bilinear",
                                          align_corners=False)
    colors = torch.rand(count, m, 3, **kw) * 200.0 + 30.0
    ys = torch.arange(size, device=dev, dtype=torch.float32).view(1, -1, 1)
    xs = torch.arange(size, device=dev, dtype=torch.float32).view(1, 1, -1)
    for j in range(int(n.max())):
        b = boxes[:, j]
        inside = ((xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None])
                  & (ys >= b[:, 1, None, None]) & (ys < b[:, 3, None, None])
                  & valid[:, j, None, None])
        img = torch.where(inside[:, None], colors[:, j, :, None, None], img)
    img = img + torch.randn(img.shape, **kw) * 12.0
    images = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return images.contiguous(), boxes, labels, valid
