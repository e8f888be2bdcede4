"""Seeded SAR-like ship scenes, made on the device: uint8 images with
their ground truth.

Sea clutter is multi-look speckle: a slowly varying clutter level (a
coarse random field, upsampled, uniform in ``clutter[0]`` to
``clutter[0] + clutter[1]``; SSDD's mean pixel is 98) times the mean of
``looks`` exponential draws per pixel. Ships are small bright
rectangles, ``ship_len`` pixels long and ``ship_wid`` wide, horizontal
or vertical, their level ``ship_gain`` times the clutter's, speckled
alike. Ships per image follow ``ship_counts`` (probabilities of 1, 2,
... ships; SSDD has about 2.1 an image). The one channel is repeated
thrice, as the fork reads SSDD's grey JPEGs.
"""

from __future__ import annotations

import torch


def make(p: dict, gen: torch.Generator, count: int, size: int,
         num_classes: int, max_boxes: int):
    """As ``gen_scenes.make``: images uint8 [N, S, S, 3], boxes [N, M, 4]
    in pixels, labels (all 1) and valid."""
    dev = gen.device
    kw = dict(generator=gen, device=dev)
    m = max_boxes
    probs = torch.tensor(p["ship_counts"], device=dev)
    n = 1 + torch.multinomial(probs.expand(count, -1), 1, generator=gen)[:, 0]
    n = n.clamp(max=m)
    valid = torch.arange(m, device=dev)[None] < n[:, None]
    length = p["ship_len"][0] + torch.rand(count, m, **kw) * (
        p["ship_len"][1] - p["ship_len"][0])
    width = p["ship_wid"][0] + torch.rand(count, m, **kw) * (
        p["ship_wid"][1] - p["ship_wid"][0])
    vertical = torch.rand(count, m, **kw) < 0.5
    wh = torch.stack([torch.where(vertical, width, length),
                      torch.where(vertical, length, width)], -1)
    xy = torch.rand(count, m, 2, **kw) * (size - wh)
    boxes = torch.cat([xy, xy + wh], -1).floor()
    level = torch.nn.functional.interpolate(
        torch.rand(count, 1, 8, 8, **kw) * p["clutter"][1] + p["clutter"][0],
        size=(size, size), mode="bilinear", align_corners=False)[:, 0]
    ys = torch.arange(size, device=dev, dtype=torch.float32).view(1, -1, 1)
    xs = torch.arange(size, device=dev, dtype=torch.float32).view(1, 1, -1)
    for j in range(int(n.max())):
        b = boxes[:, j]
        inside = ((xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None])
                  & (ys >= b[:, 1, None, None]) & (ys < b[:, 3, None, None])
                  & valid[:, j, None, None])
        level = torch.where(inside, level * p["ship_gain"], level)
    looks = p["looks"]
    u = torch.rand(looks, count, size, size, **kw).clamp_min(1e-12)
    img = level * (-torch.log(u)).mean(0)
    img = img.clamp(0, 255).round().to(torch.uint8)
    images = img[..., None].expand(-1, -1, -1, 3).contiguous()
    return images, boxes, torch.ones_like(boxes[..., 0]).long(), valid
