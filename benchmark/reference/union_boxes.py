"""Union-box pair-mask rasterization as separable outer products
(a copy of the port's ops/union_boxes.py). The anti-aliased
coverage of a box edge is separable, so each mask is the outer product of
two 1-D coverage profiles:

    cov_y[j] = clip(j+1 - y1, 0, 1) * clip(y2 - j, 0, 1)
    mask[j, k] = cov_y[j] * cov_x[k]
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _coverage(lo: Tensor, hi: Tensor, size: int) -> Tensor:
    """1-D coverage profile of [lo, hi] over `size` unit cells:
    [...] -> [..., size]."""
    j = torch.arange(size, dtype=lo.dtype, device=lo.device)
    return (torch.clamp(j + 1.0 - lo[..., None], 0.0, 1.0) *
            torch.clamp(hi[..., None] - j, 0.0, 1.0))


def draw_union_boxes(box_pairs: Tensor, pooling_size: int) -> Tensor:
    """box_pairs [..., 8] = (sub x1 y1 x2 y2, obj x1 y1 x2 y2) -> subject and
    object coverage masks in union-box coordinates, [..., 2, S, S] with
    S = pooling_size."""
    s = pooling_size
    sub = box_pairs[..., 0:4]
    obj = box_pairs[..., 4:8]
    x1u = torch.minimum(sub[..., 0], obj[..., 0])
    y1u = torch.minimum(sub[..., 1], obj[..., 1])
    x2u = torch.maximum(sub[..., 2], obj[..., 2])
    y2u = torch.maximum(sub[..., 3], obj[..., 3])
    w = torch.clamp(x2u - x1u, min=1e-8)
    h = torch.clamp(y2u - y1u, min=1e-8)

    def one(box):
        x1 = (box[..., 0] - x1u) * s / w
        y1 = (box[..., 1] - y1u) * s / h
        x2 = (box[..., 2] - x1u) * s / w
        y2 = (box[..., 3] - y1u) * s / h
        cy = _coverage(y1, y2, s)
        cx = _coverage(x1, x2, s)
        return cy[..., :, None] * cx[..., None, :]

    return torch.stack([one(sub), one(obj)], dim=-3)
