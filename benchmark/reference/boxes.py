"""Box math on tensors with the reference's pixel-inclusive conventions
(a copy of the port's ops/boxes.py):

  * widths/heights are pixel-inclusive: w = x2 - x1 + 1
  * center_size:  (cx, cy, w, h) with cx = x1 + 0.5*w
  * point_form:   x1 = cx - 0.5*w, x2 = cx + 0.5*(w - 2)  (exact inverse)
  * IoU uses the +1 convention in both intersection and areas
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def center_size(boxes: Tensor) -> Tensor:
    """(x1,y1,x2,y2) -> (cx,cy,w,h), inclusive widths."""
    wh = boxes[..., 2:4] - boxes[..., 0:2] + 1.0
    ctr = boxes[..., 0:2] + 0.5 * wh
    return torch.cat([ctr, wh], dim=-1)


def point_form(boxes: Tensor) -> Tensor:
    """(cx,cy,w,h) -> (x1,y1,x2,y2); inverse of center_size."""
    xy1 = boxes[..., 0:2] - 0.5 * boxes[..., 2:4]
    xy2 = boxes[..., 0:2] + 0.5 * (boxes[..., 2:4] - 2.0)
    return torch.cat([xy1, xy2], dim=-1)


def bbox_preds(boxes: Tensor, deltas: Tensor) -> Tensor:
    """Decode (tx,ty,tw,th) deltas on prior boxes -> (x1,y1,x2,y2)."""
    prior = center_size(boxes)
    xy = prior[..., 0:2] + prior[..., 2:4] * deltas[..., 0:2]
    wh = torch.exp(deltas[..., 2:4]) * prior[..., 2:4]
    return point_form(torch.cat([xy, wh], dim=-1))


def bbox_encode(prior_boxes: Tensor, gt_boxes: Tensor) -> Tensor:
    """Regression targets (tx,ty,tw,th) of gt on prior: the inverse of
    bbox_preds."""
    prior = center_size(prior_boxes)
    gt = center_size(gt_boxes)
    txy = (gt[..., 0:2] - prior[..., 0:2]) / prior[..., 2:4]
    twh = torch.log(gt[..., 2:4]) - torch.log(prior[..., 2:4])
    return torch.cat([txy, twh], dim=-1)


def smooth_l1(x: Tensor, beta: float = 1.0) -> Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def area(boxes: Tensor) -> Tensor:
    """Inclusive pixel area."""
    return ((boxes[..., 2] - boxes[..., 0] + 1.0) *
            (boxes[..., 3] - boxes[..., 1] + 1.0))


def bbox_intersections(box_a: Tensor, box_b: Tensor) -> Tensor:
    """Pairwise intersection area [..., A, B], +1 convention."""
    max_xy = torch.minimum(box_a[..., :, None, 2:4], box_b[..., None, :, 2:4])
    min_xy = torch.maximum(box_a[..., :, None, 0:2], box_b[..., None, :, 0:2])
    inter = torch.clamp(max_xy - min_xy + 1.0, min=0.0)
    return inter[..., 0] * inter[..., 1]


def bbox_overlaps(box_a: Tensor, box_b: Tensor,
                  mask_a: Tensor | None = None,
                  mask_b: Tensor | None = None) -> Tensor:
    """Pairwise IoU [..., A, B] with the +1 convention; masked rows/cols
    give IoU 0."""
    inter = bbox_intersections(box_a, box_b)
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    iou = inter / torch.clamp(union, min=1e-8)
    if mask_a is not None:
        iou = iou * mask_a[..., :, None]
    if mask_b is not None:
        iou = iou * mask_b[..., None, :]
    return iou


def nms_overlaps(boxes: Tensor) -> Tensor:
    """Per-class pairwise IoU: boxes [..., N, C, 4] -> [..., N, N, C]."""
    max_xy = torch.minimum(boxes[..., :, None, :, 2:4],
                           boxes[..., None, :, :, 2:4])
    min_xy = torch.maximum(boxes[..., :, None, :, 0:2],
                           boxes[..., None, :, :, 0:2])
    inter_wh = torch.clamp(max_xy - min_xy + 1.0, min=0.0)
    inters = inter_wh[..., 0] * inter_wh[..., 1]
    areas = area(boxes)
    union = areas[..., :, None, :] + areas[..., None, :, :] - inters
    return inters / torch.clamp(union, min=1e-8)


def clip_boxes(boxes: Tensor, h, w) -> Tensor:
    """Clamp boxes into [0, w-1] x [0, h-1]; h/w are tensors broadcastable
    against boxes[..., 0]."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w - 1.0)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h - 1.0)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w - 1.0)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def union_box(box_a: Tensor, box_b: Tensor) -> Tensor:
    """Smallest box containing both."""
    xy1 = torch.minimum(box_a[..., 0:2], box_b[..., 0:2])
    xy2 = torch.maximum(box_a[..., 2:4], box_b[..., 2:4])
    return torch.cat([xy1, xy2], dim=-1)
