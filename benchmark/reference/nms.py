"""Greedy NMS, the plain versions of the port's ops/nms.py: the tiled
fixpoint for [L, N] lanes (K3's task) and the rank-sequential pass over
score-sorted per-class candidates (K2's task). Ties: a stable descending
sort, the lower index first.
"""

from __future__ import annotations

import torch

from benchmark.reference.boxes import area, bbox_overlaps

Tensor = torch.Tensor

NEG_INF = -1e10


def sort_desc(x: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    out = torch.sort(x, dim=dim, descending=True, stable=True)
    return out.values, out.indices


def _fixpoint_alive(sup: Tensor, v: Tensor) -> Tensor:
    alive = v
    for _ in range(sup.shape[-1] + 1):
        new = v & ~torch.any(sup & alive[..., :, None], dim=-2)
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def greedy_nms_mask(boxes: Tensor, scores: Tensor, valid: Tensor,
                    iou_thresh: float, tile: int = 128) -> Tensor:
    """Exact greedy NMS keep mask [L, N] in the original order."""
    l, n, _ = boxes.shape
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    _, order = sort_desc(masked, dim=1)
    b = boxes.gather(1, order[..., None].expand(l, n, 4))
    alive = valid.gather(1, order)
    tri = torch.arange(min(tile, n), device=boxes.device)
    upper = tri[:, None] < tri[None, :]
    col = torch.arange(n, device=boxes.device)
    for s in range(0, n, tile):
        e = min(s + tile, n)
        tb = b[:, s:e]
        ta = alive[:, s:e]
        k = e - s
        sup = (bbox_overlaps(tb, tb) > iou_thresh) & upper[:k, :k]
        sup = sup & ta[:, :, None] & ta[:, None, :]
        ta = _fixpoint_alive(sup, ta)
        alive = torch.cat([alive[:, :s], ta, alive[:, e:]], dim=1)
        kill = torch.any(ta[:, :, None] & (bbox_overlaps(tb, b) > iou_thresh), dim=1)
        alive = alive & ~(kill & (col >= e))
    return torch.zeros_like(valid).scatter(1, order, alive)


def nms_topk(boxes: Tensor, scores: Tensor, valid: Tensor, iou_thresh: float,
             pre_topn: int, post_topn: int) -> tuple[Tensor, Tensor]:
    """Score-sort, keep the top pre_topn, greedy-suppress, return the
    post_topn surviving indices and their valid flags."""
    l, n = scores.shape
    pre = min(pre_topn, n)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = sort_desc(masked, dim=1)
    top_scores, top_idx = top_scores[:, :pre], top_idx[:, :pre]
    top_valid = top_scores > NEG_INF / 2
    top_boxes = boxes.gather(1, top_idx[..., None].expand(l, pre, 4))
    keep = greedy_nms_mask(top_boxes, top_scores, top_valid, iou_thresh)
    kscore = torch.where(keep, top_scores, torch.full_like(top_scores, NEG_INF))
    _, sel = sort_desc(kscore, dim=1)
    sel = sel[:, :min(post_topn, pre)]
    out_idx = top_idx.gather(1, sel)
    out_valid = keep.gather(1, sel)
    if post_topn > pre:
        pad = post_topn - pre
        out_idx = torch.cat([out_idx, out_idx.new_zeros((l, pad))], 1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((l, pad))], 1)
    return out_idx, out_valid


def perclass_nms(boxes: Tensor, valid: Tensor, iou_thresh: float) -> Tensor:
    """Rank-sequential greedy pass: boxes [..., K, 4] sorted by descending
    score along K, valid [..., K] -> keep [..., K]."""
    k = boxes.shape[-2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    ar = area(boxes)
    col = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        bx1, by1 = x1[..., i:i + 1], y1[..., i:i + 1]
        bx2, by2 = x2[..., i:i + 1], y2[..., i:i + 1]
        iw = torch.minimum(bx2, x2) - torch.maximum(bx1, x1) + 1.0
        ih = torch.minimum(by2, y2) - torch.maximum(by1, y1) + 1.0
        inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
        iou = inter / torch.clamp(ar[..., i:i + 1] + ar - inter, min=1e-8)
        kill = (iou > iou_thresh) & (col > i) & keep[..., i:i + 1]
        keep = keep & ~kill
    return keep


def per_class_nms_mask(boxes_per_cls: Tensor, probs: Tensor, valid: Tensor,
                       iou_thresh: float = 0.3, score_thresh: float = 0.05,
                       per_class_topk: int | None = 256) -> Tensor:
    """Per-class NMS keep mask [B, N, C] (background never kept; classes
    whose best valid score is <= score_thresh dropped), each class's NMS
    over its top `per_class_topk` candidates."""
    b, n, c = probs.shape
    k = per_class_topk
    if k is None or k >= n:
        lanes_boxes = boxes_per_cls.permute(0, 2, 1, 3).reshape(b * c, n, 4)
        lanes_probs = probs.permute(0, 2, 1).reshape(b * c, n)
        lanes_valid = valid[:, None, :].expand(b, c, n).reshape(b * c, n)
        keep = greedy_nms_mask(lanes_boxes, lanes_probs, lanes_valid, iou_thresh)
        keep = keep.reshape(b, c, n)
    else:
        p = torch.where(valid[:, :, None], probs, torch.full_like(probs, -1.0))
        top_p, top_i = sort_desc(p.transpose(1, 2), dim=2)
        top_p, top_i = top_p[..., :k], top_i[..., :k]
        bc = boxes_per_cls.permute(0, 2, 1, 3).gather(
            2, top_i[..., None].expand(b, c, k, 4))
        keep_k = perclass_nms(bc, top_p >= 0.0, iou_thresh)
        keep = torch.zeros((b, c, n), dtype=torch.bool, device=probs.device)
        keep = keep.scatter(2, top_i, keep_k)
    keep = keep.transpose(1, 2)
    cls_ok = torch.amax(torch.where(valid[:, :, None], probs,
                                    torch.zeros_like(probs)), dim=1) > score_thresh
    keep = keep & cls_ok[:, None, :]
    keep[..., 0] = False
    return keep
