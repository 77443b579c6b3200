"""The detector-training samplers (a copy of the port's ops/sampling.py):
the RPN's anchor targets and the detector's RoI sample, as masked
fixed-shape tensor code batched over images. "Choose k of n uniformly" is
"rank by iid uniform noise, keep rank < k"; the draws are made at fixed
shapes, so one generator stays in step with the port's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.reference import common as C
from benchmark.reference.boxes import bbox_overlaps
from benchmark.reference.common import rand_rows
from benchmark.reference.nms import sort_desc

Tensor = torch.Tensor


class AnchorTargets(NamedTuple):
    labels: Tensor        # [B, H, W, A] int64 in {-1 ignore, 0 bg, 1 fg}
    target_boxes: Tensor  # [B, H, W, A, 4] matched GT box (meaningful where fg)


class DetSample(NamedTuple):
    rois: Tensor     # [B, S, 4] the sampled boxes (candidates gathered by idx)
    labels: Tensor   # [B, S] int64 class (0 = bg)
    targets: Tensor  # [B, S, 4] matched GT boxes (meaningful where labels > 0)
    valid: Tensor    # [B, S] bool
    idx: Tensor      # [B, S] int64 index into the candidates (proposals, then GT)


def _topk_pad(score: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Row-wise top k of [B, N] (ties: lower index first) that tolerates
    k > N: pads with value 0 and index 0."""
    vals, idx = sort_desc(score, dim=1)
    n = score.shape[1]
    if k <= n:
        return vals[:, :k], idx[:, :k]
    pad = k - n
    return (torch.cat([vals, vals.new_zeros((score.shape[0], pad))], 1),
            torch.cat([idx, idx.new_zeros((score.shape[0], pad))], 1))


def _rank_among(noise: Tensor, cand: Tensor) -> Tensor:
    """Rank of each candidate of a [B, N] row among the row's candidates,
    by ascending noise; non-candidates get rank N."""
    n = cand.shape[1]
    key = torch.where(cand, noise, torch.full_like(noise, float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices
    ar = torch.arange(n, device=cand.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(1, order, ar)
    return torch.where(cand, ranks, torch.full_like(ranks, n))


def anchor_targets_from_draws(u_fg: Tensor, u_bg: Tensor, anchors: Tensor,
                              gt_boxes: Tensor, gt_mask: Tensor,
                              im_hw: Tensor) -> AnchorTargets:
    """RPN anchor labels: anchors outside the image are ignored; positives
    are each GT's best anchors (ties included) and anchors of IoU >= 0.7;
    negatives have max IoU < 0.3; up to 128 positives are kept, then
    negatives fill to 256. The label grid is dense: the RPN loss is a
    masked reduction over it (-1 contributes nothing).

    anchors [H, W, A, 4], gt_boxes [B, G, 4], gt_mask [B, G], im_hw [B, 2];
    draws u_fg, u_bg [B, H*W*A] uniform in [0, 1)."""
    grid = anchors.shape[:3]
    a = anchors.reshape(-1, 4)
    b, n = gt_boxes.shape[0], a.shape[0]
    inside = ((a[:, 0] >= 0) & (a[:, 1] >= 0)
              & (a[None, :, 2] < im_hw[:, 1:2]) & (a[None, :, 3] < im_hw[:, 0:1]))
    iou = bbox_overlaps(a.expand(b, n, 4), gt_boxes, mask_b=gt_mask) * inside[..., None]
    anchor_to_gt = torch.argmax(iou, dim=2)            # first maximum, as jnp
    max_ov = iou.amax(dim=2)
    gt_max = iou.amax(dim=1, keepdim=True)             # [B, 1, G]
    is_gt_best = ((iou == gt_max) & (gt_max > 0) & gt_mask[:, None, :]).any(2)

    fg = inside & (is_gt_best | (max_ov >= C.RPN_POSITIVE_OVERLAP))
    bg = inside & (max_ov < C.RPN_NEGATIVE_OVERLAP) & ~fg
    keep_fg = fg & (_rank_among(u_fg, fg) < int(C.RPN_FG_FRACTION * C.RPN_BATCHSIZE))
    num_fg = keep_fg.sum(1, keepdim=True)
    keep_bg = bg & (_rank_among(u_bg, bg) < C.RPN_BATCHSIZE - num_fg)
    labels = torch.where(keep_fg, 1, torch.where(keep_bg, 0, -1))
    targets = gt_boxes.gather(1, anchor_to_gt[..., None].expand(b, n, 4))
    return AnchorTargets(labels.reshape(b, *grid), targets.reshape(b, *grid, 4))


def anchor_targets(anchors: Tensor, gt_boxes: Tensor, gt_mask: Tensor,
                   im_hw: Tensor, generator: Optional[torch.Generator] = None
                   ) -> AnchorTargets:
    """`anchor_targets_from_draws` with its uniforms from `generator`."""
    shape = (gt_boxes.shape[0], anchors[..., 0].numel())
    u = [rand_rows(shape, generator, gt_boxes.device) for _ in range(2)]
    return anchor_targets_from_draws(*u, anchors, gt_boxes, gt_mask, im_hw)


def proposal_assign_det_from_draws(u_fg: Tensor, u_bg: Tensor, u_pick: Tensor,
                                   rois: Tensor, roi_valid: Tensor,
                                   gt_boxes: Tensor, gt_classes: Tensor,
                                   gt_mask: Tensor, fg_thresh: float = 0.5,
                                   rois_per_img: int = C.ROIS_PER_IMG,
                                   fg_fraction: float = C.FG_FRACTION) -> DetSample:
    """The detector's RoI sample: the candidates are the proposals and the
    GT boxes; up to `rois_per_img * fg_fraction` fg (IoU >= fg_thresh with
    a GT box), then bg (IoU in [BG_THRESH_LO, BG_THRESH_HI)) to
    `rois_per_img`, fg first, each class in noise order. The sampled boxes
    are gathered from `rois`, so a gradient on them reaches the proposals.

    rois [B, S, 4], roi_valid [B, S], gt_* [B, G, ...]; draws u_fg, u_bg,
    u_pick [B, S + G] uniform in [0, 1)."""
    all_boxes = torch.cat([rois, gt_boxes.to(rois.dtype)], 1)
    all_valid = torch.cat([roi_valid, gt_mask], 1)
    iou = bbox_overlaps(all_boxes.detach(), gt_boxes, all_valid, gt_mask)
    max_ov = iou.amax(dim=2)
    gt_assign = torch.argmax(iou, dim=2)
    fg = all_valid & (max_ov >= fg_thresh)
    bg = all_valid & (max_ov < C.BG_THRESH_HI) & (max_ov >= C.BG_THRESH_LO) & ~fg

    keep_fg = fg & (_rank_among(u_fg, fg) < int(round(rois_per_img * fg_fraction)))
    num_fg = keep_fg.sum(1, keepdim=True)
    keep_bg = bg & (_rank_among(u_bg, bg) < rois_per_img - num_fg)
    score = torch.where(keep_fg, 2.0 + u_pick,
                        torch.where(keep_bg, 1.0 + u_pick, torch.zeros_like(u_pick)))
    vals, idx = _topk_pad(score, rois_per_img)
    valid = vals > 0.5
    assign = gt_assign.gather(1, idx)
    labels = torch.where(keep_fg.gather(1, idx) & valid,
                         gt_classes.long().gather(1, assign), 0)
    b, s = idx.shape
    return DetSample(rois=all_boxes.gather(1, idx[..., None].expand(b, s, 4)),
                     labels=labels,
                     targets=gt_boxes.gather(1, assign[..., None].expand(b, s, 4)),
                     valid=valid, idx=idx)


def proposal_assign_det(rois: Tensor, roi_valid: Tensor, gt_boxes: Tensor,
                        gt_classes: Tensor, gt_mask: Tensor, fg_thresh: float = 0.5,
                        rois_per_img: int = C.ROIS_PER_IMG,
                        fg_fraction: float = C.FG_FRACTION,
                        generator: Optional[torch.Generator] = None) -> DetSample:
    """`proposal_assign_det_from_draws` with its uniforms from `generator`."""
    shape = (rois.shape[0], rois.shape[1] + gt_boxes.shape[1])
    u = [rand_rows(shape, generator, rois.device) for _ in range(3)]
    return proposal_assign_det_from_draws(*u, rois, roi_valid, gt_boxes, gt_classes,
                                          gt_mask, fg_thresh, rois_per_img, fg_fraction)
