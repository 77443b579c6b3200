"""MotifNet (VGG16) in sgdet and predcls, the eval path (a copy of the
port's models/rel_model.py), in f32. `forward` runs the model free, as the
program does (the control runs it at fp8); `judge.py` drives its parts
along a judged run's decisions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from benchmark.reference import boxes as box_ops
from benchmark.reference.backbone import VGGRoIHead, to_nchw, to_nhwc
from benchmark.reference.common import FEAT_STRIDE, Conv2d, Linear
from benchmark.reference.context import LinearizedContext, MaskedBatchNorm
from benchmark.reference.detector import ObjectDetector, _take
from benchmark.reference.nms import sort_desc
from benchmark.reference.roi_align import roi_align
from benchmark.reference.union_boxes import draw_union_boxes

Tensor = torch.Tensor


def all_pair_indices(num_objs: int, device=None) -> tuple[Tensor, Tensor]:
    k = torch.arange(num_objs * (num_objs - 1), device=device)
    sub = torch.div(k, num_objs - 1, rounding_mode="floor")
    j = k % (num_objs - 1)
    return sub, j + (j >= sub).long()


class UnionVGGHead(nn.Module):
    def __init__(self, pooling_dim: int = 4096, fc_dim: int = 4096,
                 in_dim: int = 7 * 7 * 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc0 = Linear(in_dim, fc_dim, dtype=dtype)
        if pooling_dim == fc_dim:
            self.fc1 = Linear(fc_dim, fc_dim, dtype=dtype)
        else:
            self.proj = Linear(fc_dim, pooling_dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = torch.relu(self.fc0(x.reshape(x.shape[:-3] + (-1,))))
        return (self.fc1 if hasattr(self, "fc1") else self.proj)(x)


class UnionBoxesAndFeats(nn.Module):
    """Union-box RoIAlign plus the rasterized 27x27 pair masks through the
    mask conv net (eval BatchNorms), summed: [B, P, 7, 7, dim]."""

    def __init__(self, pooling_size: int = 7, dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pooling_size = pooling_size
        self.dim = dim
        self.convs = nn.ModuleList([
            Conv2d(2, dim // 2, 7, stride=2, padding=3, dtype=dtype),
            Conv2d(dim // 2, dim, 3, padding=1, dtype=dtype)])
        self.bns = nn.ModuleList([MaskedBatchNorm(dim // 2), MaskedBatchNorm(dim)])

    def forward(self, fmap: Tensor, boxes: Tensor, pair_sub: Tensor,
                pair_obj: Tensor, pair_valid: Tensor) -> Tensor:
        sub_boxes = _take(boxes, pair_sub)
        obj_boxes = _take(boxes, pair_obj)
        union = box_ops.union_box(sub_boxes, obj_boxes)
        pools = roi_align(fmap, union, pair_valid, self.pooling_size, 1.0 / FEAT_STRIDE)
        s = self.pooling_size * 4 - 1
        masks = draw_union_boxes(torch.cat([sub_boxes, obj_boxes], -1), s) - 0.5
        b, p = masks.shape[:2]
        x = masks.reshape(b * p, 2, s, s)
        x = torch.relu(self.convs[0](x))
        x = to_nchw(self.bns[0](to_nhwc(x)))
        x = nn.functional.max_pool2d(x, 3, stride=2, padding=1)
        x = torch.relu(self.convs[1](x))
        x = self.bns[1](to_nhwc(x))
        x = x.reshape(b, p, self.pooling_size, self.pooling_size, self.dim)
        return pools + x


class RelPairs(NamedTuple):
    sub: Tensor
    obj: Tensor
    valid: Tensor


class SGPrediction(NamedTuple):
    boxes: Tensor
    obj_classes: Tensor
    obj_scores: Tensor
    obj_valid: Tensor
    rel_inds: Tensor
    rel_scores: Tensor
    rel_valid: Tensor
    num_valid_pairs: Tensor


def rel_pairs(rm_valid: Tensor, rm_boxes: Tensor, obj_scores: Optional[Tensor],
              budget: int, require_overlap: bool) -> tuple[RelPairs, Tensor]:
    """All ordered pairs (sgdet: overlapping only), compacted to the
    `budget` pairs of largest object-score product; and the valid count."""
    b, o = rm_valid.shape
    sub, obj = all_pair_indices(o, rm_valid.device)
    sub, obj = sub.expand(b, -1), obj.expand(b, -1)
    valid = rm_valid.gather(1, sub) & rm_valid.gather(1, obj)
    if require_overlap:
        iou = box_ops.bbox_overlaps(rm_boxes, rm_boxes, rm_valid, rm_valid)
        pair_iou = iou.reshape(b, o * o).gather(1, sub * o + obj)
        valid = valid & (pair_iou > 0)
    n_valid = valid.sum(dim=1)
    if budget < sub.shape[1]:
        sc = (obj_scores if obj_scores is not None
              else torch.ones(rm_valid.shape, device=rm_valid.device))
        prod = sc.gather(1, sub) * sc.gather(1, obj)
        key = torch.where(valid, 1.0 + prod, torch.zeros_like(prod))
        top_key, idx = sort_desc(key, dim=1)
        idx = idx[:, :budget]
        sub, obj = sub.gather(1, idx), obj.gather(1, idx)
        valid = top_key[:, :budget] > 0.5
    return RelPairs(sub=sub, obj=obj, valid=valid), n_valid


class RelModel(nn.Module):
    """MotifNet, VGG16, in `mode` 'sgdet' (refinerels detector) or
    'predcls' (gtbox), with the port's parameter names."""

    def __init__(self, num_classes: int, num_rels: int, mode: str, embed_dim: int,
                 hidden_dim: int, pooling_dim: int, obj_dim: int, nl_obj: int,
                 nl_edge: int, order: str, use_bias: bool, budgets,
                 thresh: float = 0.01, dtype: torch.dtype = torch.bfloat16,
                 union_chunk: int = 512):
        super().__init__()
        self.mode = mode
        self.num_classes = num_classes
        self.pooling_dim = pooling_dim
        self.use_bias = use_bias
        self.require_overlap = mode == "sgdet"
        self.budgets = budgets
        self.union_chunk = union_chunk
        self.detector = ObjectDetector(
            num_classes=num_classes, mode="refinerels" if mode == "sgdet" else "gtbox",
            max_per_img=budgets.objs_per_img, thresh=thresh, obj_dim=obj_dim,
            dtype=dtype, budgets=budgets)
        self.context = LinearizedContext(
            num_classes=num_classes, embed_dim=embed_dim, hidden_dim=hidden_dim,
            obj_dim=obj_dim, nl_obj=nl_obj, nl_edge=nl_edge, order=order, mode=mode)
        self.union_boxes = UnionBoxesAndFeats(pooling_size=7, dim=512, dtype=dtype)
        self.roi_fmap = UnionVGGHead(pooling_dim=pooling_dim, fc_dim=obj_dim, dtype=dtype)
        self.roi_fmap_obj = VGGRoIHead(fc_dim=obj_dim, dtype=dtype)
        self.post_lstm = Linear(hidden_dim, pooling_dim * 2, dtype=dtype)
        self.rel_compress = Linear(pooling_dim, num_rels, dtype=dtype)
        if use_bias:
            self.freq_bias = nn.Parameter(torch.zeros(num_classes ** 2, num_rels))

    def obj_features(self, fmap: Tensor, boxes: Tensor, valid: Tensor) -> Tensor:
        return self.roi_fmap_obj(roi_align(fmap, boxes, valid, 7, 1.0 / FEAT_STRIDE)).float()

    def visual_rep(self, fmap: Tensor, boxes: Tensor, pairs: RelPairs) -> Tensor:
        p_total = pairs.sub.shape[1]
        parts = []
        for s0 in range(0, p_total, self.union_chunk):
            sl = slice(s0, min(s0 + self.union_chunk, p_total))
            up = self.union_boxes(fmap, boxes, pairs.sub[:, sl], pairs.obj[:, sl],
                                  pairs.valid[:, sl])
            parts.append(self.roi_fmap(up))
        return torch.cat(parts, dim=1)

    def rel_dists(self, fmap: Tensor, boxes: Tensor, edge_ctx: Tensor,
                  obj_preds: Tensor, pairs: RelPairs) -> Tensor:
        edge_rep = self.post_lstm(edge_ctx)
        edge_rep = edge_rep.reshape(edge_rep.shape[:-1] + (2, self.pooling_dim))
        prod_rep = (_take(edge_rep[..., 0, :], pairs.sub)
                    * _take(edge_rep[..., 1, :], pairs.obj))
        prod_rep = prod_rep * self.visual_rep(fmap, boxes, pairs)
        rel_dists = self.rel_compress(prod_rep).float()
        if self.use_bias:
            sub_cls = obj_preds.gather(1, pairs.sub)
            obj_cls = obj_preds.gather(1, pairs.obj)
            rel_dists = rel_dists + self.freq_bias[sub_cls * self.num_classes + obj_cls]
        return rel_dists

    @torch.no_grad()
    def forward(self, images: Tensor, im_hw: Tensor, gt_boxes=None, gt_classes=None,
                gt_mask=None) -> tuple[SGPrediction, dict]:
        """The eval forward: the SGPrediction and the intermediates that the
        judgement reads (as the benchmark captures them from the program)."""
        if gt_classes is not None:
            gt_classes = gt_classes.long()
        det = self.detector(images, im_hw, gt_boxes, gt_classes, gt_mask)
        boxes, valid, fmap = det.rm_boxes, det.rm_valid, det.fmap
        pairs, n_valid = rel_pairs(valid, boxes, det.obj_scores,
                                   self.budgets.max_pairs_eval, self.require_overlap)
        obj_fmap = self.obj_features(fmap, boxes, valid)
        obj_labels = det.rm_obj_labels if self.mode == "predcls" else None
        ctx = self.context(obj_fmap, det.rm_obj_dists, boxes, valid,
                           obj_labels=obj_labels, boxes_per_cls=det.boxes_all)
        rel = self.rel_dists(fmap, boxes, ctx.edge_ctx, ctx.obj_preds, pairs)
        pred = decode(self.mode, det, ctx.obj_dists, ctx.obj_preds, pairs, rel, n_valid)
        return pred, capture_of(det, ctx)


DET_FIELDS = ("od_rois", "od_valid", "od_obj_dists", "od_box_deltas", "rm_boxes",
              "rm_valid", "rm_fmap_idx", "obj_scores", "obj_preds", "boxes_all",
              "rpn_feats")


def capture_det(det) -> dict:
    """The detector's intermediates that the judgement reads, from a
    DetectorOutput (the program's or the control's)."""
    return {f"det_{n}": getattr(det, n) for n in DET_FIELDS if getattr(det, n) is not None}


def capture_of(det, ctx) -> dict:
    """capture_det's, and the context's object logits and classes."""
    out = capture_det(det)
    out["ctx_obj_dists"] = ctx.obj_dists
    out["ctx_obj_preds"] = ctx.obj_preds
    return out


def decode(mode: str, det, obj_dists: Tensor, obj_preds: Tensor, pairs: RelPairs,
           rel_dists: Tensor, num_valid_pairs: Tensor) -> SGPrediction:
    probs = torch.softmax(obj_dists, dim=-1)
    obj_scores = probs.gather(-1, obj_preds[..., None])[..., 0]
    b, o = obj_preds.shape
    if mode == "sgdet" and det.boxes_all is not None:
        bboxes = det.boxes_all.gather(
            2, obj_preds[..., None, None].expand(b, o, 1, 4))[..., 0, :]
    else:
        bboxes = det.rm_boxes
    rel_rep = torch.softmax(rel_dists, dim=-1)
    s0 = obj_scores.gather(1, pairs.sub)
    s1 = obj_scores.gather(1, pairs.obj)
    max_rel = torch.amax(rel_rep[..., 1:], dim=-1)
    triplet = torch.where(pairs.valid, max_rel * s0 * s1, torch.full_like(max_rel, -1.0))
    _, order = sort_desc(triplet, dim=1)
    rel_inds = torch.stack([pairs.sub.gather(1, order), pairs.obj.gather(1, order)], -1)
    return SGPrediction(
        boxes=bboxes, obj_classes=obj_preds, obj_scores=obj_scores,
        obj_valid=det.rm_valid, rel_inds=rel_inds, rel_scores=_take(rel_rep, order),
        rel_valid=pairs.valid.gather(1, order), num_valid_pairs=num_valid_pairs)
