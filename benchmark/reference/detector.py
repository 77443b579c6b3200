"""The VGG16 object detector (a copy of the port's models/detector.py) in
the modes the benchmark runs: 'rpntrain' (detector training, and its eval
path 'refinerels'), 'refinerels' (sgdet) and 'gtbox' (predcls / sgcls).
Each forward returns every intermediate that the benchmark judges, so
that the control (this code at fp8) is judged as the program is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from benchmark.reference import boxes as box_ops
from benchmark.reference.anchors import generate_anchors
from benchmark.reference.backbone import VGG16Features, VGGRoIHead, to_nchw, to_nhwc
from benchmark.reference.common import (FEAT_STRIDE, IMAGENET_MEAN, IMAGENET_STD,
                                        NUM_ANCHORS, Conv2d)
from benchmark.reference.nms import nms_topk, per_class_nms_mask, sort_desc
from benchmark.reference.roi_align import roi_align
from benchmark.reference.sampling import anchor_targets, proposal_assign_det

Tensor = torch.Tensor


class DetectorOutput(NamedTuple):
    fmap: Tensor
    od_rois: Tensor
    od_valid: Tensor
    od_obj_dists: Tensor
    rm_boxes: Tensor
    rm_valid: Tensor
    rm_obj_dists: Tensor
    rm_obj_labels: Optional[Tensor]
    rm_fmap_idx: Optional[Tensor]
    obj_preds: Optional[Tensor]
    obj_scores: Optional[Tensor]
    boxes_all: Optional[Tensor]
    od_box_deltas: Optional[Tensor] = None
    od_labels: Optional[Tensor] = None
    od_box_targets: Optional[Tensor] = None
    rpn_feats: Optional[Tensor] = None
    rpn_labels: Optional[Tensor] = None
    rpn_target_boxes: Optional[Tensor] = None
    anchors: Optional[Tensor] = None
    det_sample: Optional[object] = None
    prop_idx: Optional[Tensor] = None     # [B, post_topn] anchor index of each proposal
    prop_valid: Optional[Tensor] = None   # [B, post_topn]
    own_samples: Optional[tuple] = None   # training: this run's own two samples


class RPNHead(nn.Module):
    def __init__(self, dim: int = 512, num_anchors: int = NUM_ANCHORS,
                 in_dim: int = 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_anchors = num_anchors
        self.convs = nn.ModuleList([
            Conv2d(in_dim, dim, 3, padding=1, dtype=dtype),
            Conv2d(dim, num_anchors * 6, 1, dtype=dtype)])

    def forward(self, fmap: Tensor) -> Tensor:
        x = to_nchw(fmap)
        x = torch.clamp(torch.relu(self.convs[0](x)), max=6.0)
        x = to_nhwc(self.convs[1](x))
        b, h, w, _ = x.shape
        return x.reshape(b, h, w, self.num_anchors, 6).float()


def rpn_boxes(rpn_feats: Tensor, anchors: Tensor, im_hw: Tensor
              ) -> tuple[Tensor, Tensor, Tensor]:
    """The RPN grid decoded: (boxes [B, N, 4] clipped, objectness [B, N],
    valid [B, N]: cells inside the image, boxes of at least 4 px)."""
    b, h, w, a, _ = rpn_feats.shape
    probs = torch.softmax(rpn_feats[..., :2], dim=-1)[..., 1]
    deltas = rpn_feats[..., 2:]
    boxes = box_ops.bbox_preds(anchors.reshape(1, -1, 4), deltas.reshape(b, -1, 4))
    boxes = box_ops.clip_boxes(boxes, im_hw[:, None, 0], im_hw[:, None, 1])
    rows = torch.div(im_hw[:, 0], FEAT_STRIDE, rounding_mode="floor")
    cols = torch.div(im_hw[:, 1], FEAT_STRIDE, rounding_mode="floor")
    row_ok = torch.arange(h, device=im_hw.device)[None, :] < rows[:, None]
    col_ok = torch.arange(w, device=im_hw.device)[None, :] < cols[:, None]
    cell_ok = row_ok[:, :, None] & col_ok[:, None, :]
    valid = cell_ok[..., None].expand(b, h, w, a).reshape(b, -1)
    wh = box_ops.center_size(boxes)[..., 2:4]
    valid = valid & (wh[..., 0] >= 4) & (wh[..., 1] >= 4)
    return boxes, probs.reshape(b, -1), valid


def rpn_proposals(rpn_feats: Tensor, anchors: Tensor, im_hw: Tensor,
                  pre_topn: int, post_topn: int, nms_thresh: float = 0.7
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """(proposals [B, post_topn, 4], valid, their anchor indices)."""
    boxes, probs, valid = rpn_boxes(rpn_feats, anchors, im_hw)
    b = boxes.shape[0]
    idx, ok = nms_topk(boxes, probs, valid, nms_thresh, pre_topn, post_topn)
    return boxes.gather(1, idx[..., None].expand(b, idx.shape[1], 4)), ok, idx


def decode_boxes_all(rois: Tensor, deltas: Tensor, im_hw: Tensor) -> Tensor:
    b, s, nc, _ = deltas.shape
    rep = rois[:, :, None, :].expand(b, s, nc, 4).reshape(b, -1, 4)
    out = box_ops.bbox_preds(rep, deltas.reshape(b, -1, 4))
    out = box_ops.clip_boxes(out, im_hw[:, None, 0], im_hw[:, None, 1])
    return out.reshape(b, s, nc, 4)


def filter_det(probs: Tensor, boxes_all: Tensor, valid: Tensor,
               max_per_img: int, thresh: float, nms_thresh: float = 0.3,
               per_class_topk: int | None = 256):
    keep = per_class_nms_mask(boxes_all, probs, valid, nms_thresh, thresh,
                              per_class_topk=per_class_topk)
    dists = probs * keep
    scores_pre = torch.amax(dists, dim=2)
    labels_pre = torch.argmax(dists, dim=2)
    score = torch.where(scores_pre > thresh, scores_pre, torch.zeros_like(scores_pre))
    top_scores, idx = sort_desc(score, dim=1)
    top_scores, idx = top_scores[:, :max_per_img], idx[:, :max_per_img]
    ok = top_scores > thresh
    return idx, top_scores, labels_pre.gather(1, idx), ok


def _take(x: Tensor, idx: Tensor) -> Tensor:
    shape = idx.shape + x.shape[2:]
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape))


def normalize_uint8(images: Tensor, im_hw: Tensor) -> Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    hh = torch.arange(images.shape[1], device=images.device)[None, :, None]
    ww = torch.arange(images.shape[2], device=images.device)[None, None, :]
    inside = (hh < im_hw[:, 0, None, None]) & (ww < im_hw[:, 1, None, None])
    return x * inside[..., None]


class ObjectDetector(nn.Module):
    """VGG16 detector: 'rpntrain', 'refinerels' or 'gtbox'."""

    def __init__(self, num_classes: int, mode: str, max_per_img: int = 64,
                 thresh: float = 0.05, obj_dim: int = 4096,
                 dtype: torch.dtype = torch.bfloat16, budgets=None):
        super().__init__()
        self.num_classes = num_classes
        self.mode = mode
        self.max_per_img = max_per_img
        self.thresh = thresh
        self.budgets = budgets
        self.features = VGG16Features(dtype=dtype)
        self.roi_head = VGGRoIHead(fc_dim=obj_dim, dtype=dtype)
        self.score_fc = nn.Linear(obj_dim, num_classes)
        if mode != "gtbox":
            self.bbox_fc = nn.Linear(obj_dim, num_classes * 4)
            self.rpn_head = RPNHead(dtype=dtype)

    def anchors(self, im_h: int, im_w: int, device) -> Tensor:
        return torch.as_tensor(generate_anchors(im_scale=(im_h, im_w)), device=device)

    def obj_feature_map(self, fmap: Tensor, rois: Tensor, valid: Tensor,
                        train: bool = False,
                        generator: Optional[torch.Generator] = None) -> Tensor:
        pooled = roi_align(fmap, rois, valid, 7, 1.0 / FEAT_STRIDE)
        return self.roi_head(pooled, train=train, generator=generator).float()

    def forward(self, images: Tensor, im_hw: Tensor, gt_boxes=None, gt_classes=None,
                gt_mask=None) -> DetectorOutput:
        """The eval forward ('refinerels' for rpntrain and refinerels)."""
        images = normalize_uint8(images, im_hw) if images.dtype == torch.uint8 else images
        fmap = self.features(images)
        if self.mode == "gtbox":
            od = self.score_fc(self.obj_feature_map(fmap, gt_boxes, gt_mask))
            return DetectorOutput(
                fmap=fmap, od_rois=gt_boxes, od_valid=gt_mask, od_obj_dists=od,
                rm_boxes=gt_boxes, rm_valid=gt_mask, rm_obj_dists=od,
                rm_obj_labels=gt_classes, rm_fmap_idx=None, obj_preds=None,
                obj_scores=None, boxes_all=None)
        anchors = self.anchors(images.shape[1], images.shape[2], images.device)
        rpn_feats = self.rpn_head(fmap)
        rois, roi_valid, prop_idx = rpn_proposals(
            rpn_feats, anchors, im_hw, self.budgets.rpn_pre_nms_topn_test,
            self.budgets.rpn_post_nms_topn_test)
        return self.detect(fmap, rois, roi_valid, im_hw, rpn_feats=rpn_feats,
                           prop_idx=prop_idx, anchors=anchors)

    def detect(self, fmap: Tensor, rois: Tensor, roi_valid: Tensor, im_hw: Tensor,
               **extra) -> DetectorOutput:
        """RoI heads over the proposals, then the per-class NMS decode."""
        obj_fmap = self.obj_feature_map(fmap, rois, roi_valid)
        od_obj_dists = self.score_fc(obj_fmap)
        b, s = rois.shape[:2]
        od_box_deltas = self.bbox_fc(obj_fmap).reshape(b, s, self.num_classes, 4)
        probs = torch.softmax(od_obj_dists, dim=-1)
        boxes_all = decode_boxes_all(rois, od_box_deltas, im_hw)
        idx, scores, classes, ok = filter_det(
            probs, boxes_all, roi_valid, self.max_per_img, self.thresh,
            per_class_topk=self.budgets.per_class_nms_topk)
        rm_boxes = _take(rois, idx)
        boxes_all_out = _take(boxes_all, idx).clone()
        boxes_all_out[:, :, 0, :] = rm_boxes
        return DetectorOutput(
            fmap=fmap, od_rois=rois, od_valid=roi_valid, od_obj_dists=od_obj_dists,
            rm_boxes=rm_boxes, rm_valid=ok, rm_obj_dists=_take(od_obj_dists, idx),
            rm_obj_labels=None, rm_fmap_idx=idx, obj_preds=classes, obj_scores=scores,
            boxes_all=boxes_all_out, od_box_deltas=od_box_deltas, **extra)

    def forward_train(self, images: Tensor, im_hw: Tensor, gt_boxes: Tensor,
                      gt_classes: Tensor, gt_mask: Tensor,
                      generator: Optional[torch.Generator] = None,
                      forced: Optional[dict] = None) -> DetectorOutput:
        """The detector-training forward. The sampler's draws are always made
        from `generator`, in the port's order; `forced` (the judged run's
        `prop_idx`, `prop_valid`, `rpn_labels`, `rpn_target_boxes` and
        `det_idx`, `det_labels`, `det_targets`, `det_valid`) replaces the
        proposals' selection and the two samples with that run's, the
        proposal boxes decoded from this model's own RPN deltas; the
        samplers then run on that run's own proposal boxes (`props`), and
        what they draw is returned as `own_samples` beside the forced ones."""
        images = normalize_uint8(images, im_hw) if images.dtype == torch.uint8 else images
        fmap = self.features(images)
        anchors = self.anchors(images.shape[1], images.shape[2], images.device)
        rpn_feats = self.rpn_head(fmap)
        bud = self.budgets
        if forced is None:
            props, prop_valid, prop_idx = rpn_proposals(
                rpn_feats, anchors, im_hw, bud.rpn_pre_nms_topn_train,
                bud.rpn_post_nms_topn_train)
            sample_props = props
        else:
            boxes, _, _ = rpn_boxes(rpn_feats, anchors, im_hw)
            prop_idx, prop_valid = forced["prop_idx"], forced["prop_valid"]
            b = boxes.shape[0]
            props = boxes.gather(1, prop_idx[..., None].expand(b, prop_idx.shape[1], 4))
            sample_props = forced["props"]
        a_t = anchor_targets(anchors, gt_boxes, gt_mask, im_hw, generator=generator)
        d_s = proposal_assign_det(sample_props.detach(), prop_valid, gt_boxes, gt_classes,
                                  gt_mask, rois_per_img=bud.rois_per_img,
                                  generator=generator)
        own_samples = (a_t, d_s)
        if forced is not None:
            a_t = a_t._replace(labels=forced["rpn_labels"],
                               target_boxes=forced["rpn_target_boxes"])
            d_s = d_s._replace(idx=forced["det_idx"], labels=forced["det_labels"],
                               targets=forced["det_targets"], valid=forced["det_valid"])
        cand = torch.cat([props, gt_boxes.to(props.dtype)], 1)
        b, s = d_s.idx.shape
        rois = cand.gather(1, d_s.idx[..., None].expand(b, s, 4))
        obj_fmap = self.obj_feature_map(fmap, rois, d_s.valid, train=True,
                                        generator=generator)
        od_obj_dists = self.score_fc(obj_fmap)
        od_box_deltas = self.bbox_fc(obj_fmap).reshape(b, s, self.num_classes, 4)
        return DetectorOutput(
            fmap=fmap, od_rois=rois, od_valid=d_s.valid, od_obj_dists=od_obj_dists,
            rm_boxes=rois, rm_valid=d_s.valid, rm_obj_dists=od_obj_dists,
            rm_obj_labels=d_s.labels, rm_fmap_idx=None, obj_preds=None, obj_scores=None,
            boxes_all=None, od_box_deltas=od_box_deltas, od_labels=d_s.labels,
            od_box_targets=d_s.targets, rpn_feats=rpn_feats, rpn_labels=a_t.labels,
            rpn_target_boxes=a_t.target_boxes, anchors=anchors, det_sample=d_s,
            prop_idx=prop_idx, prop_valid=prop_valid, own_samples=own_samples)
