"""The detector-training losses (a copy of the port's training/losses.py),
masked over the padded layouts, in one process."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference import common as C
from benchmark.reference.boxes import bbox_encode, smooth_l1
from benchmark.reference.common import all_sum

Tensor = torch.Tensor


def global_counts(*masks: Tensor) -> Tensor:
    """The global batch's count of each mask's selected rows, f32 [len(masks)]
    (one all-reduce for them all)."""
    return all_sum(torch.stack([m.sum() for m in masks]).float())


def masked_ce(logits: Tensor, labels: Tensor, mask: Tensor, count: Tensor) -> Tensor:
    """Mean cross-entropy over the mask-selected rows of the global batch
    (0 with none); `count`: their global count (`global_counts`)."""
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         labels.reshape(-1).long(), reduction="none")
    m = mask.reshape(-1).to(ce.dtype)
    return (ce * m).sum() / torch.clamp(count, min=1.0)


def masked_bbox_loss(priors: Tensor, deltas: Tensor, targets: Tensor,
                     mask: Tensor, count: Tensor, eps: float = 1e-4) -> Tensor:
    """Smooth-L1 of the deltas against the targets encoded on the priors,
    summed over the mask-selected rows / (eps + `count`, their global count)."""
    per = smooth_l1(deltas - bbox_encode(priors, targets)).sum(-1) * mask.to(deltas.dtype)
    return per.sum() / (eps + count)


def detector_losses(out) -> dict[str, Tensor]:
    """Detector-training losses of an rpntrain DetectorOutput: the RoI
    class CE over the sampled RoIs; the box loss of each fg RoI's labelled
    class, times 2 / FG_FRACTION * (fg share of the sample); the RPN's
    binary CE over the sampled anchors; its box loss over the fg anchors,
    times 2 / RPN_FG_FRACTION * (fg share). The targets are encoded on the
    sampled RoIs themselves, which stay on the graph."""
    labels, valid = out.od_labels.long(), out.od_valid
    fg = valid & (labels > 0)
    lbl = out.rpn_labels
    sampled, rpn_fg = lbl >= 0, lbl == 1
    n_valid, n_fg, n_sampled, n_rpn_fg = global_counts(valid, fg, sampled, rpn_fg)
    losses = {"class_loss": masked_ce(out.od_obj_dists, labels, valid, n_valid)}
    b, s = labels.shape
    deltas = out.od_box_deltas.gather(
        2, labels[:, :, None, None].expand(b, s, 1, 4))[:, :, 0]
    box_mult = 2.0 * (1.0 / C.FG_FRACTION) * n_fg / (n_valid + 1e-4)
    losses["box_loss"] = masked_bbox_loss(out.od_rois, deltas, out.od_box_targets,
                                          fg, n_fg) * box_mult

    losses["rpn_class_loss"] = masked_ce(out.rpn_feats[..., :2], lbl.clamp(min=0), sampled,
                                         n_sampled)
    rpn_mult = 2.0 * (1.0 / C.RPN_FG_FRACTION) * n_rpn_fg / (n_sampled + 1e-4)
    losses["rpn_box_loss"] = masked_bbox_loss(
        out.anchors.expand_as(out.rpn_target_boxes), out.rpn_feats[..., 2:],
        out.rpn_target_boxes, rpn_fg, n_rpn_fg) * rpn_mult
    losses["total"] = sum(losses.values())
    return losses
