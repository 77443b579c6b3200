"""The judgement of an evaluation batch: the plain reference, in f32,
follows the judged run's decisions (its proposals, its kept detections,
its decoder's commitments, its object classes, its pairs) and computes
each stage's values from the images and the weights alone; the judged
run's values at that stage are compared with the reference's. Each
decision itself is then checked by running the reference's plain
algorithm on the judged run's own inputs to it: the same decision, bit
for bit, or it counts in `exact`.

Numbers (the worst over the judged batches):
  rpn    sgdet: max |RPN logits and deltas - reference| / max |reference|
  det    the detector head's class logits and box deltas at the judged
         run's RoIs, the same measure
  obj    sgdet: the decoder's object logits, the same measure
  rel    the predicate log-probabilities of the judged run's pairs, less
         the one of the reference's top predicate, the same measure (the
         entries above 1e-30 on both sides)
  exact  decisions that differ from the plain algorithm's on the judged
         run's own inputs (proposals, detections, the decoder's NMS
         decode, the pairs, the ranking), and answers malformed
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import no_tf32
from benchmark.reference.context import permute, sort_by_order
from benchmark.reference.detector import (_take, decode_boxes_all, filter_det,
                                          normalize_uint8, rpn_boxes)
from benchmark.reference.nms import nms_topk
from benchmark.reference.rel_model import RelModel, RelPairs, rel_pairs

NUMBERS = {"sgdet": ("rpn", "det", "obj", "rel", "exact"),
           "predcls": ("det", "rel", "exact")}


def build_reference(conf: dict, mode: str, budgets, weights: dict, device) -> RelModel:
    """The reference MotifNet at the configuration's widths, its weights
    loaded (every name and shape must match); TF32 off."""
    no_tf32()
    with torch.device(device):
        model = RelModel(num_classes=conf["num_classes"], num_rels=conf["num_predicates"],
                         mode=mode, embed_dim=conf["embed_dim"],
                         hidden_dim=conf["hidden_dim"], pooling_dim=conf["pooling_dim"],
                         obj_dim=conf["obj_dim"], nl_obj=conf["nl_obj"],
                         nl_edge=conf["nl_edge"], order=conf["order"],
                         use_bias=conf["use_bias"], budgets=budgets,
                         thresh=conf["det_thresh"],
                         dtype=getattr(torch, conf["compute_dtype"]))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def reference_spec(conf: dict, mode: str, budgets) -> dict:
    """name -> shape of the reference model's state dict."""
    with torch.device("meta"):
        model = RelModel(num_classes=conf["num_classes"], num_rels=conf["num_predicates"],
                         mode=mode, embed_dim=conf["embed_dim"],
                         hidden_dim=conf["hidden_dim"], pooling_dim=conf["pooling_dim"],
                         obj_dim=conf["obj_dim"], nl_obj=conf["nl_obj"],
                         nl_edge=conf["nl_edge"], order=conf["order"],
                         use_bias=conf["use_bias"], budgets=budgets)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    if ref.numel() == 0:
        return 0.0
    scale = ref.abs().max().clamp_min(1e-30)
    return float((got - ref).abs().max() / scale)


PROB_FLOOR = 1e-30   # f32 probabilities below it lose digits to underflow


def log_ratio_err(probs: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The judged run's predicate probabilities [N, NP] against the
    reference's logits: each row's log-probabilities less the one of the
    reference's top predicate (the softmax's own degree of freedom taken
    out), over the entries above PROB_FLOOR on both sides, `rel_err`'s
    measure. A probability that underflowed in f32 says nothing of the
    logit behind it, so it is not compared."""
    if probs.numel() == 0:
        return 0.0
    lref = torch.log_softmax(ref_logits.double(), -1)
    lgot = torch.log(probs.double().clamp_min(1e-300))
    top = lref.argmax(-1, keepdim=True)
    lref, lgot = lref - lref.gather(-1, top), lgot - lgot.gather(-1, top)
    floor = torch.log(torch.tensor(PROB_FLOOR, dtype=torch.float64))
    keep = (torch.log(probs.double().clamp_min(1e-300)) >= floor) & \
        (torch.log_softmax(ref_logits.double(), -1) >= floor)
    return rel_err(lgot[keep], lref[keep])


def _count(x: torch.Tensor) -> int:
    return int(x.sum())


def _ranking_breaks(pred: dict) -> int:
    """Positions where a later valid relation's triplet score (the
    decode's key, from the run's own output) exceeds an earlier one's."""
    breaks = 0
    for i in range(pred["rel_valid"].shape[0]):
        rv = pred["rel_valid"][i]
        sub, obj = pred["rel_inds"][i][rv].T
        s = pred["obj_scores"][i].astype(np.float64)
        t = s[sub] * s[obj] * pred["rel_scores"][i][rv][:, 1:].max(1)
        breaks += int((np.diff(t) > 1e-6 * np.abs(t[1:]) + 1e-12).sum())
        if rv.any() and not rv[:int(rv.sum())].all():   # valid rows first
            breaks += 1
    return breaks


@torch.no_grad()
def judge_batch(ref: RelModel, mode: str, inputs: dict, cap: dict, pred: dict) -> dict:
    """inputs: the batch's images (uint8), im_hw, gt_boxes, gt_classes,
    gt_mask on the device; cap: the judged run's intermediates
    (`capture_of`'s keys) on the device; pred: its SGPrediction as numpy
    arrays. Returns this batch's numbers."""
    dev = inputs["images"].device
    det = ref.detector
    out = dict.fromkeys(NUMBERS[mode], 0.0)
    exact = 0
    im_hw = inputs["im_hw"]
    fmap = det.features(normalize_uint8(inputs["images"], im_hw))
    if mode == "sgdet":
        rpn = det.rpn_head(fmap)
        out["rpn"] = rel_err(cap["det_rpn_feats"], rpn)
        anchors = det.anchors(fmap.shape[1] * 16, fmap.shape[2] * 16, dev)
        boxes, probs, valid = rpn_boxes(cap["det_rpn_feats"], anchors, im_hw)
        idx, ok = nms_topk(boxes, probs, valid, 0.7, ref.budgets.rpn_pre_nms_topn_test,
                           ref.budgets.rpn_post_nms_topn_test)
        rois = boxes.gather(1, idx[..., None].expand(*idx.shape, 4))
        exact += _count(ok != cap["det_od_valid"])
        exact += _count(((rois != cap["det_od_rois"]).any(-1)) & ok)
        rois, roi_valid = cap["det_od_rois"], cap["det_od_valid"]
    else:
        rois, roi_valid = inputs["gt_boxes"], inputs["gt_mask"]
    obj_fmap = det.obj_feature_map(fmap, rois, roi_valid)
    od = det.score_fc(obj_fmap)
    v = roi_valid
    out["det"] = rel_err(cap["det_od_obj_dists"][v], od[v])

    if mode == "sgdet":
        b, s = rois.shape[:2]
        deltas = det.bbox_fc(obj_fmap).reshape(b, s, -1, 4)
        out["det"] = max(out["det"], rel_err(cap["det_od_box_deltas"][v], deltas[v]))
        probs = torch.softmax(cap["det_od_obj_dists"], dim=-1)
        boxes_all = decode_boxes_all(rois, cap["det_od_box_deltas"], im_hw)
        idx, scores, classes, ok = filter_det(
            probs, boxes_all, roi_valid, det.max_per_img, det.thresh,
            per_class_topk=ref.budgets.per_class_nms_topk)
        exact += _count(ok != cap["det_rm_valid"])
        exact += _count((idx != cap["det_rm_fmap_idx"]) & ok)
        exact += _count((classes != cap["det_obj_preds"]) & ok)
        exact += _count((scores != cap["det_obj_scores"]) & ok)
        idx, obj_valid = cap["det_rm_fmap_idx"], cap["det_rm_valid"]
        obj_boxes = _take(rois, idx)
        boxes_all_sel = _take(boxes_all, idx).clone()
        boxes_all_sel[:, :, 0, :] = obj_boxes
        exact += _count(((boxes_all_sel != cap["det_boxes_all"]).any(-1).any(-1)) & obj_valid)
        obj_logits = _take(od, idx)
        det_scores = cap["det_obj_scores"]
    else:
        obj_boxes, obj_valid, obj_logits, det_scores = rois, roi_valid, od, None
        boxes_all_sel = None

    obj_feats = ref.obj_features(fmap, obj_boxes, obj_valid)
    prog_dists, prog_preds = cap["ctx_obj_dists"], cap["ctx_obj_preds"]
    if mode == "sgdet":
        greedy = torch.argmax(prog_dists[..., 1:], dim=-1) + 1
        ctx = ref.context(obj_feats, obj_logits, obj_boxes, obj_valid,
                          forced_greedy=greedy, forced_preds=prog_preds)
        out["obj"] = rel_err(prog_dists[obj_valid], ctx.obj_dists[obj_valid])
        perm, inv_perm, _ = sort_by_order(ref.context.order, obj_boxes, obj_valid)
        decoder = ref.context.decoder_rnn
        commits = decoder._nms_decode(permute(prog_dists, perm), obj_valid.gather(1, perm),
                                      permute(boxes_all_sel, perm)).gather(1, inv_perm)
        exact += _count((commits != prog_preds) & obj_valid)
    else:
        labels = inputs["gt_classes"].long()
        ctx = ref.context(obj_feats, obj_logits, obj_boxes, obj_valid, obj_labels=labels)
        exact += _count((prog_preds != labels) & obj_valid)

    pairs, _ = rel_pairs(obj_valid, obj_boxes, det_scores, ref.budgets.max_pairs_eval,
                         ref.require_overlap)
    p_inds = torch.as_tensor(pred["rel_inds"], device=dev)
    p_valid = torch.as_tensor(pred["rel_valid"], device=dev)
    for i in range(p_inds.shape[0]):
        want = {(int(a), int(c)) for a, c, ok in zip(pairs.sub[i], pairs.obj[i], pairs.valid[i])
                if ok}
        got = {(int(a), int(c)) for (a, c), ok in zip(p_inds[i], p_valid[i]) if ok}
        exact += len(want ^ got)
    judged = RelPairs(sub=p_inds[..., 0].long(), obj=p_inds[..., 1].long(), valid=p_valid)
    logits = ref.rel_dists(fmap, obj_boxes, ctx.edge_ctx, prog_preds, judged)
    got = torch.as_tensor(pred["rel_scores"], device=dev)
    out["rel"] = log_ratio_err(got[p_valid], logits[p_valid])

    exact += _ranking_breaks(pred)
    if mode == "sgdet":
        want_boxes = boxes_all_sel.gather(
            2, prog_preds[..., None, None].expand(*prog_preds.shape, 1, 4))[..., 0, :]
    else:
        want_boxes = obj_boxes
    got_boxes = torch.as_tensor(pred["boxes"], device=dev)
    exact += _count((got_boxes != want_boxes).any(-1) & obj_valid)
    exact += _count(torch.as_tensor(pred["obj_classes"], device=dev) != prog_preds)
    out["exact"] = float(exact)
    return out


def worst(per_batch: list[dict]) -> dict:
    return {k: max(d[k] for d in per_batch) for k in per_batch[0]}
