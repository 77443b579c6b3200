"""The judgement of a detector-training run's first three steps: the plain
reference, in f32 from the same initial weights and the same batches, takes
the judged run's decisions (its proposals' anchors, its anchor sample, its
RoI sample; the dropout masks come from a generator seeded as the run's)
and takes the same three SGD steps. Compared, by the worst leaf:

  loss    the largest relative gap between a step's total loss and the
          reference's
  grad    the first gradient as the optimizer gets it (the momentum
          buffer after one step: the clipped gradient plus the weight
          decay): | |g| - |g_ref| | over max(|g_ref|, the median leaf's)
  update  the parameters' change after three steps, the same measure

Leaves whose reference gradient at step 1 is under a thousandth of the
median leaf's move by round-off alone and are left out of `grad` and
`update`. Each decision is then checked by running the reference's plain
algorithm on the judged run's own inputs to it (the proposals from its
RPN output, both samplers with the same draws): the same decision, bit
for bit, or it counts in `exact`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import no_tf32
from benchmark.reference.detector import ObjectDetector, rpn_boxes
from benchmark.reference.losses import detector_losses
from benchmark.reference.nms import nms_topk

NUMBERS = ("loss", "grad", "update", "exact")
EXCLUDE_BELOW = 1e-3      # of the median leaf's gradient norm


def build_detector(conf: dict, budgets, weights: dict | None, device) -> ObjectDetector:
    """The reference detector (rpntrain), its weights loaded; TF32 off."""
    no_tf32()
    with torch.device(device):
        model = ObjectDetector(num_classes=conf["num_classes"], mode="rpntrain",
                               obj_dim=conf["obj_dim"],
                               dtype=getattr(torch, conf["compute_dtype"]), budgets=budgets)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model


def detector_spec(conf: dict, budgets) -> dict:
    return {k: tuple(v.shape) for k, v in build_detector(conf, budgets, None, "meta")
            .state_dict().items()}


def optimizer(model, conf: dict, batch: int) -> torch.optim.Optimizer:
    """SGD as the port's entry point sets it: momentum, weight decay, the
    rate times the batch."""
    return torch.optim.SGD(model.parameters(), lr=conf["lr"] * batch,
                           momentum=conf["momentum"], weight_decay=conf["l2"])


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def step_record(out, losses: dict) -> dict:
    """What the judgement reads of one step of a run (the program's or the
    control's): its RPN output, its decisions and its loss."""
    s = out.det_sample
    return {"rpn_feats": out.rpn_feats.detach(), "rpn_labels": out.rpn_labels,
            "rpn_target_boxes": out.rpn_target_boxes, "det_idx": s.idx,
            "det_labels": s.labels, "det_targets": s.targets, "det_valid": s.valid,
            "loss": float(losses["total"])}


def free_run(model: ObjectDetector, conf: dict, batches: list, generator) -> dict:
    """Three steps of the reference itself (the control, at fp8), recorded
    as the program's are."""
    opt = optimizer(model, conf, batches[0]["images"].shape[0])
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    steps, grad_norms = [], None
    for s, inp in enumerate(batches):
        out = model.forward_train(inp["images"], inp["im_hw"], inp["gt_boxes"],
                                  inp["gt_classes"], inp["gt_mask"], generator=generator)
        losses = detector_losses(out)
        opt.zero_grad(set_to_none=True)
        losses["total"].backward()
        torch.nn.utils.clip_grad_norm_(list(model.parameters()), conf["clip"])
        opt.step()
        rec = step_record(out, losses)
        rec.update(prop_idx=out.prop_idx, prop_valid=out.prop_valid)
        steps.append(rec)
        if s == 0:
            grad_norms = leaf_norms({n: opt.state[p]["momentum_buffer"]
                                     for n, p in model.named_parameters()})
    change = leaf_norms({n: p.detach() - p0[n] for n, p in model.named_parameters()})
    return {"steps": steps, "grad_norms": grad_norms, "change_norms": change}


def gap(prog: dict, ref: dict, keep: list) -> tuple[float, str]:
    """The worst leaf's gap and its name."""
    med = float(np.median([ref[k] for k in keep]))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keep)


def judge_run(conf: dict, budgets, weights: dict, batches: list, run: dict,
              generator, device) -> dict:
    """batches: the three steps' inputs on the device; run: the judged
    run's record (`steps`, each with `prop_idx`, `prop_valid` and
    `step_record`'s keys; `grad_norms`, `change_norms` by leaf)."""
    ref = build_detector(conf, budgets, weights, device)
    opt = optimizer(ref, conf, batches[0]["images"].shape[0])
    p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    loss_gap, exact, raw, grad_norms = 0.0, 0, None, None
    bud = budgets
    for s, (inp, cap) in enumerate(zip(batches, run["steps"])):
        im_hw = inp["im_hw"]
        with torch.no_grad():
            anchors = ref.anchors(inp["images"].shape[1], inp["images"].shape[2], device)
            boxes, probs, valid = rpn_boxes(cap["rpn_feats"], anchors, im_hw)
            idx, ok = nms_topk(boxes, probs, valid, 0.7, bud.rpn_pre_nms_topn_train,
                               bud.rpn_post_nms_topn_train)
            exact += int((ok != cap["prop_valid"]).sum())
            exact += int(((idx != cap["prop_idx"]) & ok).sum())
            props = boxes.gather(1, cap["prop_idx"][..., None].expand(*idx.shape, 4))
        forced = {"prop_idx": cap["prop_idx"], "prop_valid": cap["prop_valid"],
                  "props": props, "rpn_labels": cap["rpn_labels"],
                  "rpn_target_boxes": cap["rpn_target_boxes"], "det_idx": cap["det_idx"],
                  "det_labels": cap["det_labels"], "det_targets": cap["det_targets"],
                  "det_valid": cap["det_valid"]}
        out = ref.forward_train(inp["images"], im_hw, inp["gt_boxes"], inp["gt_classes"],
                                inp["gt_mask"], generator=generator, forced=forced)
        a_t, d_s = out.own_samples
        fg = cap["rpn_labels"] == 1
        exact += int((a_t.labels != cap["rpn_labels"]).sum())
        exact += int(((a_t.target_boxes != cap["rpn_target_boxes"]).any(-1) & fg).sum())
        v = cap["det_valid"]
        exact += int((d_s.valid != v).sum())
        exact += int(((d_s.idx != cap["det_idx"]) & v).sum())
        exact += int(((d_s.labels != cap["det_labels"]) & v).sum())
        exact += int((((d_s.targets != cap["det_targets"]).any(-1)) & v
                      & (cap["det_labels"] > 0)).sum())
        losses = detector_losses(out)
        ref_loss = float(losses["total"])
        loss_gap = max(loss_gap, abs(cap["loss"] - ref_loss) / max(abs(ref_loss), 1e-30))
        opt.zero_grad(set_to_none=True)
        losses["total"].backward()
        if s == 0:
            raw = leaf_norms({n: p.grad for n, p in ref.named_parameters()})
        torch.nn.utils.clip_grad_norm_(list(ref.parameters()), conf["clip"])
        opt.step()
        if s == 0:
            grad_norms = leaf_norms({n: opt.state[p]["momentum_buffer"]
                                     for n, p in ref.named_parameters()})
    change = leaf_norms({n: p.detach() - p0[n] for n, p in ref.named_parameters()})
    med = float(np.median(list(raw.values())))
    keep = [k for k in raw if raw[k] >= EXCLUDE_BELOW * med]
    (grad, grad_leaf), (update, update_leaf) = (gap(run["grad_norms"], grad_norms, keep),
                                                gap(run["change_norms"], change, keep))
    return {"loss": loss_gap, "grad": grad, "update": update, "exact": float(exact),
            "left_out": sorted(set(raw) - set(keep)),
            "worst_leaves": {"grad": grad_leaf, "update": update_leaf}}
