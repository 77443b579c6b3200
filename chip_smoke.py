"""Smoke run of the PyTorch + CUDA port (neural_motifs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failure in any phase raises, and the
script exits non-zero without a result line):

  1. device   - the card's name and power limit (nvidia-smi), torch/CUDA
                versions; refuses to run without a CUDA device.
  2. build    - nvcc builds the three kernels from neural_motifs_tpu_torch/csrc.
  3. kernels  - K1 RoIAlign, K2 per-class NMS, K3 greedy NMS against their
                plain PyTorch versions on the card at the main path's
                shapes (K1 in f32 and bf16 at R = 1000, 64, 512; K2 on
                random lanes and on the request's full lanes of clustered
                boxes; K3 on uniform random and on RPN-like clustered
                boxes), with the
                time of a call of each (CUDA events, the median of 10 calls
                each synced; and over 10 calls in a row, the host enqueueing
                ahead), the kernels' device time from torch.profiler (K3 split into
                its mask and scan kernels), each kernel's bound from its
                shapes (bytes over the HBM rate or f32 operations over the
                f32 peak) and share of it, and a yardstick: grid_sample for
                K1 (timed only; the port never calls it), none for K2/K3.
  4. reference- a small f32 RelModel on the card (kernels) against the same
                model on the CPU (plain versions).
  5. requests - MotifNet SGDet at the full bench widths (592^2 images, 151
                classes, 51 predicates, hidden 512, pooling 4096, nl_obj 2,
                nl_edge 4, top-64 objects, 1024 pairs) with seeded random
                weights answers 3 requests of 4 images; every kernel must
                have launched during them, 4 / 1 / 1 times a request; then
                the device time of one request (torch.profiler).
  6. eval-reference - the relation-evaluation entry point
                (training/eval_rels.main) with a small f32 model and the
                published flags on 4 StructuredSyntheticVG images (592^2,
                uint8) in predcls and sgcls, on the CPU (plain versions) and
                on the card (kernels), from one state dict through -ckpt:
                identical recall lists, pair indices and classes; scores
                within rtol 1e-3 / atol 1e-4.
  7. eval     - eval_rels.main at the published MotifNet widths and flags
                (scripts/eval_models.sh) with seeded random weights, in
                predcls, sgcls and sgdet (sgdet with the detector's class
                biases spread, so boxes clear the 0.01 threshold): per mode a
                warm-up run on the SyntheticVG fallback (8 val images), then
                a run on 32 SyntheticVG val images that prints R@20/50/100,
                images/s and the kernel launches; every val image is
                evaluated once; the launches are exactly K1 80 (predcls,
                sgcls) / 32 (sgdet), K2 and K3 8 in sgdet. Then one batch
                of the same model: its synced forward on the host's clock
                beside its kernels' device time (torch.profiler).
  8. train-reference - one relation-training step of a small f32 RelModel
                (phase 6's widths, the published flags) in sgcls and sgdet on
                the card (kernels) and on the CPU (plain versions), from one
                state dict, dropout off, the CPU step's sampled pairs
                replayed on the card: losses within rtol 1e-4, every
                trainable gradient within 1e-3 of its leaf's largest
                magnitude, the card's SGD step (momentum, weight decay, lr)
                on its own gradients within 1e-5 of each leaf's largest
                weight, the detector bit-identical. The card's parameters
                differ from the CPU's by lr times the gradients' difference,
                which is printed.
  9. train    - training/train_rels.main at the published MotifNet
                training config (scripts/train_motifnet.sh: batch 6, lr
                1e-3, clip 5) with seeded random weights on 592^2
                StructuredSyntheticVG scenes (151 classes, 51 predicates),
                in sgcls and sgdet (sgdet with the detector's class biases
                spread): 2 warm-up steps then 10 timed ones, s/step, img/s,
                peak memory, the loss, skipped steps and the training steps'
                kernel launches; then its validation epoch over 12 val
                images. Requires finite losses, no skipped step, the
                detector bit-identical, the training steps' launches
                exactly K1 36 in both modes and K2 / K3 12 in sgdet, each val
                image evaluated once. Then a synced
                split of one training step per mode (detector, sample and
                object tower, context, relation heads, backward, optimizer).

The line before the last is the kernels' JSON record (per kernel: its
launches on the main path and per request, error, time, plain time, bound
and share of it, device time, yardstick or the reason for none); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from neural_motifs_tpu_torch import config as C
from neural_motifs_tpu_torch.data.batching import Loader, loader_im_kw, to_device
from neural_motifs_tpu_torch.data.synthetic import (StructuredSyntheticVG,
                                                    SyntheticVG)
from neural_motifs_tpu_torch.models.rel_model import RelModel, disable_dropout_
from neural_motifs_tpu_torch.ops import _cuda
from neural_motifs_tpu_torch.ops import nms
from neural_motifs_tpu_torch.ops import roi_align as ra
from neural_motifs_tpu_torch.training import eval_rels, train_rels
from neural_motifs_tpu_torch.training.build import batch_kwargs, build_model
from neural_motifs_tpu_torch.training.losses import rel_losses
from neural_motifs_tpu_torch.training.train_state import (freeze_detector_,
                                                          make_optimizer,
                                                          make_train_step)
from neural_motifs_tpu_torch.weights import random_init_, set_position_stats_

SEED = 0
BATCH = 4
# scripts/eval_models.sh / train_motifnet.sh flags beside the widths (phase 8)
PUBLISHED_FLAGS = dict(use_bias=True, use_tanh=False, limit_vision=False,
                       require_overlap_det=True, pass_in_obj_feats_to_decoder=False,
                       pass_in_obj_feats_to_edge=False)
# the flags of the JAX bench config (bench.py), phases 4-5
BENCH_FLAGS = dict(use_bias=True, use_tanh=False, limit_vision=False,
                   require_overlap_det=True, pass_in_obj_feats_to_decoder=True,
                   pass_in_obj_feats_to_edge=True)
REQUESTS = 3
# scripts/eval_models.sh, the published MotifNet eval (phase 7)
PUBLISHED_ARGS = ("-model motifnet -order leftright -nl_obj 2 -nl_edge 4 "
                  "-hidden_dim 512 -pooling_dim 4096 -use_bias -b 4").split()
EVAL_VAL_IMAGES = 32   # the timed val split of phase 7 (8 batches of 4)
# the widths of check_reference with the published flags (phase 6)
SMALL_ARGS = ("-model motifnet -order leftright -nl_obj 2 -nl_edge 2 "
              "-hidden_dim 24 -pooling_dim 128 -obj_dim 128 -embed_dim 16 "
              "-use_bias -b 2 -dtype float32 -max_gt_boxes 16").split()
# scripts/train_motifnet.sh, the published MotifNet training (phase 9)
TRAIN_ARGS = ("-model motifnet -order leftright -nl_obj 2 -nl_edge 4 "
              "-hidden_dim 512 -pooling_dim 4096 -use_bias -b 6 -lr 1e-3 "
              "-clip 5").split()
TRAIN_WARMUP, TRAIN_TIMED = 2, 10   # steps of phase 9
TRAIN_VAL_IMAGES = 12
# the kernels' launches (K1, K2, K3) on each path: 4 / 1 / 1 a SGDet
# request; over the 32 val images of phase 7 (8 batches); over the 12
# training steps of phase 9
REQUEST_LAUNCHES = (4, 1, 1)
EVAL_LAUNCHES = {"predcls": (80, 0, 0), "sgcls": (80, 0, 0), "sgdet": (32, 8, 8)}
TRAIN_LAUNCHES = {"sgcls": (36, 0, 0), "sgdet": (36, 12, 12)}

KERNELS = {
    "roi_align_fwd": dict(
        wrapper=ra.roi_align_cuda, source="neural_motifs_tpu_torch/csrc/roi_align.cu",
        replaces="neural_motifs_tpu/ops/pallas_roi_align.py:158"),
    "perclass_nms": dict(
        wrapper=nms.perclass_nms_cuda, source="neural_motifs_tpu_torch/csrc/nms.cu",
        replaces="neural_motifs_tpu/ops/pallas_nms.py:128"),
    "greedy_nms": dict(
        wrapper=nms.greedy_nms_cuda, source="neural_motifs_tpu_torch/csrc/nms.cu",
        replaces="neural_motifs_tpu/ops/pallas_nms.py:151"),
}


def require(cond, msg: str) -> None:
    """Fail the run (a check that `python -O` does not remove)."""
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 10) -> float:
    """Median time of one call, by CUDA events around each of `reps` calls,
    synced after each, after a warm-up: the wrapper's host work counts
    wherever the card waits for it."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pipelined_ms(fn, reps: int = 10) -> float:
    """Time of one call in a stream of calls: CUDA events around `reps`
    calls in a row after a warm-up, divided by `reps`. The host enqueues
    ahead, so a wrapper's host work overlaps the card's; this reads lower
    than `time_ms` by that overlap, and is not compared with it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, names: tuple, reps: int = 10) -> dict | None:
    """Device time per call from torch.profiler's key_averages(): summed
    over the kernels whose names hold each of `names`, and over every
    kernel of the call ("all"); None where the profiler shows no device
    time."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names + ("all",), 0.0)
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        out["all"] += us / 1e3 / reps
        for n in names:
            if n in evt.key:
                out[n] += us / 1e3 / reps
    return out if out["all"] else None


# The published peaks of one H100 SXM:
PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
# f32 operations of one +1-convention IoU test: per axis min, max, sub, +1
# (8); two clamps and the product (3); union add, sub, clamp (3); the
# division; the comparison with the threshold
IOU_OPS = 16
# f32 operations of one RoIAlign output value: three lerps w0 * a + w1 * b
LERP_OPS = 9


def bound(n_bytes: float, n_ops: float) -> tuple:
    """The least time the card could take (ms), the larger of bytes over the
    HBM rate and f32 operations over the f32 peak, and which one it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_align_bound(b: int, h: int, w: int, c: int, r: int, p: int, elem: int) -> tuple:
    n_bytes = (b * h * w * c * elem        # the map, read once
               + b * r * (4 * 4 + 1)       # RoIs (f32) and valid flags
               + b * r * p * p * c * elem)  # the crops, written once
    return bound(n_bytes, b * r * p * p * c * LERP_OPS)


def greedy_pairs(keep_sorted, valid_sorted) -> int:
    """The IoU tests this data needs: every kept box against each valid box
    ranked after it (a suppressed box suppresses nothing)."""
    v = valid_sorted.long()
    later = v.flip(-1).cumsum(-1).flip(-1) - v
    return int((later * keep_sorted.long()).sum())


def nms_bound(n_boxes: int, bytes_per_box: int, pairs: int) -> tuple:
    return bound(n_boxes * bytes_per_box, pairs * IOU_OPS)


def rpn_like_boxes(gen, dev, n: int):
    """RPN-like clustered proposals: n of the 37x37x20 anchors of a 592^2
    image per image, decoded with seeded deltas (N(0, 0.1) centres, N(0,
    0.2) log-sizes) and clipped to the image."""
    from neural_motifs_tpu_torch.ops.anchors import generate_anchors
    from neural_motifs_tpu_torch.ops.boxes import bbox_preds, clip_boxes
    anchors = torch.from_numpy(generate_anchors().reshape(-1, 4)).to(dev)
    pick = torch.rand(BATCH, len(anchors), generator=gen, device=dev).argsort(1)[:, :n]
    deltas = torch.randn(BATCH, n, 4, generator=gen, device=dev) \
        * torch.tensor([0.1, 0.1, 0.2, 0.2], device=dev)
    im = torch.full((BATCH, 1), float(C.IM_SCALE), device=dev)
    return clip_boxes(bbox_preds(anchors[pick], deltas), im, im)


def yardstick_grid_sample(fmap, rois, p: int, scale: float):
    """torch's grid_sample (align_corners=True) at the RoIAlign sample
    points of fmap [B,H,W,C]: the same bilinear samples except that it
    weighs a sample outside [0, G-1] partly, where K1 gives zero. Timed
    as K1's yardstick only; the port never calls it."""
    _, h, w, _ = fmap.shape
    t = torch.arange(p, device=fmap.device, dtype=torch.float32) / (p - 1)
    lo, hi = rois[..., :2] * scale, rois[..., 2:] * scale          # [B,R,2]
    u = lo[..., None] + (hi - lo)[..., None] * t                   # [B,R,2,P]
    gx = u[:, :, 0] / (w - 1) * 2 - 1
    gy = u[:, :, 1] / (h - 1) * 2 - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, :, None, :], gy[:, :, :, None]), -1)
    grid = grid.reshape(fmap.shape[0], -1, p, 2).to(fmap.dtype)    # [B, R*P, P, 2]
    x = fmap.permute(0, 3, 1, 2)                                   # NCHW view
    return lambda: torch.nn.functional.grid_sample(x, grid, mode="bilinear",
                                                   padding_mode="zeros",
                                                   align_corners=True)


def rand_boxes(gen, shape, scale, dev):
    xy = torch.rand(shape + (2,), generator=gen, device=dev) * scale
    wh = 1.0 + torch.rand(shape + (2,), generator=gen, device=dev) * (scale / 2)
    return torch.cat([xy, xy + wh], -1)


def check_kernels(dev, gen) -> dict:
    """Each kernel against its plain version at the main path's shapes,
    with its time (CUDA events), its device time (profiler), its bound and
    its yardstick."""
    res = {}
    # K1: the detector's 1000 proposals, the 64 objects, a 512-pair union
    # chunk; RoIs partly outside the 37x37 map, ~10% invalid
    fmap = torch.randn(BATCH, 37, 37, 512, generator=gen, device=dev)
    f16 = fmap.bfloat16()
    errs, k1 = [], {}
    for r in (1000, 64, 512):
        rois = rand_boxes(gen, (BATCH, r), 700, dev) - 50.0
        valid = torch.rand(BATCH, r, generator=gen, device=dev) < 0.9
        got = ra.roi_align_cuda(fmap, rois, valid, 7, 1 / 16)
        exp = ra._roi_align_matmul(fmap, rois, valid, 7, 1 / 16)
        errs.append((got - exp).abs().max().item())
        got16 = ra.roi_align_cuda(f16, rois, valid, 7, 1 / 16).float()
        torch.testing.assert_close(got16, exp, rtol=2e-2, atol=2e-2)
        if r in (1000, 512):
            t_k = time_ms(lambda: ra.roi_align_cuda(f16, rois, valid, 7, 1 / 16))
            t_s = pipelined_ms(lambda: ra.roi_align_cuda(f16, rois, valid, 7, 1 / 16))
            t_p = time_ms(lambda: ra._roi_align_matmul(f16, rois, valid, 7, 1 / 16), reps=3)
            dev_t = device_ms(lambda: ra.roi_align_cuda(f16, rois, valid, 7, 1 / 16),
                              ("roi_align",))
            b_ms, b_by = roi_align_bound(BATCH, 37, 37, 512, r, 7, 2)
            k1[r] = dict(ms=t_k, pipelined_ms=t_s, plain_ms=t_p, bound_ms=b_ms,
                         bound_by=b_by, device_ms=dev_t and dev_t["roi_align"],
                         share_of_bound=b_ms / t_k)
            if r == 1000:
                k1[r]["library_ms"] = time_ms(yardstick_grid_sample(f16, rois, 7, 1 / 16))
    err = max(errs)
    require(err <= 1e-4, f"K1 f32 max abs error {err} > 1e-4")
    res["roi_align_fwd"] = dict(max_abs_err=err, **k1[1000], r512=k1[512])
    for r, k in k1.items():
        print(f"K1 roi_align_fwd bf16 R={r}: kernel {k['ms']:.4f} ms a synced call "
              f"({k['pipelined_ms']:.4f} in a stream of calls, device "
              f"{k['device_ms'] if k['device_ms'] is not None else 'not measured'}), "
              f"plain {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), share of bound {k['share_of_bound']:.3f}"
              + (f", grid_sample {k['library_ms']:.4f} ms" if "library_ms" in k else ""),
              flush=True)
    print(f"K1 roi_align_fwd: f32 max|err| {err:.3e} (R=1000/64/512, tol 1e-4), "
          f"bf16 within rtol 2e-2 at each R", flush=True)

    # K2: per-class candidates [4, 151, 256] at 0.3, on random lanes of 3 to
    # 256 valid candidates and on the request's full lanes of clustered
    # boxes (RPN-like proposals drawn per class, from their own generator,
    # so that the K3 data below do not move)
    boxes = rand_boxes(gen, (BATCH, 151, 256), 592, dev)
    n_ok = torch.randint(3, 257, (BATCH, 151, 1), generator=gen, device=dev)
    gen_full = torch.Generator(device=dev).manual_seed(SEED + 4)
    k2_cases = {
        "random": (boxes, torch.arange(256, device=dev) < n_ok),
        "full_lanes": (torch.stack([rpn_like_boxes(gen_full, dev, 256) for _ in range(151)], 1),
                       torch.ones(BATCH, 151, 256, dtype=torch.bool, device=dev))}
    k2 = {}
    for kind, (boxes, valid) in k2_cases.items():
        got = nms.perclass_nms_cuda(boxes, valid, 0.3)
        exp = nms._perclass_nms_plain(boxes, valid, 0.3)
        diff = (got != exp).sum().item()
        require(diff == 0, f"K2 keep masks differ in {diff} places ({kind} lanes)")
        kept = int(got.sum())
        require(0 < kept < int(valid.sum()), f"K2 {kind}: {kept} kept, nothing suppressed")
        t_k = time_ms(lambda: nms.perclass_nms_cuda(boxes, valid, 0.3))
        t_s = pipelined_ms(lambda: nms.perclass_nms_cuda(boxes, valid, 0.3))
        t_p = time_ms(lambda: nms._perclass_nms_plain(boxes, valid, 0.3), reps=3)
        dev_t = device_ms(lambda: nms.perclass_nms_cuda(boxes, valid, 0.3), ("perclass_nms",))
        pairs = greedy_pairs(got, valid)
        b_ms, b_by = nms_bound(BATCH * 151 * 256, 16 + 1 + 1, pairs)
        k2[kind] = dict(ms=t_k, pipelined_ms=t_s, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                        share_of_bound=b_ms / t_k, device_ms=dev_t and dev_t["perclass_nms"],
                        kept=kept, iou_tests=pairs)
        print(f"K2 perclass_nms {kind}: keep identical ({kept} kept); kernel {t_k:.4f} ms "
              f"a synced call ({t_s:.4f} in a stream of calls, device "
              f"{k2[kind]['device_ms'] if dev_t else 'not measured'}), plain {t_p:.3f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}, {pairs} IoU tests), share {b_ms / t_k:.4f}",
              flush=True)
    res["perclass_nms"] = dict(max_abs_err=0.0, **k2["random"], full_lanes=k2["full_lanes"],
                               library_ms=None,
                               library_reason="no single PyTorch call computes greedy NMS")

    # K3: the RPN's pre-NMS top 6000 per image at 0.7, on uniform random
    # boxes and on RPN-like clustered ones
    k3 = {}
    for kind in ("random", "clustered"):
        boxes = (rand_boxes(gen, (BATCH, 6000), 592, dev) if kind == "random"
                 else rpn_like_boxes(gen, dev, 6000))
        scores = torch.rand(BATCH, 6000, generator=gen, device=dev)
        valid = torch.rand(BATCH, 6000, generator=gen, device=dev) < 0.95
        got = nms.greedy_nms_cuda(boxes, scores, valid, 0.7)
        exp = nms._greedy_nms_plain(boxes, scores, valid, 0.7)
        diff = (got != exp).sum().item()
        require(diff == 0, f"K3 keep masks differ in {diff} places ({kind} boxes)")
        t_k = time_ms(lambda: nms.greedy_nms_cuda(boxes, scores, valid, 0.7))
        t_s = pipelined_ms(lambda: nms.greedy_nms_cuda(boxes, scores, valid, 0.7))
        t_p = time_ms(lambda: nms._greedy_nms_plain(boxes, scores, valid, 0.7), reps=3)
        split = device_ms(lambda: nms.greedy_nms_cuda(boxes, scores, valid, 0.7),
                          ("nms_mask", "nms_scan"))
        _, order = nms.sort_desc(torch.where(valid, scores, torch.full_like(scores, -1.0)), 1)
        pairs = greedy_pairs(got.gather(1, order), valid.gather(1, order))
        b_ms, b_by = nms_bound(BATCH * 6000, 16 + 4 + 1 + 1, pairs)
        k3[kind] = dict(ms=t_k, pipelined_ms=t_s, plain_ms=t_p, bound_ms=b_ms,
                        bound_by=b_by, share_of_bound=b_ms / t_k, kept=int(got.sum()),
                        iou_tests=pairs,
                        mask_ms=split and split["nms_mask"],
                        scan_ms=split and split["nms_scan"],
                        call_device_ms=split and split["all"])
        print(f"K3 greedy_nms {kind}: keep identical ({int(got.sum())} kept); "
              f"kernel {t_k:.4f} ms a synced call ({t_s:.4f} in a stream of calls; "
              f"device: mask "
              f"{split['nms_mask'] if split else 'not measured'}, scan "
              f"{split['nms_scan'] if split else 'not measured'} ms, every kernel "
              f"of the call {split['all'] if split else 'not measured'} ms), plain "
              f"{t_p:.3f} ms, bound {b_ms:.5f} ms ({b_by}, {pairs} IoU tests), "
              f"share {b_ms / t_k:.4f}", flush=True)
    res["greedy_nms"] = dict(max_abs_err=0.0, **k3["random"], clustered=k3["clustered"],
                             library_ms=None,
                             library_reason="no single PyTorch call computes greedy NMS "
                                            "(torchvision.ops.nms is not installed)")
    return res


def small_gt(gen, n_img: int, im: int, nc: int, n_obj: int = 6, n_rel: int = 5):
    """Seeded GT for a small model: n_obj boxes per image in an 8-slot
    grid, classes in 1..nc-1, n_rel distinct relations."""
    xy = torch.rand(n_img, n_obj, 2, generator=gen) * im * 0.6
    wh = im * (0.1 + torch.rand(n_img, n_obj, 2, generator=gen) * 0.28)
    boxes = torch.zeros(n_img, 8, 4)
    boxes[:, :n_obj] = torch.cat([xy, torch.clamp(xy + wh, max=im - 1)], -1)
    classes = torch.zeros(n_img, 8, dtype=torch.long)
    classes[:, :n_obj] = torch.randint(1, nc, (n_img, n_obj), generator=gen)
    mask = torch.zeros(n_img, 8, dtype=torch.bool)
    mask[:, :n_obj] = True
    return boxes, classes, mask, small_rels(gen, n_img, n_obj, n_rel)


def small_rels(gen, n_img: int, n_obj: int, n_rel: int):
    rels = torch.zeros(n_img, 8, 3, dtype=torch.long)
    rel_mask = torch.zeros(n_img, 8, dtype=torch.bool)
    for i in range(n_img):
        perm = torch.randperm(n_obj * (n_obj - 1), generator=gen)[:n_rel]
        sub = torch.div(perm, n_obj - 1, rounding_mode="floor")
        obj = perm % (n_obj - 1)
        rels[i, :n_rel] = torch.stack(
            [sub, obj + (obj >= sub).long(), torch.randint(1, 8, (n_rel,), generator=gen)], 1)
        rel_mask[i, :n_rel] = True
    return rels, rel_mask


def check_train_reference(dev) -> None:
    """Phase 8: one train step, the card == the CPU, sgcls and sgdet."""
    im = 96
    for mode in ("sgcls", "sgdet"):
        gen = torch.Generator().manual_seed(SEED + 2)
        budgets = C.PadBudgets(max_gt_boxes=8, max_gt_rels=8, rpn_pre_nms_topn_test=720,
                               rpn_post_nms_topn_test=32, objs_per_img=8,
                               per_class_nms_topk=16)
        cpu_model = RelModel(num_classes=12, num_rels=8, mode=mode, embed_dim=16,
                             hidden_dim=24, pooling_dim=128, obj_dim=128, nl_obj=2,
                             nl_edge=2, order="leftright", thresh=0.0,
                             dtype=torch.float32, budgets=budgets, **PUBLISHED_FLAGS)
        random_init_(cpu_model, torch.Generator().manual_seed(SEED))
        disable_dropout_(freeze_detector_(cpu_model))
        images = torch.randn(2, im, im, 3, generator=gen) * 0.4
        im_hw = torch.full((2, 2), float(im))
        boxes, classes, mask, (rels, rel_mask) = small_gt(gen, 2, im, 12)
        if mode == "sgdet":   # the GT: five detections (labels follow by IoU)
            with torch.no_grad():
                det = cpu_model.detector(images, im_hw)
            require(bool(det.rm_valid.all()), "train-reference: too few detections")
            boxes[:, :5] = det.rm_boxes[:, [0, 2, 3, 5, 7]]
            mask[:, 5:] = False
            classes[:, 5:] = 0
            rels, rel_mask = small_rels(gen, 2, 5, 4)
        kw = dict(images=images, im_hw=im_hw, gt_boxes=boxes, gt_classes=classes,
                  gt_mask=mask, gt_rels=rels, gt_rel_mask=rel_mask)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        det_before = {k: v.clone() for k, v in gpu_model.detector.state_dict().items()}
        init = {k: v.detach().clone() for k, v in cpu_model.named_parameters()}
        lr, l2 = 6e-3, 1e-4   # lr 1e-3 x batch 6, as the published run's
        opts = [make_optimizer(m, lr, l2=l2) for m in (cpu_model, gpu_model)]
        steps = [make_train_step(m, o, rel_losses)
                 for m, o in zip((cpu_model, gpu_model), opts)]
        group_lr = {id(q): g["lr"] for g in opts[1].param_groups for q in g["params"]}
        exp, out = steps[0](kw, generator=torch.Generator().manual_seed(SEED))
        got, gout = steps[1]({k: v.to(dev) for k, v in kw.items()},
                             rel_sample=type(out.sample())(*(t.to(dev) for t in out.sample())))
        require(torch.equal(gout.obj_labels.cpu(), out.obj_labels),
                f"train-reference {mode}: object labels differ")
        n_fg = int((out.rel_valid & (out.rel_labels > 0)).sum())
        require(n_fg > 0 and int(out.rel_valid.sum()) > n_fg,
                f"train-reference {mode}: degenerate sample")
        for k in ("class_loss", "rel_loss", "total"):
            torch.testing.assert_close(got[k].cpu(), exp[k], rtol=1e-4, atol=0.0)
        require(got["skipped"].item() == 0 and exp["skipped"].item() == 0,
                f"train-reference {mode}: skipped step")
        gpu_params = dict(gpu_model.named_parameters())
        worst_g = worst_s = worst_p = 0.0
        for name, p in cpu_model.named_parameters():
            q = gpu_params[name]
            if name.startswith("detector."):
                require(q.grad is None and torch.equal(q, det_before[name[9:]]),
                        f"train-reference {mode}: the detector changed at {name}")
                continue
            g = q.grad.cpu()   # the card's clipped gradient
            scale = max(p.grad.abs().max().item(), 1e-12)
            worst_g = max(worst_g, (g - p.grad).abs().max().item() / scale)
            # the card's SGD step on its own gradients: p0 - lr (g + l2 p0),
            # lr / 10 on the roi_fmap towers
            scale = max(p.detach().abs().max().item(), 1e-12)
            p0 = init[name]
            stepped = p0 - group_lr[id(q)] * (g + l2 * p0)
            worst_s = max(worst_s, (q.detach().cpu() - stepped).abs().max().item() / scale)
            # card vs CPU: lr x the gradients' difference, reported
            worst_p = max(worst_p, (q.detach().cpu() - p.detach()).abs().max().item() / scale)
        require(worst_g <= 1e-3, f"train-reference {mode}: gradient off by {worst_g:.2e}")
        require(worst_s <= 1e-5, f"train-reference {mode}: SGD step off by {worst_s:.2e}")
        print(f"train-reference {mode}: card == CPU for one train step ({n_fg} fg / "
              f"{int(out.rel_valid.sum())} pairs; loss {exp['total'].item():.6f}); "
              f"gradients within {worst_g:.2e}, the card's SGD step within "
              f"{worst_s:.2e}, parameters card vs CPU {worst_p:.2e} of each leaf's "
              f"max; detector unchanged", flush=True)


def check_reference(dev):
    """A small f32 RelModel: the card (kernels) == the CPU (plain
    versions) on decisions; scores within rtol 1e-3 / atol 1e-4."""
    budgets = C.PadBudgets(rpn_pre_nms_topn_test=720, rpn_post_nms_topn_test=32,
                           objs_per_img=8, max_pairs_eval=32, per_class_nms_topk=16)
    cpu_model = RelModel(num_classes=12, num_rels=8, embed_dim=16, hidden_dim=24,
                         pooling_dim=128, obj_dim=128, nl_obj=2, nl_edge=2,
                         order="leftright", thresh=0.0, dtype=torch.float32, budgets=budgets,
                         union_chunk=16, **BENCH_FLAGS)
    random_init_(cpu_model, torch.Generator().manual_seed(SEED))
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(2, 96, 96, 3, generator=gen) * 0.4
    im_hw = torch.full((2, 2), 96.0)
    exp = cpu_model(images, im_hw)
    got = gpu_model(images.to(dev), im_hw.to(dev))
    got = type(got)(*(t.cpu() for t in got))
    ov, rv = exp.obj_valid, exp.rel_valid
    require(ov.sum() > 0 and rv.sum() > 0, "degenerate reference input")
    for name in ("obj_valid", "rel_valid", "num_valid_pairs"):
        require(torch.equal(getattr(got, name), getattr(exp, name)), name)
    require(torch.equal(got.obj_classes[ov], exp.obj_classes[ov]), "obj_classes")
    require(torch.equal(got.rel_inds[rv], exp.rel_inds[rv]), "rel_inds")
    torch.testing.assert_close(got.obj_scores[ov], exp.obj_scores[ov], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.rel_scores[rv], exp.rel_scores[rv], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.boxes[ov], exp.boxes[ov], rtol=1e-4, atol=1e-3)
    print(f"reference: small f32 RelModel on the card == on the CPU "
          f"({int(ov.sum())} objects, {int(rv.sum())} relations)", flush=True)


def bench_model(dev, gen) -> RelModel:
    """MotifNet SGDet at the JAX bench config's widths, random weights from
    `gen`: convs and fc towers in bf16, the context in f32."""
    with torch.device(dev):
        model = RelModel(num_classes=C.VG_NUM_CLASSES,
                         num_rels=C.VG_NUM_PREDICATES, embed_dim=200,
                         hidden_dim=512, pooling_dim=4096, obj_dim=4096,
                         nl_obj=2, nl_edge=4, order="leftright", thresh=0.0,
                         dtype=torch.bfloat16, budgets=C.PadBudgets(),
                         union_chunk=512, **BENCH_FLAGS)
    random_init_(model, gen)
    return model.eval()


def check_prediction(pred, b: int, o: int, p: int, nc: int, npred: int) -> None:
    shapes = dict(boxes=(b, o, 4), obj_classes=(b, o), obj_scores=(b, o),
                  obj_valid=(b, o), rel_inds=(b, p, 2), rel_scores=(b, p, npred),
                  rel_valid=(b, p), num_valid_pairs=(b,))
    for name, shape in shapes.items():
        t = getattr(pred, name)
        require(tuple(t.shape) == shape, f"{name}: {tuple(t.shape)} != {shape}")
        require(torch.isfinite(t.float()).all(), f"{name} is not finite")
    require(int(pred.obj_valid.sum()) > 0, "no objects")
    require(int(pred.rel_valid.sum()) > 0, "no relations")
    require(int(pred.obj_classes.max()) < nc and int(pred.rel_inds.max()) < o,
            "class or object index out of range")


def run_eval(argv, datasets, device):
    """eval_rels.main with its output captured: (evaluator, the lines of its
    reports, images/s from its timing line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = eval_rels.main(argv, datasets=datasets, device=device)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(("[", "R@", "optimistic_restore: copied"))]
    rate = re.search(r"\[eval_rels\] \d+ images in [\d.]+ s, ([\d.]+) img/s",
                     buf.getvalue())
    require(rate, "eval_rels printed no timing line")
    return ev, lines, float(rate.group(1))


def check_eval_reference(dev) -> None:
    """Phase 6: eval_rels on the card == on the CPU, predcls and sgcls."""
    splits = StructuredSyntheticVG.splits(num_images=8, val_images=4,
                                          num_classes=12, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "small.pt")
        for mode in ("predcls", "sgcls"):
            argv = ["-m", mode, *SMALL_ARGS]
            with contextlib.redirect_stdout(io.StringIO()):
                cfg = C.ModelConfig.from_args(argv)
            model = build_model(cfg, splits[0], "cpu",
                                torch.Generator().manual_seed(SEED))
            set_position_stats_(model, splits[0])
            torch.save(model.state_dict(), ckpt)
            runs = []   # [CPU, card]
            for i, where in enumerate(("cpu", dev)):
                cache = os.path.join(tmp, f"{mode}_{i}.pkl")
                ev, lines, _ = run_eval(argv + ["-ckpt", ckpt, "-cache", cache],
                                        splits, where)
                require(any(f"copied {len(model.state_dict())}/" in ln for ln in lines),
                        f"eval-reference {mode}: -ckpt did not restore every tensor")
                with open(cache, "rb") as f:
                    runs.append((ev.result_dict, pickle.load(f)))
            (exp_rd, exp), (got_rd, got) = runs
            require(got_rd == exp_rd, f"eval-reference {mode}: recall lists differ: "
                    f"card {got_rd} vs CPU {exp_rd}")
            require(len(got) == len(exp) == 4, f"eval-reference {mode}: entries")
            n_rels = 0
            for g, e in zip(got, exp):
                require(np.array_equal(g["pred_rel_inds"], e["pred_rel_inds"]),
                        f"eval-reference {mode}: pred_rel_inds differ")
                require(np.array_equal(g["pred_classes"], e["pred_classes"]),
                        f"eval-reference {mode}: pred_classes differ")
                np.testing.assert_allclose(g["rel_scores"], e["rel_scores"],
                                           rtol=1e-3, atol=1e-4)
                np.testing.assert_allclose(g["obj_scores"], e["obj_scores"],
                                           rtol=1e-3, atol=1e-4)
                n_rels += len(g["pred_rel_inds"])
            recall = {k: float(np.mean(v)) for k, v in got_rd[mode + "_recall"].items()}
            print(f"eval-reference {mode}: card == CPU on 4 images 592x592 uint8 "
                  f"({n_rels} relations; R@K {recall})", flush=True)


def confident_detector_ckpt(path: str, train) -> None:
    """The weights eval_rels.main draws for sgdet, with the detector's class
    biases spread (N(0, 3^2)): random class scores sit near 1/151, below
    the 0.01 detection threshold, and would leave sgdet no object to
    relate; spread priors let boxes clear it, as a trained detector's do."""
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(["-m", "sgdet", *PUBLISHED_ARGS])
    gen = torch.Generator(device="cuda").manual_seed(eval_rels.SEED)
    model = build_model(cfg, train, "cuda", gen)
    with torch.no_grad():
        model.detector.score_fc.bias.normal_(0.0, 3.0, generator=gen)
    torch.save(model.state_dict(), path)


def check_recalls(ev, mode: str, n_val: int) -> dict:
    """Every val image evaluated once, each R@K a finite recall."""
    recalls = ev.result_dict[mode + "_recall"]
    for k, v in recalls.items():
        require(len(v) == n_val, f"eval {mode}: {len(v)} images evaluated "
                f"for R@{k}, expected each of the {n_val} val images once")
        require(math.isfinite(np.mean(v)) and 0.0 <= np.mean(v) <= 1.0,
                f"eval {mode}: R@{k} = {np.mean(v)}")
    return {k: round(float(np.mean(v)), 6) for k, v in recalls.items()}


def init_ckpt(path: str, argv: list, train, spread: bool) -> dict:
    """The weights `main` draws for `argv` (eval_rels.SEED), the detector's
    class biases spread as in phase 7 if `spread`, saved to `path`; returns
    the detector's tensors on the host."""
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(argv)
    gen = torch.Generator(device="cuda").manual_seed(eval_rels.SEED)
    model = build_model(cfg, train, "cuda", gen)
    if spread:
        with torch.no_grad():
            model.detector.score_fc.bias.normal_(0.0, 3.0, generator=gen)
    torch.save(model.state_dict(), path)
    return {k: v.cpu() for k, v in model.detector.state_dict().items()}


SPLIT_NAMES = ("detector", "sample+obj tower", "context", "rel heads",
               "loss+backward+clip", "optimizer", "skip decision")


def train_step_split(model, kw: dict, lr: float, reps: int = 3) -> dict:
    """A synced split of one training step, ms per part (median of `reps`
    steps): the frozen detector; the pair sample, object RoIAlign and
    tower; the context; the relation heads (union features, towers,
    logits); the losses, backward pass and clip; the optimizer step; the
    host read of the non-finite flag. Each boundary synchronizes the card,
    so the parts add up to more than an unsynced step."""
    marks: list = []

    def mark(*_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def loss_fn(out):
        mark()
        return rel_losses(out)

    opt = make_optimizer(model, lr)
    hooks = [model.detector.register_forward_pre_hook(mark),
             model.detector.register_forward_hook(mark),
             model.context.register_forward_pre_hook(mark),
             model.context.register_forward_hook(mark),
             opt.register_step_pre_hook(mark), opt.register_step_post_hook(mark)]
    step = make_train_step(model, opt, loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    parts = []
    try:
        for _ in range(reps):
            marks.clear()
            mark()
            losses, _ = step(kw, gen)
            mark()
            require(len(marks) == 9 and losses["skipped"].item() == 0,
                    "train split: a step boundary was not reached")
            parts.append([(b - a) * 1e3 for a, b in zip(marks[1:], marks[2:])])
    finally:
        for h in hooks:
            h.remove()
    return {name: round(statistics.median(v), 3)
            for name, v in zip(SPLIT_NAMES, zip(*parts))}


def check_train(smi: str) -> None:
    """Phase 9: the published MotifNet training config in sgcls and sgdet
    through train_rels.main, one epoch of TRAIN_WARMUP + TRAIN_TIMED
    steps, then its validation."""
    splits = StructuredSyntheticVG.splits(
        num_images=(TRAIN_WARMUP + TRAIN_TIMED) * 6, val_images=TRAIN_VAL_IMAGES,
        num_classes=C.VG_NUM_CLASSES, num_predicates=C.VG_NUM_PREDICATES, seed=SEED)
    for mode in ("sgcls", "sgdet"):
        t0 = time.time()
        argv = ["-m", mode, *TRAIN_ARGS, "-nepoch", "1", "-p", "4"]
        at_val = {}
        real_val_epoch = train_rels.val_epoch

        def val_epoch(*args, **kw):   # the launches of the training steps alone
            at_val.setdefault("launches", {n: k["wrapper"].launches
                                           for n, k in KERNELS.items()})
            return real_val_epoch(*args, **kw)

        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "init.pt")
            det_init = init_ckpt(ckpt, argv, splits[0], spread=mode == "sgdet")
            for k in KERNELS.values():
                k["wrapper"].launches = 0
            torch.cuda.reset_peak_memory_stats()
            train_rels.val_epoch = val_epoch
            try:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    res = train_rels.main(argv + ["-ckpt", ckpt], datasets=splits,
                                          device="cuda")
            finally:
                train_rels.val_epoch = real_val_epoch
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = res.history
        require(len(hist) == TRAIN_WARMUP + TRAIN_TIMED, f"train {mode}: {len(hist)} steps")
        require(all(math.isfinite(h["total"]) for h in hist), f"train {mode}: a loss is not finite")
        skipped = int(sum(h["skipped"] for h in hist))
        require(skipped == 0, f"train {mode}: {skipped} skipped steps")
        for name, v in res.model.detector.state_dict().items():
            require(torch.equal(v.cpu(), det_init[name]), f"train {mode}: detector changed at {name}")
        launches = at_val["launches"]
        require(tuple(launches.values()) == TRAIN_LAUNCHES[mode],
                f"train {mode}: launches {launches}, expected {TRAIN_LAUNCHES[mode]}")
        r = check_recalls(res.evaluator, mode, TRAIN_VAL_IMAGES)
        timed = [h["step_s"] for h in hist[TRAIN_WARMUP:]]
        med = statistics.median(timed)
        for ln in buf.getvalue().splitlines():
            if ln.startswith(("e0b", "[train_rels]", "[Loader]", "[pairs]", "R@")):
                print(f"  {ln}", flush=True)
        print(f"train {mode}: {TRAIN_TIMED} steps of 6 images 592x592 after "
              f"{TRAIN_WARMUP} warm-up on {smi}: {med:.4f} s/step median "
              f"(mean {statistics.mean(timed):.4f}, min {min(timed):.4f}, max "
              f"{max(timed):.4f}), {6 / med:.3f} img/s; peak memory {peak:.2f} GiB; "
              f"loss {hist[0]['total']:.4f} -> {hist[-1]['total']:.4f} (rel "
              f"{hist[0]['rel_loss']:.4f} -> {hist[-1]['rel_loss']:.4f}); skipped "
              f"{skipped}; training launches {launches}; val R@20/50/100 "
              f"{r[20]} / {r[50]} / {r[100]}; detector unchanged; "
              f"{time.time() - t0:.1f} s", flush=True)
        with contextlib.redirect_stdout(io.StringIO()):
            cfg = C.ModelConfig.from_args(argv)
        batch = Loader(splits[0], 6, shuffle=False, budgets=cfg.budgets,
                       **loader_im_kw(cfg)).peek()
        split = train_step_split(res.model, to_device(batch_kwargs(batch), "cuda"),
                                 cfg.lr * 6)
        print(f"train-split {mode}: one step of 6 images, synced at each part, on "
              f"{smi}: {split} ms, sum {sum(split.values()):.3f} ms", flush=True)
        del res
        torch.cuda.empty_cache()


def eval_batch_profile(argv: list, datasets) -> str:
    """One batch of the first val images through the model eval_rels.main
    builds for `argv` (its seed, its -ckpt): the synced forward on the
    host's clock (median of 3) beside the device time of its kernels
    (torch.profiler, 2 batches), K1-K3 apart; what the host adds is the
    difference."""
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(argv)
        model = build_model(cfg, datasets[0], "cuda",
                            torch.Generator(device="cuda").manual_seed(eval_rels.SEED))
        eval_rels.restore_rel_variables(cfg, model)
    batch = Loader(datasets[1], cfg.batch_size, shuffle=False, budgets=cfg.budgets,
                   **loader_im_kw(cfg)).peek()
    kw = to_device(batch_kwargs(batch), "cuda")
    model(**kw)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(**kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev_t = device_ms(lambda: model(**kw),
                      ("roi_align", "perclass_nms", "nms_mask", "nms_scan"), reps=2)
    del model
    return (f"synced forward {statistics.median(times):.3f} ms (median of 3), device "
            + ("not measured" if dev_t is None else
               f"{dev_t['all']:.3f} ms of kernels, of which K1 {dev_t['roi_align']:.3f}, "
               f"K2 {dev_t['perclass_nms']:.3f}, K3 "
               f"{dev_t['nms_mask'] + dev_t['nms_scan']:.3f} ms"))


def check_eval(smi: str) -> None:
    """Phase 7: the published MotifNet eval in all three modes. Per mode,
    a warm-up run on the SyntheticVG fallback (8 val images; the first
    batch at new shapes pays cuDNN/cuBLAS plans and allocator growth), then
    the run that is timed and counted, on EVAL_VAL_IMAGES val images."""
    timed = SyntheticVG.splits(num_images=4 * EVAL_VAL_IMAGES)
    n_val = len(timed[1])
    for mode in ("predcls", "sgcls", "sgdet"):
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["-m", mode, *PUBLISHED_ARGS]
            if mode == "sgdet":
                argv += ["-ckpt", os.path.join(tmp, "sgdet.pt")]
                confident_detector_ckpt(argv[-1], timed[0])
            ev, _, _ = run_eval(argv, None, "cuda")
            check_recalls(ev, mode, 8)   # the fallback's val split
            for k in KERNELS.values():
                k["wrapper"].launches = 0
            ev, lines, rate = run_eval(argv, timed, "cuda")
            torch.cuda.synchronize()
            launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
            profile = eval_batch_profile(argv, timed)
        r = check_recalls(ev, mode, n_val)
        require(tuple(launches.values()) == EVAL_LAUNCHES[mode],
                f"eval {mode}: launches {launches}, expected {EVAL_LAUNCHES[mode]}")
        for ln in lines:
            if not ln.startswith("optimistic_restore"):
                print(f"  {ln}", flush=True)
        print(f"eval {mode}: {n_val} images after a warm-up, {rate:.3f} img/s, "
              f"R@20/50/100 {r[20]} / {r[50]} / {r[100]}; on {smi}: "
              f"launches {launches}", flush=True)
        print(f"eval-batch {mode}: one batch of 4 on {smi}: {profile}", flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    print(smi, flush=True)

    t0 = time.time()
    so = _cuda.build()
    _cuda.lib()
    print(f"build: {time.time() - t0:.1f} s -> {so.name}", flush=True)

    # phase 3 draws from its own generator, so that the main path's weights
    # and images do not depend on what phase 3 measures
    kres = check_kernels(dev, torch.Generator(device=dev).manual_seed(SEED + 3))
    check_reference(dev)

    budgets = C.PadBudgets()
    nc, npred = C.VG_NUM_CLASSES, C.VG_NUM_PREDICATES
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = bench_model(dev, gen)
    im = C.IM_SCALE
    requests = [torch.randn(BATCH, im, im, 3, generator=gen, device=dev) * 0.3
                for _ in range(REQUESTS)]
    im_hw = torch.full((BATCH, 2), float(im), device=dev)
    pred = model(requests[0], im_hw)                 # warm-up (cuDNN, caches)
    torch.cuda.synchronize()

    for k in KERNELS.values():
        k["wrapper"].launches = 0
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for images in requests:
        t0 = time.perf_counter()
        pred = model(images, im_hw)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        check_prediction(pred, BATCH, budgets.objs_per_img, budgets.max_pairs_eval,
                         nc, npred)
    launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
    require(tuple(launches.values()) == tuple(REQUESTS * n for n in REQUEST_LAUNCHES),
            f"main path launches {launches}, expected {REQUEST_LAUNCHES} a request")
    med = statistics.median(lat)
    print(f"requests: {REQUESTS} x {BATCH} images {im}x{im} on {smi}: latency "
          f"{[round(t * 1e3, 3) for t in lat]} ms, median {med * 1e3:.3f} ms, "
          f"{BATCH / med:.3f} img/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; objects "
          f"{int(pred.obj_valid.sum())}, relations {int(pred.rel_valid.sum())}; "
          f"launches {launches}", flush=True)
    # the device time of one request, which the host's speed does not move
    # (after the counted requests: these launches are not counted)
    dev_t = device_ms(lambda: model(requests[0], im_hw),
                      ("roi_align", "perclass_nms", "nms_mask", "nms_scan"), reps=2)
    print("request device time: " + (
        "not measured" if dev_t is None else
        f"{dev_t['all']:.3f} ms of kernels a request, of which K1 "
        f"{dev_t['roi_align']:.3f}, K2 {dev_t['perclass_nms']:.3f}, K3 "
        f"{dev_t['nms_mask'] + dev_t['nms_scan']:.3f} ms"), flush=True)
    del model, requests, pred
    torch.cuda.empty_cache()

    check_eval_reference(dev)
    check_eval(smi)
    check_train_reference(dev)
    check_train(smi)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             launches=launches[name], launches_per_request=launches[name] / REQUESTS,
             **kres[name])
        for name, k in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
