"""Smoke run of the PyTorch + CUDA port (neural_motifs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failure in any phase raises, and the
script exits non-zero without a result line):

  1. device   - the card's name and power limit (nvidia-smi), torch/CUDA
                versions; refuses to run without a CUDA device.
  2. build    - nvcc builds the kernels from neural_motifs_tpu_torch/csrc
                (one process a source, all at once); cuobjdump shows what
                sm_90a makes of a shared-memory f32 and u64 atomicAdd and the
                atomics of K1's backward's shared-memory kernel.
  3. kernels  - K1 RoIAlign and its backward, K2 per-class NMS, K3 greedy
                NMS against their plain PyTorch versions on the card at the
                main paths' shapes (K1 in f32 and bf16 at R = 1000, 64, 512;
                K1's backward in f32 and bf16 at detector training's
                [6, 37, 37, 512] map and 256 RoIs an image, both the
                shared-memory kernel the dispatch takes and the scatter path
                forced, each timed (the former's whole call must take less
                device time), and the scatter path on a [1, 128, 128, 64]
                map too large for the former; K2 on
                random lanes and on the request's full lanes of clustered
                boxes; K3 on uniform random and on RPN-like clustered
                boxes, on the RPN's training budget [6, 12000] at 0.7, on
                the Stanford sgdet decode's [4 x 151, 64] lanes at 0.3, and
                on -proposals' [4, 2000] RPN-like boxes at 0.7), with the
                time of a call of each (CUDA events, the median of 10 calls
                each synced; and over 10 calls in a row, the host enqueueing
                ahead), the kernels' device time from torch.profiler (K3 split into
                its mask and scan kernels), each kernel's bound from its
                shapes (bytes over the HBM rate or f32 operations over the
                f32 peak) and share of it, and a yardstick: grid_sample for
                K1 and its backward for K1's backward (timed only; the port
                never calls them), none for K2/K3.
  4. reference- a small f32 RelModel on the card (kernels) against the same
                model on the CPU (plain versions).
  4a. detector-reference - one detector-training step (rpntrain,
                detector_losses, SGD) of a small f32 detector on the card
                (kernels, K1's backward among them) and on the CPU (plain
                versions) from one state dict, dropout off, the CPU step's
                anchor targets and RoI sample replayed on the card: the
                proposals, the four losses within rtol 1e-4, every
                gradient within 1e-3 of its leaf's largest magnitude, the
                card's SGD step within 1e-5.
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
 10. stanford requests - the Stanford message-passing model in SGDet at
                its published widths (GRU 512, union and object towers
                4096, 64 objects, 1024 pairs, bf16 towers) answers 3
                requests of 4 images as phase 5; launches 4 / 1 / 2 a
                request (K3: the RPN's NMS and the decode's per-class NMS).
 11. stanford eval-reference - phase 6 for `eval_rels -model stanford`
                (small obj_dim, f32) in predcls, sgcls and sgdet (sgdet on
                128^2 images with the detector's class biases spread).
 12. stanford eval - phase 7 for `-model stanford -b 4`: launches K1 80
                (predcls, sgcls) / 32 (sgdet), K2 8 and K3 16 in sgdet.
 13. stanford train-reference - phase 8 for a small f32 Stanford model.
 14. stanford train - phase 9 with scripts/train_stanford.sh's flags (batch
                6, lr 1e-3, clip 5): the same launches as phase 9; the
                split's parts are the detector, sample and union features,
                object tower, message passing, backward, optimizer.
 15. freq     - the frequency baseline (training/eval_rel_count.main) on 32
                val images: predcls alone (host only), then with a -ckpt of
                a seeded random detector at the published width (class
                biases spread) predcls, sgcls and sgdet; each val image with
                relations evaluated once; launches exactly K1 8 in sgcls and
                K1 / K2 / K3 8 each in sgdet.
 16. detector train - training/train_detector.main at
                scripts/pretrain_detector.sh's flags (-b 6 -lr 1e-3, clip
                5) and the published widths (VGG16 at 592^2, RPN 512 with
                20 anchors, fc 4096, 151 classes; 12 000 -> 2 000 proposals
                at 0.7, 256 RoIs and 256 anchors an image) with seeded
                random weights (class biases spread) on SyntheticVG: 2
                warm-up then 10 timed steps (s/step, img/s, peak memory,
                the losses), launches exactly K1 / K1 backward / K3 once a
                step and K1 / K2 / K3 once a validation batch, the mAP@0.5
                validation over 12 val images (each once, mAP in [0, 1]),
                the -save_dir checkpoint restored into a fresh model,
                optimizer, schedule, generator and loader bit for bit; then
                a synced split of one step and the kernels' device time of
                one step (K1's backward the shared-memory kernel, no scatter
                or cast launch), and K1's backward alone on that step's RoIs.
 17. published weights and proposals - first phase 6 for a reference
                checkpoint: a small reference vgrel .tar (phase 6's widths)
                through eval_rels -ckpt on the CPU and on the card in sgdet
                -proposals (proposals around the GT), card == CPU.
                Then a reference vgrel .tar at the published MotifNet
                widths (hidden 512, pooling 4096, nl_obj 2, nl_edge 4;
                seeded) through eval_rels with scripts/eval_models.sh's
                flags (-test, 16 SyntheticVG images) in sgcls and in sgdet
                -proposals (2000 RPN-like proposals an image around the
                GT): no relation-model key missing, each image evaluated
                once, launches exactly K1 40 (sgcls) / K1 16, K2 4, K3 4
                (sgdet: K3 once a batch, over the proposals), R@K, img/s
                and one batch's kernels; then 2 warm-up + 3 timed steps of
                scripts/refine_for_detection.sh's training (sgdet
                -proposals, -ckpt the .tar): finite losses, no skipped
                step, the detector as imported, launches K1 3 / K2 1 / K3 1
                a step; then a Stanford reference .tar through eval_rels
                -model stanford in sgdet -proposals (K1 16, K2 4, K3 8).

The line before the last is the kernels' JSON record (per kernel: its
launches on its main path (`main_path`: the MotifNet SGDet request; for
K1's backward, detector training) and on every path, error, time, plain
time, bound and share of it, device time, yardstick or the reason for
none; K3's `proposals` entry, the -proposals shape, with its launches on
phase 17's sgdet eval); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
import json
import math
import os
import pickle
import re
import shutil
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
from neural_motifs_tpu_torch.models import detector as detector_mod
from neural_motifs_tpu_torch.models.detector import ObjectDetector
from neural_motifs_tpu_torch.models.rel_model import RelModel, disable_dropout_
from neural_motifs_tpu_torch.models.rel_model_stanford import RelModelStanford
from neural_motifs_tpu_torch.ops import _cuda
from neural_motifs_tpu_torch.ops import nms
from neural_motifs_tpu_torch.ops import roi_align as ra
from neural_motifs_tpu_torch.ops.sampling import AnchorTargets, DetSample
from neural_motifs_tpu_torch.training import (checkpoint, eval_rel_count, eval_rels,
                                              train_detector, train_rels)
from neural_motifs_tpu_torch.training.build import batch_kwargs, build_model
from neural_motifs_tpu_torch.training.losses import detector_losses, rel_losses
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
# the kernels' launches (K1, K2, K3, K1's backward) on each path: 4 / 1 / 1
# a SGDet request; over the 32 val images of phase 7 (8 batches); over the
# 12 training steps of phase 9 (relation training never differentiates
# RoIAlign: the detector is frozen)
REQUEST_LAUNCHES = (4, 1, 1, 0)
EVAL_LAUNCHES = {"predcls": (80, 0, 0, 0), "sgcls": (80, 0, 0, 0), "sgdet": (32, 8, 8, 0)}
TRAIN_LAUNCHES = {"sgcls": (36, 0, 0, 0), "sgdet": (36, 12, 12, 0)}
# the Stanford model (phases 10-14): scripts/train_stanford.sh's flags; its
# GRU width 512 and union width 4096 are fixed, obj_dim 4096 is the default
STANFORD_ARGS = "-model stanford -b 4".split()
STANFORD_TRAIN_ARGS = "-model stanford -b 6 -lr 1e-3 -clip 5".split()
STANFORD_SMALL_ARGS = "-model stanford -obj_dim 128 -b 2 -dtype float32 -max_gt_boxes 16".split()
# a Stanford SGDet request: K3 twice, the RPN's proposals and the decode's
# per-class NMS over 4 x 151 lanes of the 64 objects (exact: 256 >= 64)
STANFORD_REQUEST_LAUNCHES = (4, 1, 2, 0)
STANFORD_EVAL_LAUNCHES = {"predcls": (80, 0, 0, 0), "sgcls": (80, 0, 0, 0),
                          "sgdet": (32, 8, 16, 0)}
# the frequency baseline's detectors over the 32 val images (8 batches of
# 4): the gtbox classifier RoIAligns once a batch; the sgdet detector
# RoIAligns its proposals, and runs its RPN NMS and filter_det
FREQ_LAUNCHES = {"sgcls": (8, 0, 0, 0), "sgdet": (8, 8, 8, 0)}
# detector pretraining (phase 16): scripts/pretrain_detector.sh's flags
# with the clip of the JAX entry point's default; each training step
# RoIAligns its sampled RoIs (K1) and differentiates them (K1's backward)
# and runs the RPN's proposal NMS (K3); each validation batch is the
# refinerels path (K1, K2, K3)
DET_TRAIN_ARGS = "-b 6 -lr 1e-3 -clip 5".split()
DET_STEP_LAUNCHES = (1, 0, 1, 1)
DET_VAL_BATCH_LAUNCHES = (1, 1, 1, 0)
DET_VAL_IMAGES = 12
# published weights and proposals (phase 17): precomputed proposals an
# image (VG's proposals.h5 holds up to 2000, the collate's budget);
# scripts/eval_models.sh's flags (its -test split) and
# scripts/refine_for_detection.sh's, each with -ckpt a reference .tar. A
# -proposals batch or step runs K3 once, over the proposals, in place of
# the RPN's NMS: the launches are those of the RPN path
PROPOSALS = 2000
REF_EVAL_ARGS = PUBLISHED_ARGS + ["-test"]
REFINE_ARGS = ("-m sgdet -model motifnet -order leftright -nl_obj 2 -nl_edge 4 "
               "-hidden_dim 512 -pooling_dim 4096 -use_bias -b 6 -lr 1e-4 -clip 5 "
               "-proposals").split()
REF_EVAL_IMAGES = 16   # the -test split of phase 17 (4 batches of 4)
REF_EVAL_LAUNCHES = {"sgcls": (40, 0, 0, 0), "sgdet": (16, 4, 4, 0),
                     "stanford sgdet": (16, 4, 8, 0)}
REF_TRAIN_WARMUP, REF_TRAIN_TIMED = 2, 3
REF_STEP_LAUNCHES = (3, 1, 1, 0)
# the published MotifNet widths of a reference vgrel checkpoint, and phase
# 6's small ones (its card-vs-CPU check, at the dataset's class counts)
PUBLISHED_WIDTHS = dict(nc=C.VG_NUM_CLASSES, npred=C.VG_NUM_PREDICATES, obj_dim=4096,
                        pool_dim=4096, embed_dim=200, hidden=512, nl_obj=2, nl_edge=4)
SMALL_WIDTHS = dict(obj_dim=128, pool_dim=128, embed_dim=16, hidden=24, nl_obj=2, nl_edge=2)

KERNELS = {
    "roi_align_fwd": dict(
        wrapper=ra.roi_align_cuda, source="neural_motifs_tpu_torch/csrc/roi_align.cu",
        replaces="neural_motifs_tpu/ops/pallas_roi_align.py:158",
        main_path="motifnet request"),
    "perclass_nms": dict(
        wrapper=nms.perclass_nms_cuda, source="neural_motifs_tpu_torch/csrc/nms.cu",
        replaces="neural_motifs_tpu/ops/pallas_nms.py:128", main_path="motifnet request"),
    "greedy_nms": dict(
        wrapper=nms.greedy_nms_cuda, source="neural_motifs_tpu_torch/csrc/nms.cu",
        replaces="neural_motifs_tpu/ops/pallas_nms.py:151", main_path="motifnet request"),
    "roi_align_bwd": dict(
        wrapper=ra.roi_align_bwd_cuda, source="neural_motifs_tpu_torch/csrc/roi_align.cu",
        replaces="neural_motifs_tpu/ops/pallas_roi_align.py:170", main_path="detector train"),
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


def device_ms(fn, names: tuple, reps: int = 10, tries: int = 3) -> dict | None:
    """Device time per call from torch.profiler's key_averages(): summed
    over the kernels whose names hold each of `names`, and over every
    kernel of the call ("all"); profiled again where a profile shows no
    device time (deep into a run it sometimes records none), None where
    none of `tries` does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
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
        if out["all"]:
            return out
    return None


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


def roi_align_bwd_bound(b: int, h: int, w: int, c: int, r: int, p: int,
                        elem: int) -> tuple:
    """K1's backward: the upstream gradient read once, the RoIs and flags,
    the map's gradient written once in the map's type; per gradient value
    two tap products, then four weighted atomic adds (10 f32 operations)."""
    n_g = b * r * p * p * c
    return bound(n_g * elem + b * r * (4 * 4 + 1) + b * h * w * c * elem, n_g * 10)


def greedy_pairs(keep_sorted, valid_sorted) -> int:
    """The IoU tests this data needs: every kept box against each valid box
    ranked after it (a suppressed box suppresses nothing)."""
    v = valid_sorted.long()
    later = v.flip(-1).cumsum(-1).flip(-1) - v
    return int((later * keep_sorted.long()).sum())


def nms_bound(n_boxes: int, bytes_per_box: int, pairs: int) -> tuple:
    return bound(n_boxes * bytes_per_box, pairs * IOU_OPS)


def rpn_like_boxes(gen, dev, n: int, lanes: int = BATCH):
    """RPN-like clustered proposals: n of the 37x37x20 anchors of a 592^2
    image per lane, decoded with seeded deltas (N(0, 0.1) centres, N(0,
    0.2) log-sizes) and clipped to the image."""
    from neural_motifs_tpu_torch.ops.anchors import generate_anchors
    from neural_motifs_tpu_torch.ops.boxes import bbox_preds, clip_boxes
    anchors = torch.from_numpy(generate_anchors().reshape(-1, 4)).to(dev)
    pick = torch.rand(lanes, len(anchors), generator=gen, device=dev).argsort(1)[:, :n]
    deltas = torch.randn(lanes, n, 4, generator=gen, device=dev) \
        * torch.tensor([0.1, 0.1, 0.2, 0.2], device=dev)
    im = torch.full((lanes, 1), float(C.IM_SCALE), device=dev)
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


def yardstick_grid_sample_bwd(fmap, rois, p: int, scale: float):
    """The backward of `yardstick_grid_sample`'s grid_sample with respect to
    its input (one autograd call over a recorded forward), at the same
    points, for an upstream gradient of the crops' size. Timed as K1's
    backward's yardstick only; the port never calls it."""
    x = fmap.permute(0, 3, 1, 2).detach().requires_grad_(True)      # NCHW view
    out = yardstick_grid_sample(x.permute(0, 2, 3, 1), rois, p, scale)()
    g = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, x, g, retain_graph=True)


def rand_boxes(gen, shape, scale, dev):
    xy = torch.rand(shape + (2,), generator=gen, device=dev) * scale
    wh = 1.0 + torch.rand(shape + (2,), generator=gen, device=dev) * (scale / 2)
    return torch.cat([xy, xy + wh], -1)


def det_train_rois(gen, dev, b: int = 6, n_props: int = 2000, max_gt: int = 12):
    """RoIs drawn as a detector-training step draws them: `proposal_assign_det`
    over 2000 RPN-like proposals an image and 3 to 12 GT boxes (SyntheticVG's
    range, anchor-shaped and inside the image), 256 RoIs an image at 25 %
    fg. Returns the sample's rois [b, 256, 4] and valid [b, 256]."""
    from neural_motifs_tpu_torch.ops.sampling import proposal_assign_det
    props = rpn_like_boxes(gen, dev, n_props, lanes=b)
    gt = rpn_like_boxes(gen, dev, max_gt, lanes=b)
    n_gt = torch.randint(3, max_gt + 1, (b, 1), generator=gen, device=dev)
    gt_mask = torch.arange(max_gt, device=dev) < n_gt
    gt_classes = torch.randint(1, 151, (b, max_gt), generator=gen, device=dev) * gt_mask
    det = proposal_assign_det(props, torch.ones(b, n_props, dtype=torch.bool, device=dev),
                              gt, gt_classes, gt_mask, generator=gen)
    return det.rois, det.valid


def bwd_times(call, names: tuple, b_ms: float) -> dict:
    """One path of K1's backward: a synced call, a call in a stream of
    calls, the device time of the kernels named and of every kernel of the
    call (the scatter path's zero-fill included), and the share of the
    bound on each."""
    t_k, t_s = time_ms(call), pipelined_ms(call)
    dev_t = device_ms(call, names)
    return dict(ms=t_k, pipelined_ms=t_s, share_of_bound=b_ms / t_k,
                device_ms=dev_t and sum(dev_t[n] for n in names),
                kernels_ms=dev_t and {n: dev_t[n] for n in names},
                call_device_ms=dev_t and dev_t["all"],
                device_share_of_bound=dev_t and b_ms / dev_t["all"])


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


# Shared-memory atomic adds on f32 and u64, compiled alone: what sm_90a
# makes of them (phase 2)
ATOMIC_PROBE_CU = r"""
__global__ void probe_f32(float* o, float v) {
  __shared__ float s[64];
  s[threadIdx.x % 64] = 0.f;
  __syncthreads();
  atomicAdd(s + (threadIdx.x * 7) % 64, v);
  __syncthreads();
  o[threadIdx.x] = s[threadIdx.x % 64];
}
__global__ void probe_u64(unsigned long long* o, unsigned long long v) {
  __shared__ unsigned long long s[64];
  s[threadIdx.x % 64] = 0;
  __syncthreads();
  atomicAdd(s + (threadIdx.x * 7) % 64, v);
  __syncthreads();
  o[threadIdx.x] = s[threadIdx.x % 64];
}
"""


def sass_functions(binary) -> dict:
    """The atomic instructions cuobjdump --dump-sass finds in each function
    of a built binary, by (mangled) name."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_cuda._find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDS)\.[\w.]+)", fn)
        out[fn.split(None, 1)[0]] = dict(collections.Counter(ops))
    return out


def sass_atomics(so) -> str:
    """What sm_90a makes of a shared-memory f32 and u64 atomicAdd (a native
    add, or a compare-and-swap loop: ATOMS.CAST.SPIN), and the atomic
    instructions of K1's backward's shared-memory kernel in the built
    library (its locks' integer compare-and-swap and exchange)."""
    found = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
            with open(src, "w") as f:
                f.write(ATOMIC_PROBE_CU)
            subprocess.run([_cuda._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-cubin", "-o", cubin, src], capture_output=True, check=True)
            for name, ops in sass_functions(cubin).items():
                kind = "f32" if "probe_f32" in name else "u64"
                found.append(f"shared {kind} atomicAdd -> {ops}")
        for name, ops in sass_functions(so).items():
            if "roi_align_bwd_smem_kernel" in name:
                types = re.search(r"roi_align_bwd_smem_kernelI(.*?)EEv", name)
                found.append(f"roi_align_bwd_smem_kernel<{types.group(1) if types else name}> "
                             f"-> {ops}")
    except (OSError, subprocess.CalledProcessError) as e:
        return f"not read ({e})"
    return "; ".join(found)


def check_roi_align_bwd_large(dev, gen) -> dict:
    """A [1, 128, 128, 64] map, whose 32-channel accumulator does not fit
    in shared memory: the dispatch takes the scatter path, which matches the
    plain version (f32 within 1e-5, bf16 within rtol 1e-2 + 1e-3 of the
    largest magnitude)."""
    shape = (1, 128, 128, 64)
    require(not ra._bwd_smem_fits(128, 128, 7),
            "K1 backward: a 128x128 map must take the scatter path")
    fmap = torch.randn(shape, generator=gen, device=dev)
    rois = rand_boxes(gen, (1, 100), 2048, dev) - 100.0
    valid = torch.rand(1, 100, generator=gen, device=dev) < 0.9
    g = torch.randn(1, 100, 7, 7, 64, generator=gen, device=dev)
    exp = ra._roi_align_bwd_plain(g, fmap, rois, valid, 1 / 16)
    scale = exp.abs().max().item()
    got = ra.roi_align_bwd_cuda(g, rois, valid, shape, torch.float32, 1 / 16)
    err = (got - exp).abs().max().item()
    require(scale > 0 and err <= 1e-5 * scale,
            f"K1 backward 128x128 f32 max abs error {err} > 1e-5 x {scale}")
    g16 = g.bfloat16()
    exp16 = ra._roi_align_bwd_plain(g16.float(), fmap, rois, valid, 1 / 16)
    got16 = ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16, 1 / 16)
    torch.testing.assert_close(got16.float(), exp16, rtol=1e-2,
                               atol=1e-3 * exp16.abs().max().item())
    print(f"K1 roi_align_bwd large map {list(shape)} R=100: the scatter path, f32 "
          f"max|err| {err:.3e} ({err / scale:.2e} of the largest, tol 1e-5), bf16 within "
          f"rtol 1e-2", flush=True)
    return dict(shape=list(shape), path="scatter", max_abs_err=err,
                max_abs_err_rel=err / scale)


def check_roi_align_bwd(dev, gen) -> dict:
    """K1's backward at detector training's shape: a [6, 37, 37, 512] map,
    256 RoIs an image drawn as a training step draws them (det_train_rois).
    Both paths, the shared-memory kernel the dispatch takes and the scatter
    path forced (`_scatter=True`), against the plain version (autograd of the
    separable form in f32 on the same values): f32 within 1e-5 of the
    largest magnitude (atomics sum in another order), bf16 within rtol 1e-2
    + 1e-3 of it (one rounding of the f32 sums); then each path's times on
    the bf16 call, bound and share, beside the plain version and the
    yardstick; the shared-memory kernel's whole call must take less device
    time than the scatter path's; a map too large for it (the scatter
    path)."""
    b, r, shape = 6, 256, (6, 37, 37, 512)
    fmap = torch.randn(shape, generator=gen, device=dev)
    rois, valid = det_train_rois(gen, dev, b)
    require(rois.shape == (b, r, 4) and bool(valid.all()),
            f"K1 backward: the sample is {tuple(rois.shape)}, {int(valid.sum())} valid")
    require(ra._bwd_smem_fits(37, 37, 7),
            "K1 backward: the training shape must take the shared-memory kernel")
    g = torch.randn(b, r, 7, 7, 512, generator=gen, device=dev)
    exp = ra._roi_align_bwd_plain(g, fmap, rois, valid, 1 / 16)
    scale = exp.abs().max().item()
    g16, f16 = g.bfloat16(), fmap.bfloat16()
    exp16 = ra._roi_align_bwd_plain(g16.float(), fmap, rois, valid, 1 / 16)
    errs = {}
    for path in ("kernel", "scatter"):
        got = ra.roi_align_bwd_cuda(g, rois, valid, shape, torch.float32, 1 / 16,
                                    _scatter=path == "scatter")
        errs[path] = (got - exp).abs().max().item()
        require(scale > 0 and errs[path] <= 1e-5 * scale,
                f"K1 backward ({path}) f32 max abs error {errs[path]} > 1e-5 x {scale}")
        got16 = ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16, 1 / 16,
                                      _scatter=path == "scatter")
        torch.testing.assert_close(got16.float(), exp16, rtol=1e-2,
                                   atol=1e-3 * exp16.abs().max().item())
    del exp, got, exp16, got16

    def call(scatter):
        return lambda: ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16,
                                             1 / 16, _scatter=scatter)

    b_ms, b_by = roi_align_bwd_bound(b, 37, 37, 512, r, 7, 2)
    kern = bwd_times(call(False), ("roi_align_bwd_smem",), b_ms)
    scat = bwd_times(call(True), ("roi_align_bwd_kernel", "cast_bf16"), b_ms)
    t_p = time_ms(lambda: ra._roi_align_bwd_plain(g16, f16, rois, valid, 1 / 16), reps=3)
    lib = time_ms(yardstick_grid_sample_bwd(f16, rois, 7, 1 / 16))
    head = "K1 roi_align_bwd bf16 [6, 37, 37, 512] R=256"
    for label, err, t in (("shared-memory kernel", errs["kernel"], kern),
                          ("scatter path", errs["scatter"], scat)):
        parts = ("not measured" if t["kernels_ms"] is None else
                 ", ".join(f"{n} {v:.4f}" for n, v in t["kernels_ms"].items()))
        print(f"{head} {label}: f32 max|err| {err:.3e} ({err / scale:.2e} of the largest, "
              f"tol 1e-5), bf16 within rtol 1e-2; {t['ms']:.4f} ms a synced call "
              f"({t['pipelined_ms']:.4f} in a stream of calls; device: {parts}, every "
              f"kernel of the call {fmt_ms(t['call_device_ms'])} ms); bound {b_ms:.4f} ms "
              f"({b_by}), share of bound {t['share_of_bound']:.3f} on the call, "
              f"{fmt_ms(t['device_share_of_bound'])} on device time", flush=True)
    print(f"{head}: plain {t_p:.3f} ms, grid_sample backward {lib:.4f} ms", flush=True)
    require(kern["call_device_ms"] is not None and scat["call_device_ms"] is not None,
            "K1 backward: the profiler recorded no device time for a path, so the "
            "two paths cannot be compared")
    require(kern["call_device_ms"] < scat["call_device_ms"],
            f"K1 backward: the shared-memory kernel's device time "
            f"{kern['call_device_ms']} ms is not below the scatter path's "
            f"{scat['call_device_ms']} ms")
    large = check_roi_align_bwd_large(dev, gen)
    return dict(shape=[b, r, 37, 37, 512], path="shared memory",
                max_abs_err=errs["kernel"], max_abs_err_rel=errs["kernel"] / scale,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=lib, **kern,
                scatter=dict(max_abs_err=errs["scatter"], **scat), large_map=large)


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

    # K1's backward from its own generator, so that the K2 / K3 data below
    # stay as they were
    res["roi_align_bwd"] = check_roi_align_bwd(
        dev, torch.Generator(device=dev).manual_seed(SEED + 9))

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
    # boxes and on RPN-like clustered ones; and the Stanford sgdet decode's
    # lanes at 0.3, a lane an (image, class): the class's boxes of the
    # image's 64 objects (RPN-like boxes, each jittered per class as a box
    # regressor moves it)
    def k3_case(kind):
        if kind == "decode_lanes":
            base = rpn_like_boxes(gen, dev, 64)[:, None]                  # [4, 1, 64, 4]
            jit = torch.randn(BATCH, 151, 64, 4, generator=gen, device=dev) * 6.0
            lo = base[..., :2] + jit[..., :2]
            boxes = torch.cat([lo, torch.maximum(base[..., 2:] + jit[..., 2:], lo + 1.0)],
                              -1).reshape(BATCH * 151, 64, 4)
            thresh = 0.3
        elif kind == "rpn_train":   # the RPN's training budget: 6 images, top 12 000
            boxes = rpn_like_boxes(gen, dev, 12000, lanes=6)
            thresh = 0.7
        elif kind == "proposals":   # -proposals: 2000 precomputed proposals an image
            boxes = rpn_like_boxes(gen, dev, PROPOSALS)
            thresh = 0.7
        else:
            boxes = (rand_boxes(gen, (BATCH, 6000), 592, dev) if kind == "random"
                     else rpn_like_boxes(gen, dev, 6000))
            thresh = 0.7
        scores = torch.rand(boxes.shape[:2], generator=gen, device=dev)
        valid = torch.rand(boxes.shape[:2], generator=gen, device=dev) < 0.95
        return boxes, scores, valid, thresh

    k3 = {}
    for kind in ("random", "clustered", "decode_lanes", "rpn_train", "proposals"):
        boxes, scores, valid, thresh = k3_case(kind)
        lanes, n = scores.shape
        got = nms.greedy_nms_cuda(boxes, scores, valid, thresh)
        exp = nms._greedy_nms_plain(boxes, scores, valid, thresh)
        diff = (got != exp).sum().item()
        require(diff == 0, f"K3 keep masks differ in {diff} places ({kind})")
        require(0 < int(got.sum()) < int(valid.sum()), f"K3 {kind}: nothing suppressed")
        t_k = time_ms(lambda: nms.greedy_nms_cuda(boxes, scores, valid, thresh))
        t_s = pipelined_ms(lambda: nms.greedy_nms_cuda(boxes, scores, valid, thresh))
        t_p = time_ms(lambda: nms._greedy_nms_plain(boxes, scores, valid, thresh), reps=3)
        split = device_ms(lambda: nms.greedy_nms_cuda(boxes, scores, valid, thresh),
                          ("nms_mask", "nms_scan"))
        _, order = nms.sort_desc(torch.where(valid, scores, torch.full_like(scores, -1.0)), 1)
        pairs = greedy_pairs(got.gather(1, order), valid.gather(1, order))
        b_ms, b_by = nms_bound(lanes * n, 16 + 4 + 1 + 1, pairs)
        k3[kind] = dict(shape=[lanes, n], iou_thresh=thresh, ms=t_k, pipelined_ms=t_s,
                        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                        share_of_bound=b_ms / t_k, kept=int(got.sum()), iou_tests=pairs,
                        upper_triangle_tests=lanes * n * (n - 1) // 2,
                        mask_ms=split and split["nms_mask"],
                        scan_ms=split and split["nms_scan"],
                        call_device_ms=split and split["all"])
        print(f"K3 greedy_nms {kind} [{lanes}, {n}] at {thresh}: keep identical "
              f"({int(got.sum())} kept); kernel {t_k:.4f} ms a synced call ({t_s:.4f} in a "
              f"stream of calls; device: mask "
              f"{split['nms_mask'] if split else 'not measured'}, scan "
              f"{split['nms_scan'] if split else 'not measured'} ms, every kernel of the "
              f"call {split['all'] if split else 'not measured'} ms), plain {t_p:.3f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}, {pairs} IoU tests of "
              f"{lanes * n * (n - 1) // 2} in the upper triangles), share {b_ms / t_k:.4f}",
              flush=True)
    res["greedy_nms"] = dict(max_abs_err=0.0, **k3["random"], clustered=k3["clustered"],
                             decode_lanes=k3["decode_lanes"], rpn_train=k3["rpn_train"],
                             proposals=k3["proposals"],
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


def small_motifnet(mode: str, budgets: C.PadBudgets) -> RelModel:
    """Phase 8's f32 MotifNet: the published flags at small widths."""
    return RelModel(num_classes=12, num_rels=8, mode=mode, embed_dim=16, hidden_dim=24,
                    pooling_dim=128, obj_dim=128, nl_obj=2, nl_edge=2, order="leftright",
                    thresh=0.0, dtype=torch.float32, budgets=budgets, **PUBLISHED_FLAGS)


def small_stanford(mode: str, budgets: C.PadBudgets) -> RelModelStanford:
    """Phase 13's f32 Stanford model at small widths."""
    return RelModelStanford(num_classes=12, num_rels=8, mode=mode, obj_dim=128,
                            pooling_dim=128, size=32, thresh=0.0, dtype=torch.float32,
                            budgets=budgets)


def check_train_reference(dev, label: str, build) -> None:
    """Phases 8 and 13: one train step of `build(mode, budgets)`, the card ==
    the CPU, sgcls and sgdet."""
    im = 96
    for mode in ("sgcls", "sgdet"):
        gen = torch.Generator().manual_seed(SEED + 2)
        budgets = C.PadBudgets(max_gt_boxes=8, max_gt_rels=8, rpn_pre_nms_topn_test=720,
                               rpn_post_nms_topn_test=32, objs_per_img=8,
                               per_class_nms_topk=16)
        cpu_model = build(mode, budgets)
        random_init_(cpu_model, torch.Generator().manual_seed(SEED))
        disable_dropout_(freeze_detector_(cpu_model))
        images = torch.randn(2, im, im, 3, generator=gen) * 0.4
        im_hw = torch.full((2, 2), float(im))
        boxes, classes, mask, (rels, rel_mask) = small_gt(gen, 2, im, 12)
        if mode == "sgdet":   # the GT: five detections (labels follow by IoU)
            with torch.no_grad():
                det = cpu_model.detector(images, im_hw)
            require(bool(det.rm_valid.all()), f"{label}train-reference: too few detections")
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
                f"{label}train-reference {mode}: object labels differ")
        n_fg = int((out.rel_valid & (out.rel_labels > 0)).sum())
        require(n_fg > 0 and int(out.rel_valid.sum()) > n_fg,
                f"{label}train-reference {mode}: degenerate sample")
        for k in ("class_loss", "rel_loss", "total"):
            torch.testing.assert_close(got[k].cpu(), exp[k], rtol=1e-4, atol=0.0)
        require(got["skipped"].item() == 0 and exp["skipped"].item() == 0,
                f"{label}train-reference {mode}: skipped step")
        gpu_params = dict(gpu_model.named_parameters())
        worst_g = worst_s = worst_p = 0.0
        for name, p in cpu_model.named_parameters():
            q = gpu_params[name]
            if name.startswith("detector."):
                require(q.grad is None and torch.equal(q, det_before[name[9:]]),
                        f"{label}train-reference {mode}: the detector changed at {name}")
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
        require(worst_g <= 1e-3, f"{label}train-reference {mode}: gradient off by {worst_g:.2e}")
        require(worst_s <= 1e-5, f"{label}train-reference {mode}: SGD step off by {worst_s:.2e}")
        print(f"{label}train-reference {mode}: card == CPU for one train step ({n_fg} fg / "
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


def check_detector_reference(dev) -> None:
    """Phase 4a: one detector-training step of a small f32 rpntrain
    detector (96^2 images, VGG16, a 128-wide fc tower, 12 classes) on the
    card and on the CPU (PyTorch's own convolutions) from one state dict,
    dropout off; the CPU step's anchor targets and RoI sample (its indices
    into the card's own proposals + GT) replayed on the card."""
    im = 96
    budgets = C.PadBudgets(max_gt_boxes=8, rois_per_img=32, rpn_pre_nms_topn_train=720,
                           rpn_post_nms_topn_train=64)
    cpu_model = ObjectDetector(num_classes=12, mode="rpntrain", obj_dim=128,
                               dtype=torch.float32, budgets=budgets)
    random_init_(cpu_model, torch.Generator().manual_seed(SEED))
    disable_dropout_(cpu_model)
    gen = torch.Generator().manual_seed(SEED + 8)
    images = torch.randn(2, im, im, 3, generator=gen) * 0.4
    boxes, classes, mask, _ = small_gt(gen, 2, im, 12)
    boxes[:, 0] = torch.tensor([2.0, 3.0, 90.0, 92.0])   # large: some proposals are fg
    kw = dict(images=images, im_hw=torch.full((2, 2), float(im)), gt_boxes=boxes,
              gt_classes=classes, gt_mask=mask)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    init = {k: v.detach().clone() for k, v in cpu_model.named_parameters()}
    lr, l2 = 6e-3, 1e-4   # lr 1e-3 x batch 6, as the published run's
    opts = [make_optimizer(m, lr, l2=l2) for m in (cpu_model, gpu_model)]
    steps = [make_train_step(m, o, detector_losses) for m, o in zip((cpu_model, gpu_model), opts)]
    # the CPU's convolutions without oneDNN: its f32 backward of the trunk's
    # 6x6 convs is 4e-2 of the leaf's largest magnitude off a float64
    # step, PyTorch's own CPU convolution within 1e-6
    with torch.backends.mkldnn.flags(enabled=False):
        exp, out = steps[0](kw, generator=torch.Generator().manual_seed(SEED))
    anchor = AnchorTargets(out.rpn_labels.to(dev), out.rpn_target_boxes.to(dev))
    det = DetSample(*(t.to(dev) for t in out.det_sample))
    zero_launches()
    got, gout = steps[1]({k: v.to(dev) for k, v in kw.items()}, anchor_sample=anchor,
                         det_sample=det)
    torch.cuda.synchronize()
    launches = count_launches()
    require(tuple(launches.values()) == DET_STEP_LAUNCHES,
            f"detector-reference: launches {launches}, expected {DET_STEP_LAUNCHES}")
    fg = out.od_valid & (out.od_labels > 0)
    from_props = fg & (out.det_sample.idx < budgets.rpn_post_nms_topn_train)
    n_anchor_fg = int((out.rpn_labels == 1).sum())
    require(int(from_props.sum()) > 0 and n_anchor_fg > 0,
            "detector-reference: no fg RoI among the proposals or no fg anchor")
    torch.testing.assert_close(gout.od_rois.detach().cpu(), out.od_rois.detach(),
                               rtol=1e-4, atol=1e-3)
    for k in ("class_loss", "box_loss", "rpn_class_loss", "rpn_box_loss", "total"):
        torch.testing.assert_close(got[k].cpu(), exp[k], rtol=1e-4, atol=0.0)
    require(got["skipped"].item() == 0 and exp["skipped"].item() == 0,
            "detector-reference: skipped step")
    gpu_params = dict(gpu_model.named_parameters())
    worst_g = worst_s = 0.0
    for name, p in cpu_model.named_parameters():
        q = gpu_params[name]
        g = q.grad.cpu()
        scale = max(p.grad.abs().max().item(), 1e-12)
        worst_g = max(worst_g, (g - p.grad).abs().max().item() / scale)
        scale = max(p.detach().abs().max().item(), 1e-12)
        p0 = init[name]
        stepped = p0 - lr * (g + l2 * p0)
        worst_s = max(worst_s, (q.detach().cpu() - stepped).abs().max().item() / scale)
    require(worst_g <= 1e-3, f"detector-reference: gradient off by {worst_g:.2e}")
    require(worst_s <= 1e-5, f"detector-reference: SGD step off by {worst_s:.2e}")
    print(f"detector-reference: card == CPU for one detector-training step ({int(fg.sum())} "
          f"fg RoIs, {int(from_props.sum())} of them proposals; {n_anchor_fg} fg anchors; "
          f"losses {({k: round(v.item(), 6) for k, v in exp.items() if 'loss' in k})}); "
          f"gradients within {worst_g:.2e}, the card's SGD step within {worst_s:.2e} of "
          f"each leaf's max; launches {launches}", flush=True)


def window_s(hist: list) -> float:
    """Seconds a step over the timed steps of a run's history, from the end
    of the last warm-up step's call to the end of the last step's: the
    loader, the prefetch copy and the host work between the steps count."""
    return (hist[-1]["end_s"] - hist[TRAIN_WARMUP - 1]["end_s"]) / (len(hist) - TRAIN_WARMUP)


def detector_step_split(model, kw: dict, lr: float, dev, reps: int = 3) -> dict:
    """A synced split of one detector-training step, ms per part (median of
    `reps` steps): the VGG trunk; the RPN head and its proposals (K3); the
    anchor and RoI samplers; the RoI head (K1) and classifiers; the
    losses; the backward pass (K1's backward); the clip; the host read of
    the non-finite flag; the optimizer step. Each boundary synchronizes."""
    names = ("trunk", "rpn+proposals", "samplers", "roi head", "losses", "backward",
             "clip", "non-finite read", "optimizer")
    marks: list = []

    def mark(*_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def marked(fn, before: bool, after: bool):
        def wrapper(*a, **k):
            if before:
                mark()
            out = fn(*a, **k)
            if after:
                mark()
            return out
        return wrapper

    def loss_fn(out):
        mark()
        losses = detector_losses(out)
        mark()
        return losses

    opt = make_optimizer(model, lr)
    real = (detector_mod.anchor_targets, detector_mod.proposal_assign_det,
            torch.nn.utils.clip_grad_norm_)
    detector_mod.anchor_targets = marked(real[0], True, False)
    detector_mod.proposal_assign_det = marked(real[1], False, True)
    torch.nn.utils.clip_grad_norm_ = marked(real[2], False, True)
    first = model.features.convs[0].weight
    hooks = [model.features.register_forward_hook(mark),
             first.register_post_accumulate_grad_hook(mark),
             opt.register_step_pre_hook(mark), opt.register_step_post_hook(mark)]
    step = make_train_step(model, opt, loss_fn)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    parts = []
    try:
        for _ in range(reps):
            marks.clear()
            mark()
            losses, _ = step(kw, gen)
            require(len(marks) == 10 and losses["skipped"].item() == 0,
                    "detector split: a step boundary was not reached")
            parts.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
    finally:
        (detector_mod.anchor_targets, detector_mod.proposal_assign_det,
         torch.nn.utils.clip_grad_norm_) = real
        for h in hooks:
            h.remove()
    return {name: round(statistics.median(v), 3) for name, v in zip(names, zip(*parts))}


def check_detector_train(smi: str, dev) -> dict:
    """Phase 16: detector pretraining through train_detector.main at the
    published flags and widths on SyntheticVG (seeded random weights, the
    class biases spread), one epoch of TRAIN_WARMUP + TRAIN_TIMED steps and
    its mAP validation over DET_VAL_IMAGES images. Returns the launches of
    its training steps and of its validation."""
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    splits = (SyntheticVG(n_steps * 6, "train", seed=SEED),
              SyntheticVG(DET_VAL_IMAGES, "val", seed=SEED),
              SyntheticVG(DET_VAL_IMAGES, "test", seed=SEED))
    n_val_batches = -(-DET_VAL_IMAGES // 6)
    at, evaluated = {}, {}
    real_map, real_coco = train_detector.detection_map, train_detector.coco_map

    def detection_map(*args, **kw):   # the launches of the training steps alone
        at["train"] = count_launches()
        m = real_map(*args, **kw)
        at["val"] = count_launches()
        return m

    def coco_map(gt, results, *args, **kw):
        evaluated.update(gt=gt, results=results)
        return real_coco(gt, results, *args, **kw)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        argv = DET_TRAIN_ARGS + ["-nepoch", "1", "-p", "4", "-save_dir", tmp]
        # the weights main draws, the class biases spread (random class
        # scores sit near 1/151, below the 0.05 detection threshold, and
        # would leave the validation no detection), as -ckpt
        with contextlib.redirect_stdout(io.StringIO()):
            cfg = C.ModelConfig.from_args(argv)
        gen = torch.Generator(device=dev).manual_seed(train_detector.SEED)
        init = train_detector.build_detector(cfg, splits[0].num_classes, dev, gen)
        spread_class_biases_(init, gen)
        torch.save(init.state_dict(), os.path.join(tmp, "init.pt"))
        del init
        argv += ["-ckpt", os.path.join(tmp, "init.pt")]
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        train_detector.detection_map, train_detector.coco_map = detection_map, coco_map
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                res = train_detector.main(argv, datasets=splits, device=dev)
        finally:
            train_detector.detection_map, train_detector.coco_map = real_map, real_coco
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        restored = check_detector_checkpoint(os.path.join(tmp, "vgdet-0.pt"), argv,
                                             splits, res.model, dev)
    hist = res.history
    require(len(hist) == n_steps, f"detector train: {len(hist)} steps")
    require(all(math.isfinite(h[k]) for h in hist for k in h),
            "detector train: a loss is not finite")
    skipped = int(sum(h["skipped"] for h in hist))
    require(skipped == 0, f"detector train: {skipped} skipped steps")
    train_l = at["train"]
    val_l = {k: at["val"][k] - train_l[k] for k in train_l}
    require(tuple(train_l.values()) == tuple(n_steps * n for n in DET_STEP_LAUNCHES),
            f"detector train: training launches {train_l}, expected {DET_STEP_LAUNCHES} a step")
    require(tuple(val_l.values()) == tuple(n_val_batches * n for n in DET_VAL_BATCH_LAUNCHES),
            f"detector train: validation launches {val_l}, expected "
            f"{DET_VAL_BATCH_LAUNCHES} a batch")
    m = res.maps[0]
    require(len(res.maps) == 1 and math.isfinite(m) and 0.0 <= m <= 1.0,
            f"detector train: mAP {res.maps}")
    gt, results = evaluated["gt"], evaluated["results"]
    require(len(gt["images"]) == DET_VAL_IMAGES, "detector train: val GT images")
    per_image: dict = {}
    for r in results:
        per_image.setdefault(r["image_id"], []).append(
            (r["category_id"], tuple(r["bbox"]), r["score"]))
    require(set(per_image) <= set(range(DET_VAL_IMAGES)) and all(
        len(v) == len(set(v)) for v in per_image.values()),
        "detector train: an image evaluated twice or out of the split")
    timed = [h["step_s"] for h in hist[TRAIN_WARMUP:]]
    med, win = statistics.median(timed), window_s(hist)
    for ln in buf.getvalue().splitlines():
        if ln.startswith(("e0b", "[train_detector]", "[Loader]")):
            print(f"  {ln}", flush=True)
    first, last = hist[0], hist[-1]
    print(f"detector train: {TRAIN_TIMED} steps of 6 images 592x592 after {TRAIN_WARMUP} "
          f"warm-up on {smi}: {win:.4f} s/step over the window, {6 / win:.3f} img/s; "
          f"the step call alone {med:.4f} s median (mean {statistics.mean(timed):.4f}, "
          f"min {min(timed):.4f}, max {max(timed):.4f}), {6 / med:.3f} img/s; peak memory "
          f"{peak:.2f} GiB; loss {first['total']:.4f} -> {last['total']:.4f} (class "
          f"{first['class_loss']:.4f} -> {last['class_loss']:.4f}, box {last['box_loss']:.4f}, "
          f"rpn class {last['rpn_class_loss']:.4f}, rpn box {last['rpn_box_loss']:.4f}); "
          f"skipped {skipped}; training launches {train_l}; validation launches {val_l} "
          f"over {n_val_batches} batches; mAP@0.5 {m:.6f} over {DET_VAL_IMAGES} val images "
          f"({len(results)} detections); checkpoint restored bit for bit ({restored} "
          f"tensors); {time.time() - t0:.1f} s", flush=True)
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(DET_TRAIN_ARGS)
    batch = Loader(splits[0], 6, shuffle=False, budgets=cfg.budgets, **loader_im_kw(cfg)).peek()
    kw = to_device(train_detector.batch_kwargs(batch), dev)
    split = detector_step_split(res.model, kw, cfg.lr * 6, dev)
    print(f"detector train-split: one step of 6 images, synced at each part, on {smi}: "
          f"{split} ms, sum {sum(split.values()):.3f} ms", flush=True)
    step = make_train_step(res.model, make_optimizer(res.model, cfg.lr * 6),
                           detector_losses)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dev_t = device_ms(lambda: step(kw, gen), ("roi_align_smem", "roi_align_bwd_smem",
                                              "roi_align_bwd_kernel", "cast_bf16",
                                              "nms_mask", "nms_scan", "perclass_nms"), reps=2)
    print("detector step device time: " + (
        "not measured" if dev_t is None else
        f"{dev_t['all']:.3f} ms of kernels a step, of which K1 {dev_t['roi_align_smem']:.3f}, "
        f"K1 backward {dev_t['roi_align_bwd_smem']:.4f} (the shared-memory kernel; the "
        f"scatter kernel {dev_t['roi_align_bwd_kernel']:.4f}, cast "
        f"{dev_t['cast_bf16']:.4f}), K3 {dev_t['nms_mask'] + dev_t['nms_scan']:.3f} ms"),
        flush=True)
    require(dev_t is not None, "detector step: the profiler recorded no device time, so "
            "the kernels K1's backward ran cannot be checked")
    require(dev_t["roi_align_bwd_smem"] > 0 and dev_t["roi_align_bwd_kernel"] == 0
            and dev_t["cast_bf16"] == 0,
            "detector step: K1's backward must run the shared-memory kernel, with no "
            "scatter or cast launch for the bf16 map")
    # K1's backward alone on this step's own RoI sample, beside phase 3's
    # drawn sample (the kernels line's figures)
    out = step(kw, gen)[1]
    rois, valid = out.od_rois.detach(), out.od_valid
    g16 = torch.randn(rois.shape[:2] + (7, 7, 512), generator=gen, device=dev).bfloat16()
    shape = tuple(out.fmap.shape)

    def bwd():
        return ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16, 1 / 16)

    t_own = time_ms(bwd)
    own_dev = device_ms(bwd, ("roi_align_bwd_smem",))
    print(f"K1 roi_align_bwd on one step's own RoI sample ({int(valid.sum())} valid of "
          f"{valid.numel()}): {t_own:.4f} ms a synced call, device "
          + ("not measured" if own_dev is None else
             f"{own_dev['roi_align_bwd_smem']:.4f} ms (every kernel of the call "
             f"{own_dev['all']:.4f})"), flush=True)
    del res, step, out
    torch.cuda.empty_cache()
    return {"detector train": train_l, "detector validation": val_l}


def check_detector_checkpoint(path: str, argv: list, splits, model, dev) -> int:
    """The -save_dir checkpoint restored into a fresh detector, optimizer,
    schedule, generator and loader: the weights equal the trained model's,
    and every restored state equals the saved one, bit for bit. Returns the
    number of tensors compared."""
    payload = checkpoint.load_checkpoint(path)
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(argv)
        fresh = train_detector.build_detector(cfg, splits[0].num_classes, dev,
                                              torch.Generator(device=dev).manual_seed(1))
        opt = make_optimizer(fresh, cfg.lr * 6)
        sched = train_detector.PlateauScheduler()
        gen = torch.Generator(device=dev).manual_seed(1)
        loader = Loader(splits[0], 6, shuffle=True, budgets=cfg.budgets, **loader_im_kw(cfg))
        epoch = checkpoint.restore_train_state(payload, fresh, opt, sched, gen, loader)
    require(epoch == 1, f"checkpoint: resumes at epoch {epoch}")
    n = 0
    for k, v in model.state_dict().items():
        require(torch.equal(fresh.state_dict()[k], v), f"checkpoint: {k} differs")
        n += 1
    for i, st in payload["optimizer"]["state"].items():
        require(torch.equal(opt.state_dict()["state"][i]["momentum_buffer"].cpu(),
                            st["momentum_buffer"]), f"checkpoint: momentum {i} differs")
        n += 1
    require(torch.equal(gen.get_state(), payload["generator"])
            and sched.state_dict() == payload["scheduler"]
            and torch.equal(torch.cuda.get_rng_state() if torch.device(dev).type == "cuda"
                            else torch.get_rng_state(), payload["rng"])
            and np.array_equal(loader.rng.get_state()[1], payload["loader_rng"][1].numpy()),
            "checkpoint: a generator or the schedule differs")
    return n


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
    reports and of its -ckpt restore, images/s from its timing line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = eval_rels.main(argv, datasets=datasets, device=device)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(("[", "R@", "optimistic_restore:"))]
    rate = re.search(r"\[eval_rels\] \d+ images in [\d.]+ s, ([\d.]+) img/s",
                     buf.getvalue())
    require(rate, "eval_rels printed no timing line")
    return ev, lines, float(rate.group(1))


def spread_class_biases_(detector, gen: torch.Generator) -> None:
    """Draw the detector's class biases from N(0, 3^2): random class scores
    sit near 1/151, below the 0.01 detection threshold, and would leave
    sgdet no object to relate; spread priors let boxes clear it, as a
    trained detector's do, and keep the scores of the kept boxes apart."""
    with torch.no_grad():
        detector.score_fc.bias.normal_(0.0, 3.0, generator=gen)


def triplet_scores(entry: dict) -> np.ndarray:
    """The decode's ranking key of an evaluator entry's relation rows: the
    two objects' scores times the best non-background predicate score."""
    s, o = entry["pred_rel_inds"].T
    return entry["obj_scores"][s] * entry["obj_scores"][o] * entry["rel_scores"][:, 1:].max(1)


def match_ranking(got: dict, exp: dict, what: str) -> tuple:
    """The card's relation rows against the CPU's where their triplet
    scores are separated: the same pairs, and at each rank where the two
    orders differ, the card's pair has the CPU's score of that rank within
    rtol 1e-4 (a near tie that summation order may flip). Returns the
    permutation of the card's rows onto the CPU's, the number of rows
    placed differently and the largest relative gap among them."""
    exp_pos = {p: k for k, p in enumerate(map(tuple, exp["pred_rel_inds"].tolist()))}
    perm = np.array([exp_pos.get(p, -1) for p in map(tuple, got["pred_rel_inds"].tolist())],
                    dtype=np.int64)
    require(len(perm) == len(exp_pos) and (perm >= 0).all()
            and len(set(perm.tolist())) == len(perm), f"{what}: the relation pairs differ")
    t = triplet_scores(exp)
    moved = perm != np.arange(len(perm))
    gap = np.abs(t[perm[moved]] - t[moved]) / np.maximum(np.abs(t[moved]), 1e-30)
    worst = float(gap.max()) if moved.any() else 0.0
    require(worst <= 1e-4, f"{what}: {int(moved.sum())} relations ranked differently, "
            f"triplet scores apart by up to {worst:.3e} (relative)")
    return perm, int(moved.sum()), worst


def check_eval_reference(dev, label: str, small_args: list, modes: tuple,
                         reference: dict | None = None) -> None:
    """Phases 6 and 11: eval_rels with a small f32 model on the card
    (kernels) == on the CPU (plain versions), from one state dict through
    -ckpt: predcls and sgcls on 4 StructuredSyntheticVG images of 592^2
    (uint8), pair order identical; sgdet on 4 images of 128^2 with the
    detector's class biases spread (fewer anchors, scores far apart: no
    rounding flips a detection), the pair order identical wherever the
    triplet scores are apart (`match_ranking`). With `reference` (the
    widths of `reference_rel_sd`), phase 17's check: the -ckpt is a
    reference `.tar` of those widths, and sgdet runs with `-proposals` on
    proposals around the GT (`WithProposals`)."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "small.pt" if reference is None else "small.tar")
        for mode in modes:
            im = 128 if mode == "sgdet" else C.IM_SCALE
            splits = StructuredSyntheticVG.splits(num_images=8, val_images=4, num_classes=12,
                                                  seed=SEED, im_size=im)
            argv = ["-m", mode, *small_args]
            if mode == "sgdet":
                argv += ["-im_budget", f"{im}x{im}"]
                if reference is not None:
                    argv += ["-proposals"]
            with contextlib.redirect_stdout(io.StringIO()):
                cfg = C.ModelConfig.from_args(argv)
            model = build_model(cfg, splits[0], "cpu",
                                torch.Generator().manual_seed(SEED))
            if reference is None:
                set_position_stats_(model, splits[0])
                if mode == "sgdet":
                    spread_class_biases_(model.detector, torch.Generator().manual_seed(SEED + 5))
                torch.save(model.state_dict(), ckpt)
            else:
                gen = torch.Generator(device=dev).manual_seed(SEED + 12)
                torch.save({"state_dict": reference_rel_sd(
                    gen, **dict(reference, nc=splits[0].num_classes,
                                npred=splits[0].num_predicates))}, ckpt)
                if mode == "sgdet":
                    splits = tuple(WithProposals(d, gen, im, n=64) for d in splits)
            runs = []   # [CPU, card]
            for i, where in enumerate(("cpu", dev)):
                cache = os.path.join(tmp, f"{mode}_{i}.pkl")
                ev, lines, _ = run_eval(argv + ["-ckpt", ckpt, "-cache", cache],
                                        splits, where)
                require(any(f"copied {len(model.state_dict())}/" in ln for ln in lines)
                        and not any("optimistic_restore: missing" in ln for ln in lines),
                        f"{label}eval-reference {mode}: -ckpt did not restore every tensor")
                with open(cache, "rb") as f:
                    runs.append((ev.result_dict, pickle.load(f)))
            (exp_rd, exp), (got_rd, got) = runs
            require(got_rd == exp_rd, f"{label}eval-reference {mode}: recall lists differ: "
                    f"card {got_rd} vs CPU {exp_rd}")
            require(len(got) == len(exp) == 4, f"{label}eval-reference {mode}: entries")
            n_rels = n_objs = n_moved = 0
            worst = 0.0
            for g, e in zip(got, exp):
                for key in ("pred_classes", "obj_valid"):
                    require(np.array_equal(g[key], e[key]),
                            f"{label}eval-reference {mode}: {key} differ")
                if mode == "sgdet":
                    perm, moved, gap = match_ranking(g, e, f"{label}eval-reference {mode}")
                    n_moved, worst = n_moved + moved, max(worst, gap)
                else:
                    require(np.array_equal(g["pred_rel_inds"], e["pred_rel_inds"]),
                            f"{label}eval-reference {mode}: pred_rel_inds differ")
                    perm = np.arange(len(e["pred_rel_inds"]))
                np.testing.assert_allclose(g["rel_scores"], e["rel_scores"][perm],
                                           rtol=1e-3, atol=1e-4)
                np.testing.assert_allclose(g["obj_scores"], e["obj_scores"],
                                           rtol=1e-3, atol=1e-4)
                ov = e["obj_valid"]
                np.testing.assert_allclose(g["pred_boxes"][ov], e["pred_boxes"][ov],
                                           rtol=1e-4, atol=1e-3)
                n_rels += len(g["pred_rel_inds"])
                n_objs += int(ov.sum())
            require(n_rels > 0 and n_objs > 0, f"{label}eval-reference {mode}: degenerate")
            recall = {k: float(np.mean(v)) for k, v in got_rd[mode + "_recall"].items()}
            ties = (f"; {n_moved} relations ranked apart within near ties (triplet scores "
                    f"within {worst:.2e})" if mode == "sgdet" else "")
            print(f"{label}eval-reference {mode}: card == CPU on 4 images {im}x{im} uint8 "
                  f"({n_objs} objects, {n_rels} relations; R@K {recall}{ties})", flush=True)


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
    class biases spread if `spread`, saved to `path`; returns the
    detector's tensors on the host."""
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(argv)
    gen = torch.Generator(device="cuda").manual_seed(eval_rels.SEED)
    model = build_model(cfg, train, "cuda", gen)
    if spread:
        spread_class_biases_(model.detector, gen)
    torch.save(model.state_dict(), path)
    return {k: v.cpu() for k, v in model.detector.state_dict().items()}


def count_launches() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def zero_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


# The synced split of a training step (phases 9 and 14): the part names and
# the module hooks that mark the boundaries between the first four parts
# (the detector's start and end, then two per model); the loss, the
# optimizer step and the step's end mark the rest.
SPLITS = {
    "motifnet": (("detector", "sample+obj tower", "context", "rel heads",
                  "loss+backward+clip", "optimizer", "skip decision"),
                 lambda m: [(m.detector, "pre"), (m.detector, "post"),
                            (m.context, "pre"), (m.context, "post")]),
    "stanford": (("detector", "sample+union features", "obj tower", "message passing",
                  "loss+backward+clip", "optimizer", "skip decision"),
                 lambda m: [(m.detector, "pre"), (m.detector, "post"),
                            (m.roi_fmap, "post"), (m.roi_fmap_obj, "post")]),
}


def train_step_split(model, kw: dict, lr: float, plan: str, reps: int = 3) -> dict:
    """A synced split of one training step, ms per part (median of `reps`
    steps), at the boundaries of SPLITS[plan]: MotifNet's frozen detector;
    pair sample, object RoIAlign and tower; context; relation heads (union
    features, towers, logits); Stanford's detector; pair sample and union
    features; object RoIAlign and tower; message passing; then both: the
    losses, backward pass and clip; the optimizer step; the host read of
    the non-finite flag. Each boundary synchronizes the card, so the parts
    add up to more than an unsynced step."""
    names, stages = SPLITS[plan]
    marks: list = []

    def mark(*_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def loss_fn(out):
        mark()
        return rel_losses(out)

    opt = make_optimizer(model, lr)
    hooks = [mod.register_forward_pre_hook(mark) if when == "pre"
             else mod.register_forward_hook(mark) for mod, when in stages(model)]
    hooks += [opt.register_step_pre_hook(mark), opt.register_step_post_hook(mark)]
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
    return {name: round(statistics.median(v), 3) for name, v in zip(names, zip(*parts))}


def check_train(smi: str, label: str, train_args: list, plan: str) -> dict:
    """Phases 9 and 14: a published training config in sgcls and sgdet
    through train_rels.main, one epoch of TRAIN_WARMUP + TRAIN_TIMED
    steps, then its validation. Returns the training steps' launches by
    path."""
    splits = StructuredSyntheticVG.splits(
        num_images=(TRAIN_WARMUP + TRAIN_TIMED) * 6, val_images=TRAIN_VAL_IMAGES,
        num_classes=C.VG_NUM_CLASSES, num_predicates=C.VG_NUM_PREDICATES, seed=SEED)
    paths = {}
    for mode in ("sgcls", "sgdet"):
        t0 = time.time()
        argv = ["-m", mode, *train_args, "-nepoch", "1", "-p", "4"]
        at_val = {}
        real_val_epoch = train_rels.val_epoch

        def val_epoch(*args, **kw):   # the launches of the training steps alone
            at_val.setdefault("launches", count_launches())
            return real_val_epoch(*args, **kw)

        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "init.pt")
            det_init = init_ckpt(ckpt, argv, splits[0], spread=mode == "sgdet")
            zero_launches()
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
        name = f"{label}train {mode}"
        require(len(hist) == TRAIN_WARMUP + TRAIN_TIMED, f"{name}: {len(hist)} steps")
        require(all(math.isfinite(h["total"]) for h in hist), f"{name}: a loss is not finite")
        skipped = int(sum(h["skipped"] for h in hist))
        require(skipped == 0, f"{name}: {skipped} skipped steps")
        for key, v in res.model.detector.state_dict().items():
            require(torch.equal(v.cpu(), det_init[key]), f"{name}: detector changed at {key}")
        launches = paths[name] = at_val["launches"]
        require(tuple(launches.values()) == TRAIN_LAUNCHES[mode],
                f"{name}: launches {launches}, expected {TRAIN_LAUNCHES[mode]}")
        r = check_recalls(res.evaluator, mode, TRAIN_VAL_IMAGES)
        timed = [h["step_s"] for h in hist[TRAIN_WARMUP:]]
        med, win = statistics.median(timed), window_s(hist)
        for ln in buf.getvalue().splitlines():
            if ln.startswith(("e0b", "[train_rels]", "[Loader]", "[pairs]", "R@")):
                print(f"  {ln}", flush=True)
        print(f"{name}: {TRAIN_TIMED} steps of 6 images 592x592 after "
              f"{TRAIN_WARMUP} warm-up on {smi}: {win:.4f} s/step over the window, "
              f"{6 / win:.3f} img/s; the step call alone {med:.4f} s median "
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
                                 cfg.lr * 6, plan)
        print(f"{label}train-split {mode}: one step of 6 images, synced at each part, on "
              f"{smi}: {split} ms, sum {sum(split.values()):.3f} ms", flush=True)
        del res
        torch.cuda.empty_cache()
    return paths


def kernel_device_times(fn, reps: int = 2) -> str:
    """The device time of `fn`'s kernels (torch.profiler), K1-K3 apart."""
    dev_t = device_ms(fn, ("roi_align", "perclass_nms", "nms_mask", "nms_scan"), reps=reps)
    if dev_t is None:
        return "not measured"
    return (f"{dev_t['all']:.3f} ms of kernels, of which K1 {dev_t['roi_align']:.3f}, "
            f"K2 {dev_t['perclass_nms']:.3f}, K3 {dev_t['nms_mask'] + dev_t['nms_scan']:.3f} ms")


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
    dev_t = kernel_device_times(lambda: model(**kw))
    del model
    return (f"synced forward {statistics.median(times):.3f} ms (median of 3), "
            f"device {dev_t}")


def check_eval(smi: str, label: str, base_args: list, expected: dict) -> dict:
    """Phases 7 and 12: a published eval config in all three modes. Per
    mode, a warm-up run on the SyntheticVG fallback (8 val images; the
    first batch at new shapes pays cuDNN/cuBLAS plans and allocator
    growth), then the run that is timed and counted, on EVAL_VAL_IMAGES val
    images. Returns its launches by path."""
    timed = SyntheticVG.splits(num_images=4 * EVAL_VAL_IMAGES)
    n_val = len(timed[1])
    paths = {}
    for mode in ("predcls", "sgcls", "sgdet"):
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["-m", mode, *base_args]
            if mode == "sgdet":
                ckpt = os.path.join(tmp, "sgdet.pt")
                init_ckpt(ckpt, argv, timed[0], spread=True)
                argv += ["-ckpt", ckpt]
            ev, _, _ = run_eval(argv, None, "cuda")
            check_recalls(ev, mode, 8)   # the fallback's val split
            zero_launches()
            ev, lines, rate = run_eval(argv, timed, "cuda")
            torch.cuda.synchronize()
            launches = paths[f"{label}eval {mode}"] = count_launches()
            profile = eval_batch_profile(argv, timed)
        r = check_recalls(ev, mode, n_val)
        require(tuple(launches.values()) == expected[mode],
                f"{label}eval {mode}: launches {launches}, expected {expected[mode]}")
        for ln in lines:
            if not ln.startswith("optimistic_restore"):
                print(f"  {ln}", flush=True)
        print(f"{label}eval {mode}: {n_val} images after a warm-up, {rate:.3f} img/s, "
              f"R@20/50/100 {r[20]} / {r[50]} / {r[100]}; on {smi}: "
              f"launches {launches}", flush=True)
        print(f"{label}eval-batch {mode}: one batch of 4 on {smi}: {profile}", flush=True)
        torch.cuda.empty_cache()
    return paths


def stanford_model(dev, gen) -> RelModelStanford:
    """The Stanford model in SGDet at its published widths (GRU 512, union
    and object towers 4096), random weights from `gen`, the detector
    threshold 0 as in the bench config: towers and convs in bf16, the
    message passing in f32."""
    with torch.device(dev):
        model = RelModelStanford(num_classes=C.VG_NUM_CLASSES,
                                 num_rels=C.VG_NUM_PREDICATES, mode="sgdet", obj_dim=4096,
                                 pooling_dim=4096, size=512, thresh=0.0,
                                 dtype=torch.bfloat16, budgets=C.PadBudgets(),
                                 union_chunk=512)
    random_init_(model, gen)
    return model.eval()


def check_requests(label: str, model, dev, gen, smi: str, per_request: tuple) -> dict:
    """Phases 5 and 10: the model answers REQUESTS requests of BATCH
    592^2 images drawn from `gen`, after a warm-up; every kernel launches
    exactly `per_request` times a request. Then the device time of one
    request. Returns the requests' launches."""
    budgets = C.PadBudgets()
    im = C.IM_SCALE
    requests = [torch.randn(BATCH, im, im, 3, generator=gen, device=dev) * 0.3
                for _ in range(REQUESTS)]
    im_hw = torch.full((BATCH, 2), float(im), device=dev)
    pred = model(requests[0], im_hw)                 # warm-up (cuDNN, caches)
    torch.cuda.synchronize()

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for images in requests:
        t0 = time.perf_counter()
        pred = model(images, im_hw)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        check_prediction(pred, BATCH, budgets.objs_per_img, budgets.max_pairs_eval,
                         C.VG_NUM_CLASSES, C.VG_NUM_PREDICATES)
    launches = count_launches()
    require(tuple(launches.values()) == tuple(REQUESTS * n for n in per_request),
            f"{label}requests: launches {launches}, expected {per_request} a request")
    med = statistics.median(lat)
    print(f"{label}requests: {REQUESTS} x {BATCH} images {im}x{im} on {smi}: latency "
          f"{[round(t * 1e3, 3) for t in lat]} ms, median {med * 1e3:.3f} ms, "
          f"{BATCH / med:.3f} img/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; objects "
          f"{int(pred.obj_valid.sum())}, relations {int(pred.rel_valid.sum())}; "
          f"launches {launches}", flush=True)
    # the device time of one request, which the host's speed does not move
    # (after the counted requests: these launches are not counted)
    print(f"{label}request device time: "
          + kernel_device_times(lambda: model(requests[0], im_hw)) + " a request",
          flush=True)
    return launches


def check_freq(smi: str) -> dict:
    """Phase 15: the frequency baseline's entry point (eval_rel_count.main)
    on the card over 32 SyntheticVG val images, in a scratch working
    directory (it writes pred_stats.npy): predcls alone (host only), then
    with a -ckpt of a seeded random detector at the published width (its
    class biases spread) predcls, sgcls and sgdet. Each val image with
    relations is evaluated once; the detectors' launches are exactly
    FREQ_LAUNCHES. Returns them by path."""
    timed = SyntheticVG.splits(num_images=4 * EVAL_VAL_IMAGES)
    n_val = sum(len(r) > 0 for r in timed[1].relationships)
    argv = "-b 4".split()
    paths, at = {}, {}
    real_det_fn = eval_rel_count.make_detector_det_fn

    def det_fn(*args, **kw):   # the launches of the sgcls classifier alone
        at["sgcls"] = count_launches()
        return real_det_fn(*args, **kw)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                evs = eval_rel_count.main(argv, datasets=timed, device="cuda")
            require(set(evs) == {"predcls"}, "eval_rel_count without -ckpt: not predcls only")
            r = check_recalls(evs["predcls"], "predcls", n_val)
            print(f"freq predcls: {n_val} val images with relations, host only, "
                  f"{time.time() - t0:.1f} s; R@20/50/100 {r[20]} / {r[50]} / {r[100]}",
                  flush=True)
            with torch.device("cuda"):
                det = ObjectDetector(num_classes=C.VG_NUM_CLASSES, mode="refinerels",
                                     dtype=torch.bfloat16)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
            spread_class_biases_(random_init_(det, gen), gen)
            torch.save(det.state_dict(), "det.pt")
            del det
            zero_launches()
            eval_rel_count.make_detector_det_fn = det_fn
            t0 = time.time()
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    evs = eval_rel_count.main(argv + ["-ckpt", "det.pt"], datasets=timed,
                                              device="cuda")
            finally:
                eval_rel_count.make_detector_det_fn = real_det_fn
            torch.cuda.synchronize()
            total = count_launches()
        finally:
            os.chdir(cwd)
    require(set(evs) == {"predcls", "sgcls", "sgdet"}, f"eval_rel_count: modes {set(evs)}")
    require("copied 38/38 tensors" in buf.getvalue(), "eval_rel_count: -ckpt not restored")
    paths["freq sgcls"] = at["sgcls"]
    paths["freq sgdet"] = {k: total[k] - at["sgcls"][k] for k in total}
    for mode in ("sgcls", "sgdet"):
        launches = paths[f"freq {mode}"]
        require(tuple(launches.values()) == FREQ_LAUNCHES[mode],
                f"freq {mode}: launches {launches}, expected {FREQ_LAUNCHES[mode]}")
        r = check_recalls(evs[mode], mode, n_val)
        print(f"freq {mode}: {n_val} val images with relations on {smi}; R@20/50/100 "
              f"{r[20]} / {r[50]} / {r[100]}; launches {launches}", flush=True)
    print(f"freq: predcls + sgcls + sgdet with -ckpt in {time.time() - t0:.1f} s",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 17: published weights and proposals
# ---------------------------------------------------------------------------

_VGG_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_SHAPES = ((64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256), (256, 256),
               (512, 256), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512))


def reference_rel_sd(gen, *, nc: int, npred: int, obj_dim: int, pool_dim: int,
                     embed_dim: int = 0, hidden: int = 0, nl_obj: int = 0, nl_edge: int = 0,
                     gru: int = 0) -> dict:
    """A relation checkpoint's state dict in the reference's names and
    layouts (vgrel-*.tar), drawn from `gen` on the card and returned on the
    host: the detector (VGG16, RPN, fc tower, class scores with spread
    biases, so sgdet boxes clear its threshold), the union and object VGG
    towers, the union-mask convs and their BNs; then MotifNet's context
    (`hidden`: the position embed, the highway LSTMs' flat vectors, the
    decoder; no object features into the decoder or the edge context, as
    scripts/eval_models.sh runs) and heads, or with `gru` the Stanford
    message passing. Weights N(0, s^2 / fan_in) and biases N(0, 0.05^2) as
    tests/test_e2e_parity.py's fabricate_full_sd draws them, but for three
    gains that its small widths tolerate and the published ones do not: the
    VGG convs at 1.4, not 1.6 (activations stay level over the 13 layers),
    the class scores at 1, not 6 (saturated probabilities tie), and the
    highway LSTMs' weights per fan-in, not N(0, 0.05^2) (their highway
    path passes the 4424-wide input on unbounded, and the relation loss
    overflowed); the position BN's statistics those of boxes over a 592^2
    image."""
    sd = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device)

    def lin(name, o, i, s=0.3):
        sd[f"{name}.weight"] = randn(o, i) * (s / math.sqrt(i))
        sd[f"{name}.bias"] = randn(o) * 0.05

    def conv(name, o, i, k, s=1.0):
        sd[f"{name}.weight"] = randn(o, i, k, k) * (s / math.sqrt(i * k * k))
        sd[f"{name}.bias"] = randn(o) * 0.05

    def bn(name, d, mean, var):
        sd[f"{name}.weight"] = 1 + 0.1 * randn(d)
        sd[f"{name}.bias"] = 0.1 * randn(d)
        sd[f"{name}.running_mean"] = mean
        sd[f"{name}.running_var"] = var

    def lstm(name, d_in, layers):   # per layer [d_in, 6H] then [H, 5H], flat
        parts = []
        for k in range(layers):
            d = d_in if k == 0 else hidden
            parts += [randn(d * 6 * hidden) / math.sqrt(d),
                      randn(hidden * 5 * hidden) / math.sqrt(hidden)]
        sd[f"{name}.weight"] = torch.cat(parts)
        sd[f"{name}.bias"] = randn(layers * 5 * hidden) * 0.05

    for idx, (o, i) in zip(_VGG_IDX, _VGG_SHAPES):
        conv(f"detector.features.{idx}", o, i, 3, s=1.4)
    lin("detector.roi_fmap.0", obj_dim, 25088, s=1.0)
    lin("detector.roi_fmap.3", obj_dim, obj_dim, s=1.0)
    lin("detector.score_fc", nc, obj_dim, s=1.0)
    sd["detector.score_fc.bias"] = randn(nc) * 3.0
    lin("detector.bbox_fc", nc * 4, obj_dim)
    conv("detector.rpn_head.conv.0", 512, 512, 3)
    conv("detector.rpn_head.conv.2", C.NUM_ANCHORS * 6, 512, 1)
    lin("roi_fmap.1.0", obj_dim, 25088, s=1.0)
    lin("roi_fmap.1.3", pool_dim, obj_dim, s=1.0)
    lin("roi_fmap_obj.0", obj_dim, 25088, s=1.0)
    lin("roi_fmap_obj.3", obj_dim, obj_dim, s=1.0)
    conv("union_boxes.conv.0", 256, 2, 7, s=2.0)
    for m, d in ((2, 256), (6, 512)):
        bn(f"union_boxes.conv.{m}", d, 0.3 * randn(d), 0.5 + 0.5 * randn(d).abs())
    conv("union_boxes.conv.4", 512, 256, 3, s=2.0)
    if hidden:
        sd["context.obj_embed.weight"] = randn(nc, embed_dim)
        sd["context.obj_embed2.weight"] = randn(nc, embed_dim)
        im = float(C.IM_SCALE)
        bn("context.pos_embed.0", 4, torch.tensor([im / 2, im / 2, im / 4, im / 4]),
           torch.tensor([im ** 2 / 12] * 2 + [im ** 2 / 40] * 2))
        lin("context.pos_embed.1", 128, 4, s=1.0)
        lstm("context.obj_ctx_rnn", obj_dim + embed_dim + 128, nl_obj)
        sd["context.decoder_rnn.obj_embed.weight"] = randn(nc + 1, 100)
        lin("context.decoder_rnn.input_linearity", 6 * hidden, hidden + 100, s=1.0)
        lin("context.decoder_rnn.state_linearity", 5 * hidden, hidden, s=1.0)
        lin("context.decoder_rnn.out", nc, hidden, s=3.0)
        lstm("context.edge_ctx_rnn", embed_dim + hidden, nl_edge)
        lin("post_lstm", pool_dim * 2, hidden, s=2.0)
        lin("rel_compress", npred, pool_dim, s=3.0)
        sd["freq_bias.obj_baseline.weight"] = randn(nc * nc, npred)
    if gru:
        lin("obj_unary", gru, obj_dim, s=2.0)
        lin("edge_unary", gru, pool_dim, s=2.0)
        for cell in ("edge_gru", "node_gru"):
            sd[f"{cell}.weight_ih"] = randn(3 * gru, gru) / math.sqrt(gru)
            sd[f"{cell}.weight_hh"] = randn(3 * gru, gru) / math.sqrt(gru)
            sd[f"{cell}.bias_ih"] = randn(3 * gru) * 0.1
            sd[f"{cell}.bias_hh"] = randn(3 * gru) * 0.1
        for name in ("sub_vert_w_fc", "obj_vert_w_fc", "out_edge_w_fc", "in_edge_w_fc"):
            lin(f"{name}.0", 1, 2 * gru, s=3.0)
        lin("obj_fc", nc, gru, s=4.0)
        lin("rel_fc", npred, gru, s=4.0)
    return {k: v.float().cpu() for k, v in sd.items()}


class WithProposals:
    """A synthetic split whose entries also carry precomputed proposals, as
    the VG loader's `use_proposals` entries do (the synthetic datasets stay
    as they are): `n` an image of `im` pixels, rows (score, x1, y1, x2, y2)
    at BOX_SCALE, drawn once on the card from `gen`: two jittered copies of
    each GT box (scores in [0.5, 1)), then RPN-like boxes (a 592^2 image)
    or boxes drawn over the image (scores in [0, 0.5))."""

    def __init__(self, ds, gen, im: int, n: int = PROPOSALS):
        self.ds = ds
        dev = gen.device
        self.props = []
        for g in ds.gt_boxes:
            gt = torch.as_tensor(np.asarray(g) * (im / C.BOX_SCALE), device=dev).float()
            gt = gt.repeat(2, 1)
            wh = (gt[:, 2:] - gt[:, :2]).repeat(1, 2)
            gt = gt + wh * (torch.rand(gt.shape, generator=gen, device=dev) - 0.5) * 0.2
            m = n - len(gt)
            if im == C.IM_SCALE:
                rest = rpn_like_boxes(gen, dev, m, lanes=1)[0]
            else:
                xy = torch.rand(m, 2, generator=gen, device=dev) * 0.8 * im
                rest = torch.cat([xy, xy + (0.05 + 0.45 * torch.rand(
                    m, 2, generator=gen, device=dev)) * im], 1)
            boxes = torch.cat([gt, rest]).clamp(0, im - 1)
            scores = torch.cat([0.5 + 0.5 * torch.rand(len(gt), generator=gen, device=dev),
                                0.5 * torch.rand(m, generator=gen, device=dev)])
            self.props.append(torch.cat([scores[:, None], boxes * (C.BOX_SCALE / C.IM_SCALE)],
                                        1).cpu().numpy())

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def __getitem__(self, index):
        return dict(self.ds[index], proposals=self.props[index].copy())


def check_ref_eval(smi: str, dev, label: str, argv: list, datasets, expected: tuple,
                   n_ref: int) -> dict:
    """One eval_rels run of phase 17 on the card: the reference .tar
    imported with no relation-model key missing, each image evaluated once,
    exactly `expected` launches. Returns them."""
    zero_launches()
    ev, lines, rate = run_eval(argv, datasets, dev)
    torch.cuda.synchronize()
    launches = count_launches()
    missing = [ln for ln in lines if ln.startswith("optimistic_restore: missing")]
    require(not missing, f"{label}: the import left {missing[:3]} ...")
    copied = next(ln for ln in lines if ln.startswith("optimistic_restore: copied"))
    n_unused = sum(ln.startswith("optimistic_restore: unused") for ln in lines)
    mode = argv[argv.index("-m") + 1]
    r = check_recalls(ev, mode, len(datasets[2]))
    require(tuple(launches.values()) == expected,
            f"{label}: launches {launches}, expected {expected}")
    for ln in lines:
        if not ln.startswith("optimistic_restore"):
            print(f"  {ln}", flush=True)
    print(f"{label}: {len(datasets[2])} test images, -ckpt a reference .tar of {n_ref} "
          f"tensors ({copied.split(': ')[1]}, {n_unused} reference keys unused, none "
          f"missing), {rate:.3f} img/s, R@20/50/100 {r[20]} / {r[50]} / {r[100]}; on "
          f"{smi}: launches {launches}", flush=True)
    return launches


def check_published_weights(smi: str, dev) -> dict:
    """Phase 17: a reference vgrel checkpoint at the published MotifNet
    widths (`reference_rel_sd`, saved as a .tar) through eval_rels with
    scripts/eval_models.sh's flags in sgcls and in sgdet -proposals (the
    SyntheticVG test split with RPN-like proposals), one eval batch's
    kernels, then refine_for_detection.sh's training from it in sgdet
    -proposals; then a Stanford reference .tar through eval_rels -model
    stanford in sgdet -proposals. Returns the launches by path."""
    paths = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    timed = SyntheticVG.splits(num_images=4 * REF_EVAL_IMAGES)
    with_props = (timed[0], timed[1], WithProposals(timed[2], gen, C.IM_SCALE))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        tar = os.path.join(tmp, "vgrel-motifnet.tar")
        sd = reference_rel_sd(gen, **PUBLISHED_WIDTHS)
        det_ref = checkpoint.import_reference_detector(
            {k[len("detector."):]: v for k, v in sd.items() if k.startswith("detector.")})
        torch.save({"state_dict": sd, "epoch": 0}, tar)
        n_ref = len(sd)
        del sd
        print(f"published: a reference vgrel .tar at the published MotifNet widths, "
              f"{n_ref} tensors, {os.path.getsize(tar) / 2**30:.2f} GiB, made and saved in "
              f"{time.time() - t0:.1f} s", flush=True)
        for mode, datasets, extra in (("sgcls", timed, []),
                                      ("sgdet", with_props, ["-proposals"])):
            argv = ["-m", mode, *REF_EVAL_ARGS, *extra, "-ckpt", tar]
            paths[f"published {mode}"] = check_ref_eval(
                smi, dev, f"published eval {mode}", argv, datasets, REF_EVAL_LAUNCHES[mode], n_ref)
        print(f"published eval-batch sgdet -proposals: one batch of 4 on {smi}: "
              f"{eval_batch_profile(argv, (timed[0], with_props[2]))}", flush=True)

        # refine_for_detection.sh from the reference checkpoint
        n_steps = REF_TRAIN_WARMUP + REF_TRAIN_TIMED
        train = tuple(WithProposals(d, gen, C.IM_SCALE) for d in StructuredSyntheticVG.splits(
            num_images=n_steps * 6, val_images=6, num_classes=C.VG_NUM_CLASSES,
            num_predicates=C.VG_NUM_PREDICATES, seed=SEED))
        at_val = {}
        real_val_epoch = train_rels.val_epoch

        def val_epoch(*args, **kw):   # the launches of the training steps alone
            at_val.setdefault("launches", count_launches())
            return real_val_epoch(*args, **kw)

        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        train_rels.val_epoch = val_epoch
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                res = train_rels.main(REFINE_ARGS + ["-nepoch", "1", "-p", "2", "-ckpt", tar],
                                      datasets=train, device=dev)
        finally:
            train_rels.val_epoch = real_val_epoch
        torch.cuda.synchronize()
        name = "published train sgdet -proposals"
        require("optimistic_restore: missing" not in buf.getvalue(),
                f"{name}: the import left a key missing")
        hist = res.history
        require(len(hist) == n_steps, f"{name}: {len(hist)} steps")
        require(all(math.isfinite(h["total"]) for h in hist), f"{name}: a loss is not finite")
        skipped = int(sum(h["skipped"] for h in hist))
        require(skipped == 0, f"{name}: {skipped} skipped steps")
        for key, v in res.model.detector.state_dict().items():
            require(torch.equal(v.cpu(), det_ref[key]), f"{name}: detector changed at {key}")
        launches = paths["published train sgdet"] = at_val["launches"]
        expected = tuple(n * n_steps for n in REF_STEP_LAUNCHES)
        require(tuple(launches.values()) == expected,
                f"{name}: launches {launches}, expected {expected}")
        r = check_recalls(res.evaluator, "sgdet", 6)
        timed_s = [h["step_s"] for h in hist[REF_TRAIN_WARMUP:]]
        win = (hist[-1]["end_s"] - hist[REF_TRAIN_WARMUP - 1]["end_s"]) / REF_TRAIN_TIMED
        for ln in buf.getvalue().splitlines():
            if ln.startswith(("e0b", "[train_rels]", "[Loader]", "[pairs]", "R@")):
                print(f"  {ln}", flush=True)
        print(f"{name}: {REF_TRAIN_TIMED} steps of 6 images 592x592 after "
              f"{REF_TRAIN_WARMUP} warm-up on {smi}: {win:.4f} s/step over the window, "
              f"the step call alone {statistics.median(timed_s):.4f} s median; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
              f"{hist[0]['total']:.4f} -> {hist[-1]['total']:.4f} (rel "
              f"{hist[0]['rel_loss']:.4f} -> {hist[-1]['rel_loss']:.4f}); skipped {skipped}; "
              f"training launches {launches}; val R@20/50/100 {r[20]} / {r[50]} / "
              f"{r[100]}; detector as imported", flush=True)
        del res, det_ref
        os.remove(tar)
        torch.cuda.empty_cache()

        tar = os.path.join(tmp, "vgrel-stanford.tar")
        sd = reference_rel_sd(gen, **dict(PUBLISHED_WIDTHS, hidden=0), gru=512)
        torch.save({"state_dict": sd}, tar)
        n_ref = len(sd)
        del sd
        argv = ["-m", "sgdet", *STANFORD_ARGS, "-test", "-proposals", "-ckpt", tar]
        paths["published stanford sgdet"] = check_ref_eval(
            smi, dev, "published stanford eval sgdet", argv, with_props,
            REF_EVAL_LAUNCHES["stanford sgdet"], n_ref)
    torch.cuda.empty_cache()
    return paths


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
    t_start = time.time()

    t0 = time.time()
    so = _cuda.build()
    _cuda.lib()
    print(f"build: {time.time() - t0:.1f} s -> {so.name}", flush=True)
    print(f"sass: {sass_atomics(so)}", flush=True)

    # phase 3 draws from its own generator, so that the main path's weights
    # and images do not depend on what phase 3 measures
    kres = check_kernels(dev, torch.Generator(device=dev).manual_seed(SEED + 3))
    check_reference(dev)
    check_detector_reference(dev)

    # the launches of each path, read just after it (phase 5's are the main
    # path's)
    paths = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = bench_model(dev, gen)
    paths["motifnet request"] = check_requests("", model, dev, gen, smi, REQUEST_LAUNCHES)
    del model
    torch.cuda.empty_cache()

    check_eval_reference(dev, "", SMALL_ARGS, ("predcls", "sgcls"))
    paths.update(check_eval(smi, "", PUBLISHED_ARGS, EVAL_LAUNCHES))
    check_train_reference(dev, "", small_motifnet)
    paths.update(check_train(smi, "", TRAIN_ARGS, "motifnet"))

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    model = stanford_model(dev, gen)
    paths["stanford request"] = check_requests("stanford ", model, dev, gen, smi,
                                               STANFORD_REQUEST_LAUNCHES)
    del model
    torch.cuda.empty_cache()
    check_eval_reference(dev, "stanford ", STANFORD_SMALL_ARGS, ("predcls", "sgcls", "sgdet"))
    paths.update(check_eval(smi, "stanford ", STANFORD_ARGS, STANFORD_EVAL_LAUNCHES))
    check_train_reference(dev, "stanford ", small_stanford)
    paths.update(check_train(smi, "stanford ", STANFORD_TRAIN_ARGS, "stanford"))
    paths.update(check_freq(smi))
    # detector pretraining, the main path of K1's backward
    paths.update(check_detector_train(smi, dev))
    # published weights and proposals: K3 over the precomputed proposals
    check_eval_reference(dev, "reference-ckpt ", SMALL_ARGS, ("sgdet",),
                         reference=SMALL_WIDTHS)
    paths.update(check_published_weights(smi, dev))
    kres["greedy_nms"]["proposals"]["launches"] = paths["published sgdet"]["greedy_nms"]
    print(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s", flush=True)

    for name, k in KERNELS.items():
        require(paths[k["main_path"]][name] > 0, f"{name} never launched on {k['main_path']}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             main_path=k["main_path"], launches=paths[k["main_path"]][name],
             launches_per_request=paths["motifnet request"][name] / REQUESTS,
             launches_by_path={path: n[name] for path, n in paths.items()},
             **kres[name])
        for name, k in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
