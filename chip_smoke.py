"""Smoke run of the PyTorch + CUDA port (neural_motifs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failure in any phase raises, and the
script exits non-zero without a result line):

  1. device   - the card's name and power limit (nvidia-smi), torch/CUDA
                versions; refuses to run without a CUDA device.
  2. build    - nvcc builds the kernels from neural_motifs_tpu_torch/csrc
                (one process a source, all at once); cuobjdump shows what
                sm_90a makes of a shared-memory f32 and u64 atomicAdd and the
                atomics of K1's backward's shared-memory kernel. The host
                runtime is built from neural_motifs_tpu_torch/csrc/host with
                the host compiler (its JPEG library where libjpeg is
                found), the compiler and the libjpeg probe's header and
                library printed; its resize is held to a recorded digest of
                PIL's output (and to PIL where installed) and to its plain
                version.
  3. kernels  - K1 RoIAlign and its backward, K2 per-class NMS, K3 greedy
                NMS, K4 the highway-LSTM layer against their plain PyTorch
                versions on the card at the main paths' shapes (K4 at the
                benchmark cells' B 16, T 64, H 512 on the object stack's
                4424 inputs and 2 layers and the edge stack's 4808 and 4,
                every row 64 long, then lengths 0 / 1 / 64 / random with
                dropout masks; within 1e-4 of the eager loop, zeros at
                padded positions; K1 in f32 and bf16 at R = 1000, 64, 512;
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
                on -proposals' [4, 2000] RPN-like boxes at 0.7; K1 at the
                -resnet paths' shapes in f32 and bf16: the detector's
                256-channel map with 1000 and with 256 RoIs an image, the
                1024-channel trunk map with 64 objects and a 512-pair union
                chunk, each timed in both types; K1's backward at -resnet
                detector training's [6, 37, 37, 256] map on both paths,
                timed, the faster one recorded, not required; K1 in f32
                and bf16 at predict's bucket maps [4, 28, 37, 512] and
                [4, 37, 28, 512], R = 1000, 64, 512 each, timed in bf16),
                with the
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
                have launched during them, 4 / 1 / 1 / 6 times a request
                (K1 / K2 / K3 / K4; 0 of K1's backward); then
                the device time of one request (torch.profiler), its busy
                share of the median latency, and a synced split of one
                request by module (trunk, rest of the detector, object
                tower, context, union boxes, union tower, the rest).
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
 18. data-parallel - (a) phase 16's detector-pretraining config for 3
                steps in a process group of one rank in this process
                (torchrun's environment, NCCL; the loader's slice, the
                weights replicated from rank 0, the gradients all-reduced,
                the loss denominators global) against the same steps
                without a group, each step from the same state: the losses
                bit for bit, the gradients and parameters within 10 times
                the difference between two runs without a group (the
                backward sums in a run-dependent order); launches K1 / K1
                backward / K3 once a step; the gradient all-reduce's time
                (flatten, NCCL, copy back) and the step's kernels. (b) two gloo ranks,
                processes sharing the card, against this process alone at
                the global batch of 4 images whose GT counts differ between
                the ranks: a small f32 sgdet MotifNet step and a small f32
                detector step, dropout on and the samplers drawn; losses,
                gradients, parameters and BN statistics within the CPU
                tests' tolerances, the replicas equal; K1, K2, K3 (and K1's
                backward) launched on the card.
 24. tensor parallelism (run after phase 18) - the Megatron split of the
                three fc towers over model ranks
                (tools/dryrun_multichip.py, parallel/mesh.py). (a)
                dryrun_multichip(4)'s step at the tiny shapes, in sgdet and
                in sgcls (whose relation loss reaches the union tower): 4
                spawned gloo ranks sharing the card, data 2 x model 2,
                against one process at the global batch of 2 images:
                losses rtol 1e-5 / atol 1e-6,
                parameters 2e-4 / 2e-5, BatchNorm statistics 1e-4 / 1e-5
                (JAX's tests/test_parallel.py) and gradients within 1e-3 of
                each leaf's max; the replicated tensors equal bit for bit on
                every rank and the model ranks' predictions equal; launches
                K1 3, K3 2 a rank (sgcls: K1 3) in the step and in the
                eval forward. (b) the full shapes (JAX's _full_scale_model
                widths, default budgets, 592^2, one image, the detector's
                class biases spread), data 1 x model 2, in f32 against one
                process with phase 18 (b)'s tolerances, then in bf16 (the
                loss difference printed, not required); each rank's peak
                memory and towers' parameter bytes against one process's,
                the model group's all-reduces a step and their host time;
                launches K1 3 / K2 1 / K3 1 a rank in the step, K1 4 / K2 1
                / K3 1 in the eval forward.
 28. int8 towers (run on the card beside phase 27's CPU
                reference, its own CPU work on 2 threads) - the VGG fc
                towers under NM_QUANT=int8 (ops/quant.py), the env set
                inside the phase alone: (a) int8_matmul on the card == on the CPU bit for
                bit at the bench request's shapes (the union tower's fc0
                [4096, 25088] x [4096, 25088]^T and fc1 [4096, 4096]^2, the
                RoI head's fc0 [4000, 25088], 5 rows through the padding),
                its int32 product == float64's, timed against the bf16
                product beside the int8 bound; (b) phase 4's small MotifNet
                in sgdet and sgcls and phase 13's Stanford model in sgcls,
                card == CPU under int8 (decisions equal, scores within atol
                2e-2, boxes 5e-3 px; the tower inputs' flipped int8 levels
                printed), then the bench SGDet model: 3 int8 requests (4 /
                1 / 1 launches each), its union tower, RoI head and object
                tower and a synced request int8 against bf16, and one sgcls
                eval batch at the bench widths; (c) the tiny sgcls eval
                forward with its towers split over 2 gloo ranks under int8
                == 1 process bit for bit; (d) phase 25 (d)'s audit runs with
                --int8 and its int8 keys are checked.
 19. resnet-reference - phases 4 and 4a for the -resnet models, f32, a
                shallow trunk (layers 1, 1, 2; layer4 towers at 3 blocks):
                a small ResNet MotifNet's sgdet forward (pooling dim 2048),
                card == CPU with phase 4's tolerances; one training step of
                a small ResNet detector, losses within rtol 1e-4, the
                gradients within 1e-2 of each leaf's norm and 5e-3 of all
                together in L2 (a ReLU or SELU input within rounding of 0
                takes another slope on each side), the card's SGD step
                within 1e-5.
 20. resnet request - phase 5 for the ResNet-101 C4 MotifNet at the bench
                widths with pooling and object dims 2048: 3 requests,
                launches 4 / 1 / 1 / 6 a request, latency, peak memory, one
                request's kernels (K1-K4 apart), its busy share and its
                synced split by module.
 21. resnet train and eval - phase 16 for train_detector -resnet (2
                warm-up and 3 timed steps, the validation, the checkpoint
                restored bit for bit, the synced split of a step, the
                step's kernels with K1's backward the shared-memory kernel,
                K1's backward on one step's own 256-channel RoIs); phase 9
                for train_rels -resnet in sgcls
                (1 warm-up and 2 timed steps, launches K1 3 a step, the
                split of a step); phase 7 for eval_rels -resnet in sgcls and
                sgdet (K1 80 / 32, K2 and K3 8 in sgdet), with each run's
                peak memory.

 22. predict-reference - tools/predict.py (the serving entry point) in a
                process of its own at NM_TPU_IM_SCALE=128, with a small f32
                sgdet model (phase 6's widths, class biases spread) from one
                -ckpt over the JPEG fixtures of tests/data/torch_predict
                (-b 2 -im_budget auto): the CPU run (plain versions) and the
                card's (kernels) give the same record for each file, the
                same object ids and labels and relation order, boxes and
                scores within rtol 1e-3 / atol 1e-4. It prints how the
                fixtures were decoded (native libjpeg, or PIL where libjpeg
                is missing).
 23. predict  - tools/predict.py at the published MotifNet widths (-m sgdet
                -b 4 -im_budget auto, a bench-width -ckpt from the seed,
                class biases spread): a warm-up run over the 5 fixtures,
                then 32 images (the fixtures listed repeatedly): images/s
                end to end on the host clock (decode, resize, collate,
                model, JSON), the decode + resize time an image and its
                share of the run, peak memory, launches exactly K1 4, K2 1,
                K3 1, K4 6 a batch; every record checked (one a listed image,
                boxes inside the image, relations between listed objects,
                scores in [0, 1]). The rate over 3 runs with the decode
                and 3 with the images decoded and resized before the run,
                interleaved, with their spread; each run's batch loop split
                on the host's clock (the wait for the loader, the forward
                call, the records, the rest); the device's busy share from
                a profiled run. Then NM_FAST_DECODE=1 on the large
                fixture: the decode's dims equal decoded_dims(), and the
                batch is collated into the bucket it was assigned.
 25. learning proof - the port's repo-root tools
                (neural_motifs_tpu_torch/tools/). (a) each of
                train_synth's six stages (det, sgcls, sgdet, stanford,
                stanford-sgdet, sgcls-plateau) through run_stage at the
                full scale (batch 8, 592^2, 16 classes; the weights handed
                on as main hands them), the step counts cut to 2 + 10 (the
                plateau recipe 16, at least 8 chunks): each part's launches
                exactly its units x SYNTH_UNITS and the stage's their sum,
                finite losses, R@K and mAP in range; s/step over the 10
                synced steps, peak memory and the full stage's projected
                time. (b) train_synth.main --scale tiny --stages det,sgcls
                at its full step counts, against the JAX test's bars
                (tests/test_train_synth.py): train R@20 >= 60 required, the
                heldout mAP@0.5 > 0.3 and R@20 >= 20 printed with their
                verdicts beside the JAX tool's own CPU run (which misses
                the mAP bar; the mAP is required above 0.02). (c)
                overfit_smoke, MotifNet and Stanford sgcls, 40 steps: the
                loss drops. (d)
                precision_audit --int8 at the published widths on random
                weights (--det-steps 0 --train-steps 0 --n-batches 1): the
                flip rates and R@K deltas of sgcls and sgdet printed, bf16
                against f32 and int8 against bf16 (the int8 keys checked).
 26. parity runbook and dress rehearsal - the port's last two tools
                (neural_motifs_tpu_torch/tools/). (a) a reference vgrel
                .tar at phase 6's widths through parity_runbook.main over
                StructuredSyntheticVG splits in predcls, sgcls (592^2) and
                sgdet (128^2, -proposals around the GT as in phase 17), on
                the CPU (plain versions) and on the card (kernels): the
                measured R@K and
                the exit codes equal, the evaluations as phase 17's
                (identical recall lists and pair order, scores within rtol
                1e-3 / atol 1e-4). (b) a reference .tar at the published
                MotifNet widths through the runbook at its canonical flags
                (-b 6, -max_pairs_eval 4096, f32, -test) on the card, the
                three modes over 16 SyntheticVG test images each: no
                relation-model key missing, each image evaluated once,
                launches exactly K1 10 a batch (predcls, sgcls) and K1 10,
                K2 1, K3 1 a batch (sgdet), img/s; on random weights the
                report is written with all_pass false and exit 1. (c)
                dress_rehearsal.stage_train at the published config (batch
                6, hidden 512, pooling 4096, nl_obj 2, nl_edge 4, lr 1e-5,
                clip 5) over SyntheticVG for 200 steps (fewer only where
                the phase would outlast 90 s, the cut printed): finite
                losses, no step skipped, launches exactly K1 3 a step;
                s/step, img/s and peak memory.
 27. trajectories - the eight training loops of the tools
                (neural_motifs_tpu_torch/tools/trajectory.py: train_synth's
                trunk warm-up, rpntrain loop, sgcls / sgdet / Stanford /
                plateau stages; precision_audit's pretrain_detector and
                pretrain) at the Tier-1 tests' tiny widths, 40 steps each,
                f32 with TF32 off and dropout off. After every timed phase,
                a process of its own runs them on the CPU (the reference,
                its samples recorded), then again with the first batch's
                images times (1 + 2^-23 * noise) (the control, the samples
                replayed); beside the control the card runs them with the
                reference's samples replayed. Each loop's distance from the
                CPU run stays inside the Tier-1 tests' band around the
                control (trajectory.Band, held while the control is below
                1e-3); every step's lr and every plateau epoch's scale are
                the CPU's; no replayed RoI box is missed at a loop's first
                step (the misses a step printed); the card's f32
                gradient norm of 10^8 elements within 1e-5 of float64's.

The line before the last is the kernels' JSON record (per kernel: its
launches on its main path (`main_path`: the MotifNet SGDet request; for
K1's backward, detector training) and on every path (the -resnet ones
among them, `predict` too), error, time, plain time, bound and share of it, device time,
yardstick or the reason for none; K3's `proposals` entry, the -proposals
shape, with its launches on phase 17's sgdet eval; K1's and K1's
backward's `resnet` entries, phase 3's -resnet shapes; K1's `predict`
entry, phase 3's shapes of the predict path; the `train_synth ...`,
`overfit ...` and `precision_audit` paths of phase 25; the `runbook ...`
and `dress train` paths of phase 26); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
import io
import json
import math
import multiprocessing
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from neural_motifs_tpu_torch import config as C
from neural_motifs_tpu_torch import runtime
from neural_motifs_tpu_torch.data import transforms
from neural_motifs_tpu_torch.data.batching import Loader, loader_im_kw, to_device
from neural_motifs_tpu_torch.data.synthetic import (StructuredSyntheticVG,
                                                    SyntheticVG)
from neural_motifs_tpu_torch.models import context as context_mod
from neural_motifs_tpu_torch.models import detector as detector_mod
from neural_motifs_tpu_torch.models import rel_model as rel_model_mod
from neural_motifs_tpu_torch.models.backbone import QuantLinear
from neural_motifs_tpu_torch.models.detector import ObjectDetector
from neural_motifs_tpu_torch.models.rel_model import RelModel, disable_dropout_
from neural_motifs_tpu_torch.models.rel_model_stanford import RelModelStanford
from neural_motifs_tpu_torch.ops import _cuda
from neural_motifs_tpu_torch.ops import highway_lstm as hl
from neural_motifs_tpu_torch.ops import nms, quant
from neural_motifs_tpu_torch.ops import roi_align as ra
from neural_motifs_tpu_torch.ops.sampling import AnchorTargets, DetSample
from neural_motifs_tpu_torch.parallel import distributed as D
from neural_motifs_tpu_torch.parallel import mesh
from neural_motifs_tpu_torch.tools import dryrun_multichip as dryrun
from neural_motifs_tpu_torch.tools import (dress_rehearsal, overfit_smoke, parity_runbook,
                                           precision_audit, predict, train_synth)
from neural_motifs_tpu_torch.tools import trajectory
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
# the kernels' launches (K1, K2, K3, K1's backward, K4: KERNELS' order) on
# each path: 4 / 1 / 1 / 0 / 6 a SGDet request; over the 32 val images of
# phase 7 (8 batches); over the 12 training steps of phase 9 (relation
# training never differentiates RoIAlign: the detector is frozen). K4 runs
# once a highway-LSTM layer (nl_obj + nl_edge a forward) wherever autograd
# does not record: the eval forward and calibration's no_grad training
# forward; never in a training step
REQUEST_LAUNCHES = (4, 1, 1, 0, 6)
EVAL_LAUNCHES = {"predcls": (80, 0, 0, 0, 48), "sgcls": (80, 0, 0, 0, 48),
                 "sgdet": (32, 8, 8, 0, 48)}
TRAIN_LAUNCHES = {"sgcls": (36, 0, 0, 0, 0), "sgdet": (36, 12, 12, 0, 0)}
# the Stanford model (phases 10-14): scripts/train_stanford.sh's flags; its
# GRU width 512 and union width 4096 are fixed, obj_dim 4096 is the default
STANFORD_ARGS = "-model stanford -b 4".split()
STANFORD_TRAIN_ARGS = "-model stanford -b 6 -lr 1e-3 -clip 5".split()
STANFORD_SMALL_ARGS = "-model stanford -obj_dim 128 -b 2 -dtype float32 -max_gt_boxes 16".split()
# a Stanford SGDet request: K3 twice, the RPN's proposals and the decode's
# per-class NMS over 4 x 151 lanes of the 64 objects (exact: 256 >= 64)
STANFORD_REQUEST_LAUNCHES = (4, 1, 2, 0, 0)
STANFORD_EVAL_LAUNCHES = {"predcls": (80, 0, 0, 0, 0), "sgcls": (80, 0, 0, 0, 0),
                          "sgdet": (32, 8, 16, 0, 0)}
# the frequency baseline's detectors over the 32 val images (8 batches of
# 4): the gtbox classifier RoIAligns once a batch; the sgdet detector
# RoIAligns its proposals, and runs its RPN NMS and filter_det
FREQ_LAUNCHES = {"sgcls": (8, 0, 0, 0, 0), "sgdet": (8, 8, 8, 0, 0)}
# detector pretraining (phase 16): scripts/pretrain_detector.sh's flags
# with the clip of the JAX entry point's default; each training step
# RoIAligns its sampled RoIs (K1) and differentiates them (K1's backward)
# and runs the RPN's proposal NMS (K3); each validation batch is the
# refinerels path (K1, K2, K3)
DET_TRAIN_ARGS = "-b 6 -lr 1e-3 -clip 5".split()
DET_STEP_LAUNCHES = (1, 0, 1, 1, 0)
DET_VAL_BATCH_LAUNCHES = (1, 1, 1, 0, 0)
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
REF_EVAL_LAUNCHES = {"sgcls": (40, 0, 0, 0, 24), "sgdet": (16, 4, 4, 0, 24),
                     "stanford sgdet": (16, 4, 8, 0, 0)}
REF_TRAIN_WARMUP, REF_TRAIN_TIMED = 2, 3
REF_STEP_LAUNCHES = (3, 1, 1, 0, 0)
# data parallelism (phase 18): (a) phase 16's detector-pretraining config
# for DP_STEPS steps in an NCCL group of one rank (each step K1, K1's
# backward and K3 once); (b) two gloo ranks sharing the card against one
# process at the global batch of DP_IMAGES, GT counts unequal between the
# ranks: a small sgdet MotifNet step (K1 three times, K2 and K3 once) and a
# small detector step (K1, K1's backward, K3 once)
DP_STEPS = 3
# the ResNet-101 C4 path (-resnet, phases 19-21): the published and bench
# flags with pooling and object dims 2048, the ResNet towers' width (the
# published flags gate every pooling dim with the 2048 union features; the
# JAX package's own ResNet test takes 2048 / 2048). Launches as the VGG
# paths': a sgdet eval batch K1 4 (the detector, the objects, 2 union
# chunks), K2 and K3 once; a sgcls one K1 10 (8 union chunks of the 4032
# pairs); a sgcls training step K1 3
RESNET_WIDTHS = "-resnet -obj_dim 2048 -pooling_dim 2048".split()
RESNET_EVAL_ARGS = PUBLISHED_ARGS + RESNET_WIDTHS
RESNET_TRAIN_ARGS = TRAIN_ARGS + RESNET_WIDTHS
RESNET_DET_ARGS = DET_TRAIN_ARGS + ["-resnet"]
RESNET_DET_WARMUP, RESNET_DET_TIMED = 2, 3
RESNET_TRAIN_WARMUP, RESNET_TRAIN_TIMED = 1, 2
RESNET_EVAL_LAUNCHES = {"sgcls": (80, 0, 0, 0, 48), "sgdet": (32, 8, 8, 0, 48)}
RESNET_TRAIN_LAUNCHES = {"sgcls": (9, 0, 0, 0, 0)}
DP_RANKS, DP_IMAGES = 2, 4
DP_SGDET_LAUNCHES = (3, 1, 1, 0, 0)
DP_INIT_TIMEOUT_S, DP_JOIN_TIMEOUT_S = 60, 240
# the JAX package's data-parallel tolerances (tests/test_dp_and_loader.py)
# and the gradients' of tests/test_torch_train_step.py (of each leaf's max)
DP_LOSS_RTOL, DP_PARAM_TOL, DP_BN_TOL, DP_GRAD_TOL = 1e-5, (2e-4, 2e-5), (1e-4, 1e-5), 1e-3
# tensor parallelism (phase 24): (a) dryrun_multichip(TP_TINY_RANKS)'s step
# at _tiny_setup's shapes (data 2 x model 2; its eval pairs fit one union
# chunk; its 16 RoIs an image take the per-class NMS through K3's lanes,
# per_class_topk >= 16), in sgdet and in sgcls, whose relation loss reaches
# the union tower (a random detector's sgdet sample holds no pair); (b) the full shapes at data 1 x model 2 (the eval forward's 1024
# pairs take two union chunks). Launches a rank, by part (K1, K2, K3, K1's
# backward, K4): each model rank runs the whole detector and context
TP_TINY_RANKS = 4
TP_FULL_GRID = (1, 2)
TP_TINY_LAUNCHES = {"sgdet": {"train": (3, 0, 2, 0, 0), "eval": (3, 0, 2, 0, 2)},
                    "sgcls": {"train": (3, 0, 0, 0, 0), "eval": (3, 0, 0, 0, 2)}}
TP_FULL_LAUNCHES = {"train": (3, 1, 1, 0, 0), "eval": (4, 1, 1, 0, 6)}
TP_LOSS_TOL = (1e-5, 1e-6)   # tests/test_parallel.py's, with atol
TP_JOIN_TIMEOUT_S = 300
# the published MotifNet widths of a reference vgrel checkpoint, and phase
# 6's small ones (its card-vs-CPU check, at the dataset's class counts)
PUBLISHED_WIDTHS = dict(nc=C.VG_NUM_CLASSES, npred=C.VG_NUM_PREDICATES, obj_dim=4096,
                        pool_dim=4096, embed_dim=200, hidden=512, nl_obj=2, nl_edge=4)
SMALL_WIDTHS = dict(obj_dim=128, pool_dim=128, embed_dim=16, hidden=24, nl_obj=2, nl_edge=2)

# the serving entry point (phases 22-23): tools/predict.py over the
# committed JPEG fixtures; phase 22 at a 128-px IM_SCALE in a process of its
# own (fewer anchors, scores far apart: no rounding flips a detection), phase
# 23 at the published widths (-b 4 -im_budget auto) over PREDICT_IMAGES
# images, the fixtures listed repeatedly; each batch launches K1 4 times,
# K2 and K3 once, as a request
PREDICT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                           "torch_predict")
PREDICT_FIXTURES = (("landscape.jpg", 600, 800), ("portrait.jpg", 800, 600),
                    ("square.jpg", 700, 700), ("tiny.jpg", 9, 37), ("large.jpg", 960, 1280))
PREDICT_REF_SCALE = 128
PREDICT_IMAGES = 32
PREDICT_ROUNDS = 3   # timed runs with the decode, and as many without it
PREDICT_BATCH_LAUNCHES = (4, 1, 1, 0, 6)
# phase 2: a seeded [600, 800, 3] image resized to [444, 592]; the sha256 of
# PIL's BILINEAR resize of it (PIL 12.1.0), which the host runtime's resize
# must give on a host with or without PIL
RESIZE_DIGEST = "388e5eb6b4d2418a3961e96628a24b7fa29fd37e11c3275910453c47a4c15403"

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
    # the JAX package runs this recurrence as a lax.scan: K4 replaces none
    "highway_lstm": dict(
        wrapper=hl.highway_lstm_cuda, source="neural_motifs_tpu_torch/csrc/highway_lstm.cu",
        replaces=None, main_path="motifnet request"),
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
# substrings of the kernels' names in a profile: K1 (and its backward), K2,
# K3's mask and scan kernels, K4
DEVICE_NAMES = ("roi_align", "perclass_nms", "nms_mask", "nms_scan", "highway_lstm")
# K4 at the benchmark cells' shapes: 16 images of 64 objects, hidden 512;
# the object stack (2 layers on 4424 inputs) and the edge stack (4 on 4808)
LSTM_B, LSTM_T, LSTM_H = 16, 64, 512
LSTM_STACKS = {"obj": (4424, 2), "edge": (4808, 4)}


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


# K1 at the -resnet paths' shapes (phase 3): the detector's 256-channel
# compressed map at eval (1000 proposals an image) and in training (256
# sampled RoIs an image of 6), the relation model's 1024-channel trunk map
# for its 64 objects and for a 512-pair union chunk
RESNET_K1_SHAPES = (("detector eval", 4, 256, 1000), ("detector train", 6, 256, 256),
                    ("objects", 4, 1024, 64), ("union chunk", 4, 1024, 512))


def check_roi_align_resnet(dev, gen) -> dict:
    """K1 at RESNET_K1_SHAPES in f32 and bf16 against its plain version
    (f32 within 1e-4, bf16 within rtol 2e-2), each timed in both types: a
    synced call, a call in a stream of calls, device time, bound and share,
    the plain version and grid_sample."""
    out = {}
    for name, b, c, r in RESNET_K1_SHAPES:
        fmap = torch.randn(b, 37, 37, c, generator=gen, device=dev)
        if name == "detector train":
            rois, valid = det_train_rois(gen, dev, b)
        else:
            rois = rand_boxes(gen, (b, r), 700, dev) - 50.0
            valid = torch.rand(b, r, generator=gen, device=dev) < 0.9
        exp = ra._roi_align_matmul(fmap, rois, valid, 7, 1 / 16)
        err = (ra.roi_align_cuda(fmap, rois, valid, 7, 1 / 16) - exp).abs().max().item()
        require(err <= 1e-4, f"K1 {name} [{b}, 37, 37, {c}] f32 max abs error {err} > 1e-4")
        got16 = ra.roi_align_cuda(fmap.bfloat16(), rois, valid, 7, 1 / 16).float()
        torch.testing.assert_close(got16, exp, rtol=2e-2, atol=2e-2)
        del exp, got16
        res = dict(shape=[b, 37, 37, c], rois=r, max_abs_err=err)
        for dt, elem in ((torch.bfloat16, 2), (torch.float32, 4)):
            f = fmap.to(dt)

            def call():
                return ra.roi_align_cuda(f, rois, valid, 7, 1 / 16)

            t_k = time_ms(call)
            dev_t = device_ms(call, ("roi_align",))
            b_ms, b_by = roi_align_bound(b, 37, 37, c, r, 7, elem)
            res[str(dt).split(".")[1]] = dict(
                ms=t_k, pipelined_ms=pipelined_ms(call), device_ms=dev_t and dev_t["roi_align"],
                plain_ms=time_ms(lambda: ra._roi_align_matmul(f, rois, valid, 7, 1 / 16),
                                 reps=3),
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / t_k,
                device_share_of_bound=dev_t and b_ms / dev_t["roi_align"],
                library_ms=time_ms(yardstick_grid_sample(f, rois, 7, 1 / 16)))
        out[name] = res
        for dt in ("bfloat16", "float32"):
            k = res[dt]
            print(f"K1 roi_align_fwd resnet {name} {dt} [{b}, 37, 37, {c}] R={r}: kernel "
                  f"{k['ms']:.4f} ms a synced call ({k['pipelined_ms']:.4f} in a stream of "
                  f"calls, device {fmt_ms(k['device_ms'])}), plain {k['plain_ms']:.3f} ms, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), share of bound "
                  f"{k['share_of_bound']:.3f} on the call, "
                  f"{fmt_ms(k['device_share_of_bound'])} on device time, grid_sample "
                  f"{k['library_ms']:.4f} ms; f32 max|err| {err:.3e} (tol 1e-4), bf16 "
                  f"within rtol 2e-2", flush=True)
    return out


# K1 at the predict path's shapes (phase 3): -im_budget auto collates a
# 4:3 image into the (448, 592) or (592, 448) bucket, a [4, 28, 37, 512] or
# [4, 37, 28, 512] VGG map; the detector's 1000 proposals, the 64 objects,
# a 512-pair union chunk on each
PREDICT_K1_MAPS = ((28, 37), (37, 28))
PREDICT_K1_ROIS = (1000, 64, 512)


def check_roi_align_predict(dev, gen) -> dict:
    """K1 on the non-square maps of predict's buckets against its plain
    version (f32 within 1e-4, bf16 within rtol 2e-2), RoIs drawn over the
    bucket's image and partly outside it, ~10% invalid; each timed on the
    bf16 call: a synced call, a call in a stream of calls, device time,
    bound and share, the plain version and grid_sample."""
    out = {}
    for h, w in PREDICT_K1_MAPS:
        fmap = torch.randn(BATCH, h, w, 512, generator=gen, device=dev)
        f16 = fmap.bfloat16()
        im_scale = torch.tensor([w, h, w, h], device=dev) * 16 / 700
        for r in PREDICT_K1_ROIS:
            rois = (rand_boxes(gen, (BATCH, r), 700, dev) - 50.0) * im_scale
            valid = torch.rand(BATCH, r, generator=gen, device=dev) < 0.9
            exp = ra._roi_align_matmul(fmap, rois, valid, 7, 1 / 16)
            err = (ra.roi_align_cuda(fmap, rois, valid, 7, 1 / 16) - exp).abs().max().item()
            require(err <= 1e-4, f"K1 predict [{BATCH}, {h}, {w}, 512] R={r} f32 max abs "
                                 f"error {err} > 1e-4")
            got16 = ra.roi_align_cuda(f16, rois, valid, 7, 1 / 16).float()
            torch.testing.assert_close(got16, exp, rtol=2e-2, atol=2e-2)
            del exp, got16

            def call():
                return ra.roi_align_cuda(f16, rois, valid, 7, 1 / 16)

            t_k = time_ms(call)
            dev_t = device_ms(call, ("roi_align",))
            b_ms, b_by = roi_align_bound(BATCH, h, w, 512, r, 7, 2)
            k = out[f"{h}x{w} R={r}"] = dict(
                shape=[BATCH, h, w, 512], rois=r, max_abs_err=err, ms=t_k,
                pipelined_ms=pipelined_ms(call), device_ms=dev_t and dev_t["roi_align"],
                plain_ms=time_ms(lambda: ra._roi_align_matmul(f16, rois, valid, 7, 1 / 16),
                                 reps=3),
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / t_k,
                library_ms=time_ms(yardstick_grid_sample(f16, rois, 7, 1 / 16)))
            print(f"K1 roi_align_fwd predict bf16 [{BATCH}, {h}, {w}, 512] R={r}: kernel "
                  f"{t_k:.4f} ms a synced call ({k['pipelined_ms']:.4f} in a stream of "
                  f"calls, device {fmt_ms(k['device_ms'])}), plain {k['plain_ms']:.3f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), share of bound {b_ms / t_k:.3f}, "
                  f"grid_sample {k['library_ms']:.4f} ms; f32 max|err| {err:.3e} (tol "
                  f"1e-4), bf16 within rtol 2e-2", flush=True)
    return out


def check_roi_align_bwd_resnet(dev, gen) -> dict:
    """K1's backward at -resnet detector training's shape: the 256-channel
    compressed map [6, 37, 37, 256], 256 RoIs an image drawn as a training
    step draws them; both paths (the shared-memory kernel the dispatch takes
    and the scatter path forced) against the plain version with phase 3's
    tolerances, each timed on the bf16 call. Which path is faster is
    recorded, not required: one block an (image, 32-channel slice) gives 48
    blocks here for 132 SMs."""
    b, r, shape = 6, 256, (6, 37, 37, 256)
    fmap = torch.randn(shape, generator=gen, device=dev)
    rois, valid = det_train_rois(gen, dev, b)
    require(ra._bwd_smem_fits(37, 37, 7), "K1 backward: the shared-memory kernel must fit")
    g = torch.randn(b, r, 7, 7, 256, generator=gen, device=dev)
    exp = ra._roi_align_bwd_plain(g, fmap, rois, valid, 1 / 16)
    scale = exp.abs().max().item()
    g16 = g.bfloat16()
    exp16 = ra._roi_align_bwd_plain(g16.float(), fmap, rois, valid, 1 / 16)
    b_ms, b_by = roi_align_bwd_bound(b, 37, 37, 256, r, 7, 2)
    res = dict(shape=[b, r, 37, 37, 256], bound_ms=b_ms, bound_by=b_by)
    for path, names in (("kernel", ("roi_align_bwd_smem",)),
                        ("scatter", ("roi_align_bwd_kernel", "cast_bf16"))):
        scatter = path == "scatter"
        got = ra.roi_align_bwd_cuda(g, rois, valid, shape, torch.float32, 1 / 16,
                                    _scatter=scatter)
        err = (got - exp).abs().max().item()
        require(scale > 0 and err <= 1e-5 * scale,
                f"K1 backward resnet ({path}) f32 max abs error {err} > 1e-5 x {scale}")
        got16 = ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16, 1 / 16,
                                      _scatter=scatter)
        torch.testing.assert_close(got16.float(), exp16, rtol=1e-2,
                                   atol=1e-3 * exp16.abs().max().item())
        res[path] = dict(max_abs_err=err, **bwd_times(
            lambda: ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16, 1 / 16,
                                          _scatter=scatter), names, b_ms))
    f16 = fmap.bfloat16()
    res["plain_ms"] = time_ms(lambda: ra._roi_align_bwd_plain(g16, f16, rois, valid, 1 / 16),
                              reps=3)
    res["library_ms"] = time_ms(yardstick_grid_sample_bwd(f16, rois, 7, 1 / 16))
    kern, scat = res["kernel"], res["scatter"]
    both = kern["call_device_ms"] is not None and scat["call_device_ms"] is not None
    res["faster"] = (("shared memory" if kern["call_device_ms"] < scat["call_device_ms"]
                      else "scatter") if both else "not measured")
    for label, t in (("shared-memory kernel", kern), ("scatter path", scat)):
        print(f"K1 roi_align_bwd resnet bf16 [6, 37, 37, 256] R=256 {label}: f32 max|err| "
              f"{t['max_abs_err']:.3e} ({t['max_abs_err'] / scale:.2e} of the largest, tol "
              f"1e-5), bf16 within rtol 1e-2; {t['ms']:.4f} ms a synced call "
              f"({t['pipelined_ms']:.4f} in a stream of calls; device "
              f"{fmt_ms(t['device_ms'])}, every kernel of the call "
              f"{fmt_ms(t['call_device_ms'])} ms); bound {b_ms:.4f} ms ({b_by}), share "
              f"{t['share_of_bound']:.3f} on the call, "
              f"{fmt_ms(t['device_share_of_bound'])} on device time", flush=True)
    print(f"K1 roi_align_bwd resnet [6, 37, 37, 256]: plain {res['plain_ms']:.3f} ms, "
          f"grid_sample backward {res['library_ms']:.4f} ms; faster on device time: "
          f"{res['faster']}", flush=True)
    return res


def lstm_stack(gen, dev, d_in: int, layers: int, h: int = LSTM_H) -> list:
    """A highway-LSTM stack's params: W ~ U(-1, 1) / sqrt(fan-in), biases
    U(-0.1, 0.1) with the forget gate's +1."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 2 - 1
    params = []
    for layer in range(layers):
        k = d_in if layer == 0 else h
        bias = u(5 * h) * 0.1
        bias[h:2 * h] += 1.0
        params.append({"w_i": u(k, 6 * h) / math.sqrt(k), "w_h": u(h, 5 * h) / math.sqrt(h),
                       "bias": bias})
    return params


def lstm_bound(lengths, layers: int, b: int = LSTM_B, t: int = LSTM_T,
               h: int = LSTM_H) -> tuple:
    """K4's bound over a stack: operations, each row's real steps of the
    recurrent product (2 * H * 5H a row-step); bytes, gi read, W_h and the
    bias read, the output written, a layer each."""
    n_ops = layers * 2 * int(lengths.sum()) * h * 5 * h
    n_bytes = layers * 4 * (b * t * 6 * h + h * 5 * h + 5 * h + b * t * h)
    return bound(n_bytes, n_ops)


def check_highway_lstm(dev, gen) -> dict:
    """K4 against the eager loop at LSTM_STACKS: every row 64 long (sgdet),
    timed; then lengths 0, 1, 64 and random with dropout masks, in both
    directions. The time of a stack's K4 launches alone (on its layers'
    precomputed input products), of the whole stack (the input GEMMs
    included) and of the eager loop."""
    res = {}
    errs = []
    for name, (d_in, layers) in LSTM_STACKS.items():
        params = lstm_stack(gen, dev, d_in, layers)
        x = torch.randn(LSTM_B, LSTM_T, d_in, generator=gen, device=dev)
        mixed = torch.randint(0, LSTM_T + 1, (LSTM_B,), generator=gen, device=dev)
        mixed[:3] = torch.tensor([LSTM_T, 0, 1], device=dev)
        masks = [(torch.rand(LSTM_B, LSTM_H, generator=gen, device=dev) < 0.9).float() / 0.9
                 for _ in range(layers)]
        for lengths, dm in ((torch.full((LSTM_B,), LSTM_T, device=dev), None), (mixed, masks)):
            with torch.inference_mode():
                got = hl.alternating_highway_lstm(params, x, lengths, dm)
                exp = hl._alternating(params, x, lengths, dm, kernel=False)
            pad = torch.arange(LSTM_T, device=dev)[None, :] >= lengths[:, None]
            require(not got[pad].any(), f"K4 {name}: a padded position is not 0")
            errs.append((got - exp).abs().max().item())
        lengths = torch.full((LSTM_B,), LSTM_T, device=dev)
        with torch.inference_mode():
            gis, out = [], x
            for layer, p in enumerate(params):
                gis.append(out @ p["w_i"])
                out = hl.highway_lstm_cuda(gis[-1], p["w_h"], p["bias"], lengths,
                                           reverse=layer % 2 == 1)

            def k4():
                for layer, (p, gi) in enumerate(zip(params, gis)):
                    hl.highway_lstm_cuda(gi, p["w_h"], p["bias"], lengths,
                                         reverse=layer % 2 == 1)

            t_k = time_ms(k4)
            t_s = pipelined_ms(k4)
            t_stack = time_ms(lambda: hl.alternating_highway_lstm(params, x, lengths))
            t_p = time_ms(lambda: hl._alternating(params, x, lengths, None, kernel=False),
                          reps=3)
            dev_t = device_ms(k4, ("highway_lstm",))
        b_ms, b_by = lstm_bound(lengths, layers)
        res[name] = dict(shape=[LSTM_B, LSTM_T, d_in, LSTM_H], layers=layers, ms=t_k,
                         pipelined_ms=t_s, stack_ms=t_stack, plain_ms=t_p,
                         bound_ms=b_ms, bound_by=b_by,
                         device_ms=dev_t and dev_t["highway_lstm"],
                         share_of_bound=b_ms / t_k)
        k = res[name]
        print(f"K4 highway_lstm {name} stack [{LSTM_B}, {LSTM_T}] D {d_in} H {LSTM_H}, "
              f"{layers} layers: its K4 launches {t_k:.4f} ms a synced call ({t_s:.4f} in a "
              f"stream of calls, device "
              f"{k['device_ms'] if k['device_ms'] is not None else 'not measured'}), the "
              f"stack with its input GEMMs {t_stack:.4f} ms, the eager loop {t_p:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), share of bound {b_ms / t_k:.3f}", flush=True)
    err = max(errs)
    require(err <= 1e-4, f"K4 max abs error {err} > 1e-4")
    print(f"K4 highway_lstm: max|err| {err:.3e} against the eager loop (tol 1e-4: f32 FMAs "
          f"in the kernel's fixed order against cuBLAS's f32 GEMM), rows of 64 and of mixed "
          f"lengths with dropout masks, padded positions 0", flush=True)
    return dict(max_abs_err=err, **res["edge"], obj=res["obj"], library_ms=None,
                library_reason="no single PyTorch call computes the highway-LSTM recurrence")


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
    # the -resnet shapes, from their own generator too
    gen_resnet = torch.Generator(device=dev).manual_seed(SEED + 19)
    res["roi_align_fwd"]["resnet"] = check_roi_align_resnet(dev, gen_resnet)
    res["roi_align_bwd"]["resnet"] = check_roi_align_bwd_resnet(dev, gen_resnet)
    # predict's non-square bucket maps, from their own generator
    res["roi_align_fwd"]["predict"] = check_roi_align_predict(
        dev, torch.Generator(device=dev).manual_seed(SEED + 23))

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
    res["highway_lstm"] = check_highway_lstm(dev, gen)
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


# the shallow trunk of phase 19's small ResNet models (layer1..3 blocks;
# layer4, the towers, stays at its 3)
RESNET_SMALL_LAYERS = (1, 1, 2)


def resnet_small_(model) -> None:
    """Phase 19's random ResNet MotifNet set as a trained one sits: the
    RPN's box deltas at O(1) (its 1x1 output conv scaled by 0.1; at random
    init they reach ~12, where exp() turns a 1e-6 relative difference of
    the trunks into 1e-2 px), and the position BN at a 96^2 image's box
    statistics (at (0, 1) the raw pixels drive the relation logits to ~1e4,
    where summation order moves the saturated scores)."""
    with torch.no_grad():
        model.detector.rpn_head.convs[1].weight.mul_(0.1)
        if hasattr(model, "context"):
            model.context.pos_bn.running_mean.copy_(torch.tensor([48.0, 48.0, 30.0, 30.0]))
            model.context.pos_bn.running_var.copy_(torch.tensor([700.0, 700.0, 300.0, 300.0]))


def check_reference(dev, label: str = "", use_resnet: bool = False):
    """Phases 4 and 19: a small f32 RelModel (with `use_resnet` the ResNet
    one: a shallow trunk, layer4 towers, pooling dim 2048): the card
    (kernels) == the CPU (plain versions) on decisions; scores within
    rtol 1e-3 / atol 1e-4."""
    budgets = C.PadBudgets(rpn_pre_nms_topn_test=720, rpn_post_nms_topn_test=32,
                           objs_per_img=8, max_pairs_eval=32, per_class_nms_topk=16)
    resnet = (dict(use_resnet=True, resnet_layers=RESNET_SMALL_LAYERS, pooling_dim=2048)
              if use_resnet else dict(pooling_dim=128))
    cpu_model = RelModel(num_classes=12, num_rels=8, embed_dim=16, hidden_dim=24,
                         obj_dim=128, nl_obj=2, nl_edge=2,
                         order="leftright", thresh=0.0, dtype=torch.float32, budgets=budgets,
                         union_chunk=16, **resnet, **BENCH_FLAGS)
    random_init_(cpu_model, torch.Generator().manual_seed(SEED))
    if use_resnet:
        resnet_small_(cpu_model)
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
    print(f"{label}reference: small f32 {'ResNet ' if use_resnet else ''}RelModel on the "
          f"card == on the CPU ({int(ov.sum())} objects, {int(rv.sum())} relations; "
          f"scores within rtol 1e-3 / atol 1e-4)", flush=True)


def check_detector_reference(dev, label: str = "", use_resnet: bool = False) -> None:
    """Phases 4a and 19: one detector-training step of a small f32 rpntrain
    detector (96^2 images, VGG16, a 128-wide fc tower, 12 classes; with
    `use_resnet` a shallow ResNet C4 trunk, the 256-channel compression and
    the SELU head) on the card and on the CPU (PyTorch's own convolutions)
    from one state dict, dropout off; the CPU step's anchor targets and RoI
    sample (its indices into the card's own proposals + GT) replayed on the
    card."""
    im = 96
    budgets = C.PadBudgets(max_gt_boxes=8, rois_per_img=32, rpn_pre_nms_topn_train=720,
                           rpn_post_nms_topn_train=64)
    cpu_model = ObjectDetector(num_classes=12, mode="rpntrain", obj_dim=128,
                               dtype=torch.float32, budgets=budgets, use_resnet=use_resnet,
                               resnet_layers=RESNET_SMALL_LAYERS)
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
    name = f"{label}detector-reference"
    require(tuple(launches.values()) == DET_STEP_LAUNCHES,
            f"{name}: launches {launches}, expected {DET_STEP_LAUNCHES}")
    fg = out.od_valid & (out.od_labels > 0)
    from_props = fg & (out.det_sample.idx < budgets.rpn_post_nms_topn_train)
    n_anchor_fg = int((out.rpn_labels == 1).sum())
    require(int(from_props.sum()) > 0 and n_anchor_fg > 0,
            f"{name}: no fg RoI among the proposals or no fg anchor")
    torch.testing.assert_close(gout.od_rois.detach().cpu(), out.od_rois.detach(),
                               rtol=1e-4, atol=1e-3)
    for k in ("class_loss", "box_loss", "rpn_class_loss", "rpn_box_loss", "total"):
        torch.testing.assert_close(got[k].cpu(), exp[k], rtol=1e-4, atol=0.0)
    require(got["skipped"].item() == 0 and exp["skipped"].item() == 0,
            f"{name}: skipped step")
    gpu_params = dict(gpu_model.named_parameters())
    worst_g = worst_s = 0.0
    worst_leaf = ""
    flat = []
    for leaf, p in cpu_model.named_parameters():
        q = gpu_params[leaf]
        g = q.grad.cpu()
        if use_resnet:
            # in L2 of each leaf's norm (tests/test_torch_resnet.py holds the
            # ResNet detector so): a ReLU (or SELU) whose input lies within
            # rounding of 0 takes another slope on each side, and one
            # position moves a leaf's largest entry by ~1e-2 at these few
            # positions and RoIs (measured: the trunk's worst 1.0e-2 of its
            # largest entry; the SELU head's fc1 1.2e-3; all leaves together
            # 1.2e-3 in L2)
            err = ((g - p.grad).norm() / p.grad.norm().clamp(min=1e-12)).item()
            flat.append((g.ravel(), p.grad.ravel()))
        else:
            scale = max(p.grad.abs().max().item(), 1e-12)
            err = (g - p.grad).abs().max().item() / scale
        if err > worst_g:
            worst_g, worst_leaf = err, leaf
        scale = max(p.detach().abs().max().item(), 1e-12)
        p0 = init[leaf]
        stepped = p0 - lr * (g + l2 * p0)
        worst_s = max(worst_s, (q.detach().cpu() - stepped).abs().max().item() / scale)
    grad_tol = 1e-2 if use_resnet else 1e-3
    require(worst_g <= grad_tol, f"{name}: gradient off by {worst_g:.2e} at {worst_leaf}")
    within = f"within {worst_g:.2e} of each leaf's max"
    if use_resnet:
        card, cpu = (torch.cat(t) for t in zip(*flat))
        err = ((card - cpu).norm() / cpu.norm()).item()
        require(err <= 5e-3, f"{name}: the gradient off by {err:.2e} in L2")
        within = (f"within {worst_g:.2e} of each leaf's norm (tol 1e-2; {worst_leaf}) and "
                  f"{err:.2e} of all together (tol 5e-3), in L2")
    require(worst_s <= 1e-5, f"{name}: SGD step off by {worst_s:.2e}")
    print(f"{name}: card == CPU for one detector-training step ({int(fg.sum())} "
          f"fg RoIs, {int(from_props.sum())} of them proposals; {n_anchor_fg} fg anchors; "
          f"losses {({k: round(v.item(), 6) for k, v in exp.items() if 'loss' in k})}); "
          f"gradients {within}; the card's SGD step within {worst_s:.2e}; launches "
          f"{launches}", flush=True)


def window_s(hist: list, warmup: int = TRAIN_WARMUP) -> float:
    """Seconds a step over the timed steps of a run's history, from the end
    of the last warm-up step's call to the end of the last step's: the
    loader, the prefetch copy and the host work between the steps count."""
    return (hist[-1]["end_s"] - hist[warmup - 1]["end_s"]) / (len(hist) - warmup)


def detector_step_split(model, kw: dict, lr: float, dev, reps: int = 3) -> dict:
    """A synced split of one detector-training step, ms per part (median of
    `reps` steps): the trunk (VGG or ResNet); the RPN head and its proposals (K3); the
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
    first = next(model.features.parameters())   # the trunk's first conv
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


def check_detector_train(smi: str, dev, label: str = "", args: list = DET_TRAIN_ARGS,
                         warmup: int = TRAIN_WARMUP, timed_steps: int = TRAIN_TIMED) -> dict:
    """Phases 16 and 21: detector pretraining through train_detector.main at
    `args` (the published flags and widths; phase 21 with -resnet) on
    SyntheticVG (seeded random weights, the class biases spread), one epoch
    of `warmup` + `timed_steps` steps and its mAP validation over
    DET_VAL_IMAGES images; the checkpoint restored; a synced split of one
    step; the kernels' device time of a step and K1's backward on one
    step's RoIs. Returns the launches of its training steps and of its
    validation."""
    n_steps = warmup + timed_steps
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
        argv = args + ["-nepoch", "1", "-p", "4", "-save_dir", tmp]
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
    name = f"{label}detector train"
    require(len(hist) == n_steps, f"{name}: {len(hist)} steps")
    require(all(math.isfinite(h[k]) for h in hist for k in h),
            f"{name}: a loss is not finite")
    skipped = int(sum(h["skipped"] for h in hist))
    require(skipped == 0, f"{name}: {skipped} skipped steps")
    train_l = at["train"]
    val_l = {k: at["val"][k] - train_l[k] for k in train_l}
    require(tuple(train_l.values()) == tuple(n_steps * n for n in DET_STEP_LAUNCHES),
            f"{name}: training launches {train_l}, expected {DET_STEP_LAUNCHES} a step")
    require(tuple(val_l.values()) == tuple(n_val_batches * n for n in DET_VAL_BATCH_LAUNCHES),
            f"{name}: validation launches {val_l}, expected "
            f"{DET_VAL_BATCH_LAUNCHES} a batch")
    m = res.maps[0]
    require(len(res.maps) == 1 and math.isfinite(m) and 0.0 <= m <= 1.0,
            f"{name}: mAP {res.maps}")
    gt, results = evaluated["gt"], evaluated["results"]
    require(len(gt["images"]) == DET_VAL_IMAGES, f"{name}: val GT images")
    per_image: dict = {}
    for r in results:
        per_image.setdefault(r["image_id"], []).append(
            (r["category_id"], tuple(r["bbox"]), r["score"]))
    require(set(per_image) <= set(range(DET_VAL_IMAGES)) and all(
        len(v) == len(set(v)) for v in per_image.values()),
        f"{name}: an image evaluated twice or out of the split")
    timed = [h["step_s"] for h in hist[warmup:]]
    med, win = statistics.median(timed), window_s(hist, warmup)
    for ln in buf.getvalue().splitlines():
        if ln.startswith(("e0b", "[train_detector]", "[Loader]")):
            print(f"  {ln}", flush=True)
    first, last = hist[0], hist[-1]
    print(f"{name}: {timed_steps} steps of 6 images 592x592 after {warmup} "
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
        cfg = C.ModelConfig.from_args(args)
    batch = Loader(splits[0], 6, shuffle=False, budgets=cfg.budgets, **loader_im_kw(cfg)).peek()
    kw = to_device(train_detector.batch_kwargs(batch), dev)
    split = detector_step_split(res.model, kw, cfg.lr * 6, dev)
    print(f"{label}detector train-split: one step of 6 images, synced at each part, on "
          f"{smi}: {split} ms, sum {sum(split.values()):.3f} ms", flush=True)
    step = make_train_step(res.model, make_optimizer(res.model, cfg.lr * 6),
                           detector_losses)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dev_t = device_ms(lambda: step(kw, gen), ("roi_align_smem", "roi_align_bwd_smem",
                                              "roi_align_bwd_kernel", "cast_bf16",
                                              "nms_mask", "nms_scan", "perclass_nms"), reps=2)
    print(f"{label}detector step device time: " + (
        "not measured" if dev_t is None else
        f"{dev_t['all']:.3f} ms of kernels a step, of which K1 {dev_t['roi_align_smem']:.3f}, "
        f"K1 backward {dev_t['roi_align_bwd_smem']:.4f} (the shared-memory kernel; the "
        f"scatter kernel {dev_t['roi_align_bwd_kernel']:.4f}, cast "
        f"{dev_t['cast_bf16']:.4f}), K3 {dev_t['nms_mask'] + dev_t['nms_scan']:.3f} ms"),
        flush=True)
    require(dev_t is not None, f"{label}detector step: the profiler recorded no device "
            "time, so the kernels K1's backward ran cannot be checked")
    require(dev_t["roi_align_bwd_smem"] > 0 and dev_t["roi_align_bwd_kernel"] == 0
            and dev_t["cast_bf16"] == 0,
            f"{label}detector step: K1's backward must run the shared-memory kernel, with "
            "no scatter or cast launch for the bf16 map")
    # K1's backward alone on this step's own RoI sample, beside phase 3's
    # drawn sample (the kernels line's figures)
    out = step(kw, gen)[1]
    rois, valid = out.od_rois.detach(), out.od_valid
    c = 256 if res.model.use_resnet else 512   # the map K1 crops: the compression's
    g16 = torch.randn(rois.shape[:2] + (7, 7, c), generator=gen, device=dev).bfloat16()
    shape = tuple(out.fmap.shape[:3]) + (c,)

    def bwd():
        return ra.roi_align_bwd_cuda(g16, rois, valid, shape, torch.bfloat16, 1 / 16)

    t_own = time_ms(bwd)
    own_dev = device_ms(bwd, ("roi_align_bwd_smem",))
    print(f"{label}K1 roi_align_bwd {list(shape)} on one step's own RoI sample "
          f"({int(valid.sum())} valid of {valid.numel()}): {t_own:.4f} ms a synced call, device "
          + ("not measured" if own_dev is None else
             f"{own_dev['roi_align_bwd_smem']:.4f} ms (every kernel of the call "
             f"{own_dev['all']:.4f})"), flush=True)
    del res, step, out
    torch.cuda.empty_cache()
    return {name: train_l, f"{label}detector validation": val_l}


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


def bench_model(dev, gen, use_resnet: bool = False) -> RelModel:
    """MotifNet SGDet at the JAX bench config's widths, random weights from
    `gen`: convs and fc towers in bf16, the context in f32. With
    `use_resnet` the ResNet-101 C4 model (phase 20), its pooling and object
    dims 2048."""
    dim = 2048 if use_resnet else 4096
    with torch.device(dev):
        model = RelModel(num_classes=C.VG_NUM_CLASSES,
                         num_rels=C.VG_NUM_PREDICATES, embed_dim=200,
                         hidden_dim=512, pooling_dim=dim, obj_dim=dim,
                         nl_obj=2, nl_edge=4, order="leftright", thresh=0.0,
                         dtype=torch.bfloat16, budgets=C.PadBudgets(),
                         union_chunk=512, use_resnet=use_resnet, **BENCH_FLAGS)
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
            n_objs, n_rels, n_moved, worst = compare_eval_runs(
                f"{label}eval-reference {mode}", mode, exp_rd, exp, got_rd, got, 4)
            recall = {k: float(np.mean(v)) for k, v in got_rd[mode + "_recall"].items()}
            ties = (f"; {n_moved} relations ranked apart within near ties (triplet scores "
                    f"within {worst:.2e})" if mode == "sgdet" else "")
            print(f"{label}eval-reference {mode}: card == CPU on 4 images {im}x{im} uint8 "
                  f"({n_objs} objects, {n_rels} relations; R@K {recall}{ties})", flush=True)


def compare_eval_runs(what: str, mode: str, exp_rd: dict, exp: list, got_rd: dict,
                      got: list, n_images: int, box_atol: float = 1e-3) -> tuple:
    """The card's evaluation (recall lists `got_rd`, cached entries `got`)
    against the CPU's: identical recall lists, classes and valid masks,
    pair order identical (sgdet: wherever the triplet scores are apart,
    `match_ranking`), scores within rtol 1e-3 / atol 1e-4, boxes within
    rtol 1e-4 / atol `box_atol`. Returns (objects, relations, relations ranked
    apart within near ties, their largest relative gap)."""
    require(got_rd == exp_rd, f"{what}: recall lists differ: card {got_rd} vs CPU {exp_rd}")
    require(len(got) == len(exp) == n_images, f"{what}: entries")
    n_rels = n_objs = n_moved = 0
    worst = 0.0
    for g, e in zip(got, exp):
        for key in ("pred_classes", "obj_valid"):
            require(np.array_equal(g[key], e[key]), f"{what}: {key} differ")
        if mode == "sgdet":
            perm, moved, gap = match_ranking(g, e, what)
            n_moved, worst = n_moved + moved, max(worst, gap)
        else:
            require(np.array_equal(g["pred_rel_inds"], e["pred_rel_inds"]),
                    f"{what}: pred_rel_inds differ")
            perm = np.arange(len(e["pred_rel_inds"]))
        np.testing.assert_allclose(g["rel_scores"], e["rel_scores"][perm],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(g["obj_scores"], e["obj_scores"],
                                   rtol=1e-3, atol=1e-4)
        ov = e["obj_valid"]
        np.testing.assert_allclose(g["pred_boxes"][ov], e["pred_boxes"][ov],
                                   rtol=1e-4, atol=box_atol)
        n_rels += len(g["pred_rel_inds"])
        n_objs += int(ov.sum())
    require(n_rels > 0 and n_objs > 0, f"{what}: degenerate")
    return n_objs, n_rels, n_moved, worst


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


def check_train(smi: str, label: str, train_args: list, plan: str,
                expected: dict = TRAIN_LAUNCHES, warmup: int = TRAIN_WARMUP,
                timed_steps: int = TRAIN_TIMED) -> dict:
    """Phases 9, 14 and 21: a published training config in each mode of
    `expected` (its launches) through train_rels.main, one epoch of
    `warmup` + `timed_steps` steps, then its validation. Returns the
    training steps' launches by path."""
    splits = StructuredSyntheticVG.splits(
        num_images=(warmup + timed_steps) * 6, val_images=TRAIN_VAL_IMAGES,
        num_classes=C.VG_NUM_CLASSES, num_predicates=C.VG_NUM_PREDICATES, seed=SEED)
    paths = {}
    for mode in expected:
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
        require(len(hist) == warmup + timed_steps, f"{name}: {len(hist)} steps")
        require(all(math.isfinite(h["total"]) for h in hist), f"{name}: a loss is not finite")
        skipped = int(sum(h["skipped"] for h in hist))
        require(skipped == 0, f"{name}: {skipped} skipped steps")
        for key, v in res.model.detector.state_dict().items():
            require(torch.equal(v.cpu(), det_init[key]), f"{name}: detector changed at {key}")
        launches = paths[name] = at_val["launches"]
        require(tuple(launches.values()) == expected[mode],
                f"{name}: launches {launches}, expected {expected[mode]}")
        r = check_recalls(res.evaluator, mode, TRAIN_VAL_IMAGES)
        timed = [h["step_s"] for h in hist[warmup:]]
        med, win = statistics.median(timed), window_s(hist, warmup)
        for ln in buf.getvalue().splitlines():
            if ln.startswith(("e0b", "[train_rels]", "[Loader]", "[pairs]", "R@")):
                print(f"  {ln}", flush=True)
        print(f"{name}: {timed_steps} steps of 6 images 592x592 after "
              f"{warmup} warm-up on {smi}: {win:.4f} s/step over the window, "
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


def kernel_device_times(fn, reps: int = 2, dev_t: dict | None = None) -> str:
    """The device time of `fn`'s kernels (torch.profiler), K1-K4 apart (or
    of a profile `dev_t` already taken of them)."""
    if dev_t is None:
        dev_t = device_ms(fn, DEVICE_NAMES, reps=reps)
    if dev_t is None:
        return "not measured"
    return (f"{dev_t['all']:.3f} ms of kernels, of which K1 {dev_t['roi_align']:.3f}, "
            f"K2 {dev_t['perclass_nms']:.3f}, K3 {dev_t['nms_mask'] + dev_t['nms_scan']:.3f}, "
            f"K4 {dev_t['highway_lstm']:.3f} ms")


def eval_batch_profile(argv: list, datasets) -> str:
    """One batch of the first val images through the model eval_rels.main
    builds for `argv` (its seed, its -ckpt): the synced forward on the
    host's clock (median of 3) beside the device time of its kernels
    (torch.profiler, 2 batches), K1-K4 apart; what the host adds is the
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
    """Phases 7, 12 and 21: a published eval config in each mode of
    `expected` (its launches). Per
    mode, a warm-up run on the SyntheticVG fallback (8 val images; the
    first batch at new shapes pays cuDNN/cuBLAS plans and allocator
    growth), then the run that is timed and counted, on EVAL_VAL_IMAGES val
    images. Returns its launches by path."""
    timed = SyntheticVG.splits(num_images=4 * EVAL_VAL_IMAGES)
    n_val = len(timed[1])
    paths = {}
    for mode in expected:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["-m", mode, *base_args]
            if mode == "sgdet":
                ckpt = os.path.join(tmp, "sgdet.pt")
                init_ckpt(ckpt, argv, timed[0], spread=True)
                argv += ["-ckpt", ckpt]
            ev, _, _ = run_eval(argv, None, "cuda")
            check_recalls(ev, mode, 8)   # the fallback's val split
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            ev, lines, rate = run_eval(argv, timed, "cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = paths[f"{label}eval {mode}"] = count_launches()
            profile = eval_batch_profile(argv, timed)
        r = check_recalls(ev, mode, n_val)
        require(tuple(launches.values()) == expected[mode],
                f"{label}eval {mode}: launches {launches}, expected {expected[mode]}")
        for ln in lines:
            if not ln.startswith("optimistic_restore"):
                print(f"  {ln}", flush=True)
        print(f"{label}eval {mode}: {n_val} images after a warm-up, {rate:.3f} img/s, "
              f"R@20/50/100 {r[20]} / {r[50]} / {r[100]}; on {smi}: peak memory "
              f"{peak:.2f} GiB; launches {launches}", flush=True)
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


# the modules a request's synced split times (those the model has): the
# trunk, the whole detector, the object tower, the context, the union boxes
# (K1 and the mask convs) and the union tower, each summed over its calls
REQUEST_PARTS = ("detector.features", "detector", "roi_fmap_obj", "context",
                 "union_boxes", "roi_fmap")


def request_split(model, images, im_hw, reps: int = 3) -> dict:
    """A synced split of one request, ms per part (median of `reps`): each
    module of REQUEST_PARTS the model has, timed between a synchronize
    before and after each of its calls; "detector" less its trunk is the
    RPN, the RoI head and the decode; "rest" is the request less the parts
    (the pair selection, the heads, the decode and the sort)."""
    mods = {name: model.get_submodule(name) for name in REQUEST_PARTS
            if hasattr(model, name.split(".")[0])}
    acc: dict = {}

    def pre(name):
        def hook(*_):
            torch.cuda.synchronize()
            acc.setdefault(name, []).append(-time.perf_counter())
        return hook

    def post(name):
        def hook(*_):
            torch.cuda.synchronize()
            acc[name][-1] += time.perf_counter()
        return hook

    hooks = [h for name, m in mods.items() for h in
             (m.register_forward_pre_hook(pre(name)), m.register_forward_hook(post(name)))]
    runs = []
    try:
        for _ in range(reps):
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(images, im_hw)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            part = {name: sum(v) * 1e3 for name, v in acc.items()}
            part["detector"] -= part.get("detector.features", 0.0)
            part["rest"] = total * 1e3 - sum(part.values())
            runs.append(part)
    finally:
        for h in hooks:
            h.remove()
    return {name: round(statistics.median(r[name] for r in runs), 3) for name in runs[0]}


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
    # (after the counted requests: these launches are not counted), and the
    # busy share: that time over the median latency
    dev_t = device_ms(lambda: model(requests[0], im_hw), DEVICE_NAMES, reps=2)
    busy = "not measured" if dev_t is None else f"{dev_t['all'] / (med * 1e3):.3f}"
    print(f"{label}request device time: " + kernel_device_times(None, dev_t=dev_t)
          + f" a request; busy share {busy} of the median latency", flush=True)
    split = request_split(model, requests[0], im_hw)
    print(f"{label}request-split: one request, synced at each part, on {smi}: {split} ms "
          f"(detector: less its trunk, detector.features)", flush=True)
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


# ---------------------------------------------------------------------------
# phase 18: data parallelism
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(rank: int, world: int, port: int):
    """torchrun's environment for one rank, restored afterwards."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_detector_steps(cfg, train, dev, states: list | None = None) -> dict:
    """DP_STEPS steps of detector pretraining, built as train_detector.main
    builds them (the rank's loader slice, the weights replicated from rank
    0, the step with its gradient all-reduce; in a group or not). Without
    `states` the weights are `train_detector.SEED`'s and the state before
    each step (weights, momentum, generator) is recorded; with them each
    step starts from the recorded state. Returns the states, each step's
    losses and parameters after it, the launches, the model and the step."""
    model = train_detector.build_detector(cfg, train.num_classes, dev,
                                          torch.Generator(device=dev).manual_seed(SEED))
    mesh.replicate_(model)
    loader = Loader(train, cfg.batch_size * cfg.num_devices, shuffle=True,
                    budgets=cfg.budgets, **loader_im_kw(cfg), **mesh.loader_kw())
    opt = make_optimizer(model, cfg.lr * cfg.num_devices * cfg.batch_size, l2=cfg.l2)
    step = make_train_step(model, opt, detector_losses, clip=cfg.clip)
    gen = torch.Generator(device=dev).manual_seed(train_detector.SAMPLE_SEED)
    batches = [to_device(train_detector.batch_kwargs(b), dev) for b in loader]
    record = states is None
    states = [] if record else states
    losses, params = [], []
    zero_launches()
    for k, kw in enumerate(batches):
        if record:
            states.append((copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict()),
                           gen.get_state()))
        else:
            model.load_state_dict(states[k][0])
            opt.load_state_dict(copy.deepcopy(states[k][1]))
            gen.set_state(states[k][2])
        out, _ = step(kw, gen)
        losses.append({key: float(v) for key, v in out.items()})
        params.append({key: p.detach().clone() for key, p in model.named_parameters()})
    torch.cuda.synchronize()
    return dict(states=states, losses=losses, params=params, launches=count_launches(),
                model=model, step=step, batch=batches[0])


def rel_diffs(a: dict, b: dict) -> dict:
    """Each tensor's largest difference between two state dicts over its
    leaf's largest magnitude."""
    out = {}
    for k, v in a.items():
        v, w = v.float(), b[k].float()
        out[k] = (v - w).abs().max().item() / max(v.abs().max().item(), 1e-12)
    return out


def dp_compare(a: dict, b: dict) -> tuple:
    """Two runs of dp_detector_steps from the same states: (steps whose
    losses are equal bit for bit, the largest loss difference (relative),
    the gradient norm's, the parameters' (of each leaf's max, over the
    steps), the three leaves of largest parameter difference)."""
    keys = ("total", "class_loss", "box_loss", "rpn_class_loss", "rpn_box_loss")
    equal, loss, norm, leaves = 0, 0.0, 0.0, {}
    for la, lb, pa, pb in zip(a["losses"], b["losses"], a["params"], b["params"]):
        equal += all(la[k] == lb[k] for k in keys)
        loss = max(loss, max(abs(la[k] - lb[k]) / abs(la[k]) for k in keys))
        norm = max(norm, abs(la["grad_norm"] - lb["grad_norm"]) / la["grad_norm"])
        for k, d in rel_diffs(pa, pb).items():
            leaves[k] = max(leaves.get(k, 0.0), d)
    top = sorted(leaves.items(), key=lambda kv: -kv[1])[:3]
    return equal, loss, norm, top[0][1], {k: f"{d:.1e}" for k, d in top}


def check_dp_nccl(smi: str, dev) -> dict:
    """Phase 18 (a): phase 16's detector-pretraining config, DP_STEPS steps
    in a process group of one rank in this process (torchrun's environment,
    NCCL: the collectives run), against the steps without a group, each
    step from the same state (weights, momentum, generator). The forward
    and the losses are the same computation; the gradients, and so the
    parameters, agree only as closely as two runs without a group do,
    since the backward sums in an order that changes between runs (K1's
    backward does; chained over steps, that rounding would move the
    samplers' discrete choices): the steps are replayed once more without
    a group for that yardstick, and the group's differences may be at most
    10 times it.
    Then the gradient all-reduce's time and the step's kernels. Returns
    the launches of the group's steps."""
    train = SyntheticVG(DP_STEPS * 6, "train", seed=SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(DET_TRAIN_ARGS)
    plain = dp_detector_steps(cfg, train, dev)
    del plain["model"], plain["step"]
    again = dp_detector_steps(cfg, train, dev, plain["states"])
    del again["model"], again["step"]
    noise = dp_compare(plain, again)
    del again
    with torchrun_env(0, 1, free_port()):
        with contextlib.redirect_stdout(io.StringIO()):
            gcfg = C.ModelConfig.from_args(DET_TRAIN_ARGS + ["-ngpu", "1"])
        gdev = mesh.setup(dev)
        try:
            require(D.active() and D.world() == 1 and dist_backend() == "nccl",
                    "data-parallel nccl: no NCCL group of one rank")
            group = dp_detector_steps(gcfg, train, gdev, plain["states"])
            params = list(group["model"].parameters())
            n_params = sum(p.numel() for p in params)
            ar_ms = time_ms(lambda: mesh.all_reduce_grads_(params))
            ar_dev = device_ms(lambda: mesh.all_reduce_grads_(params),
                               ("nccl", "CatArrayBatchedCopy"), reps=5)
            flat_dev = device_ms(lambda: torch.cat([p.grad.reshape(-1) for p in params]),
                                 (), reps=5)
            sgen = torch.Generator(device=gdev).manual_seed(SEED)
            step_ms = time_ms(lambda: group["step"](group["batch"], sgen), reps=3)
            step_dev = device_ms(lambda: group["step"](group["batch"], sgen),
                                 ("roi_align_smem", "roi_align_bwd_smem", "nms_mask",
                                  "nms_scan", "nccl", "CatArrayBatchedCopy"), reps=2)
        finally:
            D.shutdown()
    name = "data-parallel nccl"
    launches = group["launches"]
    expected = tuple(DP_STEPS * n for n in DET_STEP_LAUNCHES)
    require(tuple(launches.values()) == expected,
            f"{name}: launches {launches}, expected {expected}")
    require(all(math.isfinite(h["total"]) and h["skipped"] == 0 for h in group["losses"]),
            f"{name}: a loss is not finite or a step skipped")
    equal, loss, norm, param, top = dp_compare(plain, group)
    require(equal == DP_STEPS and norm <= max(10 * noise[2], 1e-5)
            and param <= max(10 * noise[3], 1e-5),
            f"{name}: the group's steps left the plain ones: losses {loss:.2e}, gradient "
            f"norm {norm:.2e}, parameters {param:.2e} of each leaf's max {top}; two runs "
            f"without a group: {noise[1]:.2e} / {noise[2]:.2e} / {noise[3]:.2e} {noise[4]}")
    require(ar_dev is not None and step_dev is not None,
            f"{name}: the profiler recorded no device time")
    print(f"{name}: phase 16's detector config, {DP_STEPS} steps of 6 images in an NCCL "
          f"group of 1 rank == the steps without a group, each from the same state: losses "
          f"bit for bit in {equal} of {DP_STEPS} steps; the gradient "
          f"norm within {norm:.2e} and the parameters within {param:.2e} of each leaf's max "
          f"{top}, against {noise[2]:.2e} / {noise[3]:.2e} {noise[4]} between two runs "
          f"without a group (the backward sums in a run-dependent order, K1's backward "
          f"among them); the step call "
          f"{step_ms:.2f} ms (synced, median of 3); launches {launches}", flush=True)
    print(f"{name} all-reduce on {smi}: {n_params} f32 gradients ({4 * n_params / 1e6:.1f} "
          f"MB) flattened, all-reduced, copied back: {ar_ms:.4f} ms a synced call, device "
          f"{ar_dev['all']:.4f} ms (the all-reduce {ar_dev['nccl']:.4f}, the flatten "
          f"{ar_dev['CatArrayBatchedCopy']:.4f}; the flatten alone "
          + ("no device work" if flat_dev is None else f"{flat_dev['all']:.4f}")
          + f"); bound {2 * 2 * 4 * n_params / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes: the "
          f"flatten and the copy back each read and write the gradients once; NCCL's "
          f"in-place all-reduce over one rank moves none)", flush=True)
    print(f"{name} step device time: {step_dev['all']:.3f} ms of kernels a step, of which "
          f"K1 {step_dev['roi_align_smem']:.3f}, K1 backward "
          f"{step_dev['roi_align_bwd_smem']:.4f}, K3 "
          f"{step_dev['nms_mask'] + step_dev['nms_scan']:.3f}, the all-reduce "
          f"{step_dev['nccl']:.4f}, the flatten {step_dev['CatArrayBatchedCopy']:.4f} ms",
          flush=True)
    del plain, group, params
    torch.cuda.empty_cache()
    return {"dp detector train (nccl, 1 rank)": launches}


def dist_backend() -> str:
    import torch.distributed as dist
    return dist.get_backend()


def dp_fixture(dev) -> dict:
    """Phase 18 (b)'s cases, on the host: a small sgdet MotifNet step and a
    small detector step on DP_IMAGES 96^2 images whose GT counts differ
    between the ranks' halves, dropout on, the samplers drawn."""
    im, counts = 96, (5, 4, 2, 3)
    gen = torch.Generator().manual_seed(SEED + 18)
    images = torch.randn(DP_IMAGES, im, im, 3, generator=gen) * 0.4
    im_hw = torch.full((DP_IMAGES, 2), float(im))
    budgets = C.PadBudgets(max_gt_boxes=8, max_gt_rels=8, rpn_pre_nms_topn_test=720,
                           rpn_post_nms_topn_test=32, objs_per_img=8, per_class_nms_topk=16)
    rel = small_motifnet("sgdet", budgets)
    random_init_(rel, torch.Generator().manual_seed(SEED))
    with torch.no_grad():   # the GT: some of each image's detections
        det = rel.detector(images, im_hw)
    boxes, classes, mask, (rels, rel_mask) = small_gt(gen, DP_IMAGES, im, 12)
    mask[:] = False
    rel_mask[:] = False
    boxes[:] = 0.0
    classes[:] = 0
    for i, n in enumerate(counts):
        require(bool(det.rm_valid[i, :n].all()), "data-parallel gloo: too few detections")
        boxes[i, :n] = det.rm_boxes[i, :n]
        classes[i, :n] = torch.randint(1, 12, (n,), generator=gen)
        mask[i, :n] = True
        one = small_rels(gen, 1, n, n - 1)
        rels[i], rel_mask[i] = one[0][0], one[1][0]
    kw = dict(images=images, im_hw=im_hw, gt_boxes=boxes, gt_classes=classes,
              gt_mask=mask, gt_rels=rels, gt_rel_mask=rel_mask)
    det_budgets = C.PadBudgets(max_gt_boxes=8, rois_per_img=32, rpn_pre_nms_topn_train=720,
                               rpn_post_nms_topn_train=64)
    detector = ObjectDetector(num_classes=12, mode="rpntrain", obj_dim=128,
                              dtype=torch.float32, budgets=det_budgets)
    random_init_(detector, torch.Generator().manual_seed(SEED))
    det_boxes = boxes.clone()
    det_boxes[0, 0] = torch.tensor([2.0, 3.0, 90.0, 92.0])   # large: some proposals are fg
    det_kw = {k: kw[k] for k in ("images", "im_hw", "gt_classes", "gt_mask")}
    return {"cases": [
        dict(name="sgdet step", model="rel", budgets=budgets, state_dict=rel.state_dict(),
             inputs=kw, lr=6e-3, seed=SEED + 1, counts=counts),
        dict(name="detector step", model="detector", budgets=det_budgets,
             state_dict=detector.state_dict(), inputs=dict(det_kw, gt_boxes=det_boxes),
             lr=6e-3, seed=SEED + 2, counts=counts)]}


def dp_steps(spec: dict, dev) -> list:
    """Phase 18 (b): this rank's step of each case on its rows of the
    global batch (all of them without a group): the global losses, the
    summed gradients after the clip, the parameters and BN statistics after
    the step, and the kernels' launches."""
    out = []
    for case in spec["cases"]:
        if case["model"] == "detector":
            model = ObjectDetector(num_classes=12, mode="rpntrain", obj_dim=128,
                                   dtype=torch.float32, budgets=case["budgets"])
            loss_fn = detector_losses
        else:
            model = freeze_detector_(small_motifnet("sgdet", case["budgets"]))
            loss_fn = rel_losses
        model.load_state_dict(case["state_dict"])
        model.to(dev)
        kw = {k: D.local_batch_slice(v).to(dev) for k, v in case["inputs"].items()}
        step = make_train_step(model, make_optimizer(model, case["lr"]), loss_fn)
        zero_launches()
        losses, _ = step(kw, torch.Generator(device=dev).manual_seed(case["seed"]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append(dict(
            launches=count_launches(),
            losses={k: float(v) for k, v in losses.items()},
            grads={k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None},
            params={k: p.detach().cpu() for k, p in model.named_parameters()},
            buffers={k: b.cpu() for k, b in model.named_buffers()}))
        del model, step
    return out


def _dp_rank(rank: int, port: int, spec_path: str, out_path: str, device: str) -> None:
    """One rank of phase 18 (b), in a process of its own on `device` (card
    0 for every rank): joins the gloo group (the CUDA tensors of its
    collectives staged through host memory) and runs dp_steps."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
    D.initialize("gloo", timeout_s=DP_INIT_TIMEOUT_S)
    try:
        res = dp_steps(torch.load(spec_path, weights_only=False), dev)
        torch.save(res, out_path)
    finally:
        D.shutdown()


def dp_mismatch(got: dict, exp: dict, loss_tol: tuple = (DP_LOSS_RTOL, 0.0)) -> tuple:
    """(where a rank's step leaves the one-process step's tolerances, the
    largest gradient difference over its leaf's max); `loss_tol`: the
    losses' (rtol, atol)."""
    bad = [f"loss {k}" for k, v in exp["losses"].items()
           if not math.isclose(got["losses"][k], v, rel_tol=loss_tol[0], abs_tol=loss_tol[1])]
    for tree, (rtol, atol) in (("params", DP_PARAM_TOL), ("buffers", DP_BN_TOL)):
        bad += [f"{tree} {k}" for k, v in exp[tree].items()
                if not torch.allclose(got[tree][k], v, rtol=rtol, atol=atol)]
    worst = 0.0
    for k, e in exp["grads"].items():
        scale = max(e.abs().max().item(), 1e-12)
        worst = max(worst, (got["grads"][k] - e).abs().max().item() / scale)
    if worst > DP_GRAD_TOL or set(got["grads"]) != set(exp["grads"]):
        bad.append(f"gradients {worst:.2e}")
    return bad, worst


def check_dp_gloo(smi: str, dev: torch.device) -> dict:
    """Phase 18 (b): DP_RANKS gloo ranks, processes of their own sharing the
    card, against this process alone at the global batch: the small sgdet
    MotifNet step and the small detector step (dp_fixture). Returns each
    step's launches, summed over the ranks."""
    t0 = time.time()
    spec = dp_fixture(dev)
    exp = dp_steps(spec, dev)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.pt")
        torch.save(spec, spec_path)
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_RANKS)]
        procs = [ctx.Process(target=_dp_rank, args=(r, port, spec_path, outs[r], str(dev)))
                 for r in range(DP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_JOIN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        require(not hung and all(p.exitcode == 0 for p in procs),
                f"data-parallel gloo: ranks exited {[p.exitcode for p in procs]}")
        got = [torch.load(o, weights_only=False) for o in outs]
    paths = {}
    for c, case in enumerate(spec["cases"]):
        name = f"data-parallel gloo {case['name']}"
        worst, launches = 0.0, dict.fromkeys(KERNELS, 0)
        for r in range(DP_RANKS):
            bad, w = dp_mismatch(got[r][c], exp[c])
            require(not bad, f"{name}: rank {r} leaves the global batch's step: {bad[:6]}")
            worst = max(worst, w)
            for k, n in got[r][c]["launches"].items():
                launches[k] += n
        for k in got[0][c]["params"]:
            require(torch.equal(got[0][c]["params"][k], got[1][c]["params"][k]),
                    f"{name}: the replicas differ at {k}")
        want = DET_STEP_LAUNCHES if case["model"] == "detector" else DP_SGDET_LAUNCHES
        require(tuple(launches.values()) == tuple(DP_RANKS * n for n in want),
                f"{name}: launches {launches}, expected {want} a rank")
        require(exp[c]["losses"]["skipped"] == 0, f"{name}: the step skipped")
        counts = case["counts"]
        print(f"{name}: {DP_RANKS} ranks x {DP_IMAGES // DP_RANKS} images on one {smi} == 1 "
              f"process x {DP_IMAGES} images (GT boxes {counts[:2]} | {counts[2:]}): losses "
              f"{({k: round(v, 6) for k, v in exp[c]['losses'].items() if 'loss' in k})} "
              f"within rtol {DP_LOSS_RTOL}, gradients within {worst:.2e} of each leaf's "
              f"max, parameters within {DP_PARAM_TOL}, BN statistics within {DP_BN_TOL}; "
              f"the replicas equal; launches {launches} over the ranks; "
              f"{time.time() - t0:.1f} s", flush=True)
        paths[f"dp {case['name']} (gloo, {DP_RANKS} ranks)"] = launches
    return paths


# ---------------------------------------------------------------------------
# phase 24: tensor parallelism (the Megatron split of the fc towers)
# ---------------------------------------------------------------------------


def tp_assembled(ranks: list) -> dict:
    """A pass's whole trainable parameters, gradients and BN statistics from
    its ranks' results, with the global losses."""
    return dict(dryrun.assemble(ranks), losses=ranks[0]["losses"])


def tp_launch_check(name: str, ranks: list, want: dict) -> dict:
    """Every rank's launches, exact (each model rank runs the whole
    detector); their sum over the ranks, by part."""
    total = {}
    for part, expected in want.items():
        for r in ranks:
            got = tuple(r["launches"][part].values())
            require(got == expected, f"{name}: rank {r['rank']} {part} launches {got}, "
                                     f"expected {expected}")
        total[part] = {k: sum(r["launches"][part][k] for r in ranks) for k in KERNELS}
    return total


def tp_reduces(r: dict) -> str:
    return ", ".join(f"{part} {s['calls']} ({s['bytes'] / 1e6:.2f} MB, "
                     f"{1e3 * s['seconds']:.2f} ms)" for part, s in r["model_reduces"].items())


def check_tp(smi: str, dev: torch.device) -> dict:
    """Phase 24: (a) dryrun_multichip(TP_TINY_RANKS) at the tiny shapes
    against one process at the global batch; (b) the full shapes, data 1 x
    model 2, in f32 against one process, then in bf16. This process computes
    every one-process reference while (a)'s ranks run; (b)'s ranks run
    alone on the card. Returns the paths' launches, summed over the
    ranks."""
    paths = {}
    t0 = time.time()
    n_data, n_model = dryrun.grid_shape(TP_TINY_RANKS)
    tiny = [dict(kind="tiny", num_images=n_data, mode=m) for m in TP_TINY_LAUNCHES]
    full = [dict(kind="full", num_images=1, dtype="float32"),
            dict(kind="full", num_images=1, dtype="bfloat16", tensors=False)]
    run = dryrun.start_ranks(TP_TINY_RANKS, dev, passes=tiny)
    refs = [dryrun.run_pass(p, dev) for p in tiny]
    full_refs = [dryrun.run_pass(p, dev) for p in full]
    torch.cuda.empty_cache()
    got = dryrun.wait_ranks(run, TP_JOIN_TIMEOUT_S)
    for i, (mode, want) in enumerate(TP_TINY_LAUNCHES.items()):
        name = f"tensor-parallel tiny {mode}"
        ranks, ref = [r[i] for r in got], refs[i]
        try:
            dryrun.check_ranks(ranks)
        except AssertionError as e:
            require(False, f"{name}: {e}")
        exp = tp_assembled([ref])
        bad, worst = dp_mismatch(tp_assembled(ranks), exp, TP_LOSS_TOL)
        require(not bad, f"{name}: the ranks leave the one-process step: {bad[:6]}")
        require(exp["losses"]["skipped"] == 0 and exp["losses"]["class_loss"] > 0,
                f"{name}: a degenerate step {exp['losses']}")
        launches = tp_launch_check(name, ranks + [ref], want)
        print(f"{name}: dryrun_multichip({TP_TINY_RANKS})'s step, {TP_TINY_RANKS} gloo ranks "
              f"(data {n_data} x model {n_model}) on one {smi} == 1 process x {n_data} images "
              f"at _tiny_setup's shapes: losses "
              f"{({k: round(v, 6) for k, v in exp['losses'].items() if 'loss' in k})} within "
              f"rtol {TP_LOSS_TOL[0]} / atol {TP_LOSS_TOL[1]}, gradients within {worst:.2e} of "
              f"each leaf's max, parameters within {DP_PARAM_TOL}, BN statistics within "
              f"{DP_BN_TOL}; replicated tensors equal bit for bit on every rank, the model "
              f"ranks' predictions equal; launches a rank {want}; model-group all-reduces on "
              f"rank 0: {tp_reduces(ranks[0])}; {time.time() - t0:.1f} s", flush=True)
        for part, n in launches.items():
            paths[f"tp tiny {mode} {part} (gloo, {n_data}x{n_model} ranks, with the "
                  f"reference)"] = n
    del got, refs

    t0 = time.time()
    name = "tensor-parallel full"
    refs = full_refs
    grid = TP_FULL_GRID
    got = dryrun.wait_ranks(dryrun.start_ranks(grid[0] * grid[1], dev, grid[1], full),
                            TP_JOIN_TIMEOUT_S)
    f32, bf16 = [r[0] for r in got], [r[1] for r in got]
    for what in (f32, bf16):
        try:
            dryrun.check_ranks(what)
        except AssertionError as e:
            require(False, f"{name}: {e}")
    exp = tp_assembled([refs[0]])
    require(exp["losses"]["class_loss"] > 0 and exp["losses"]["skipped"] == 0,
            f"{name}: a degenerate step {exp['losses']}")
    bad, worst = dp_mismatch(tp_assembled(f32), exp)
    require(not bad, f"{name} f32: the ranks leave the one-process step: {bad[:6]}")
    launches = tp_launch_check(name, f32 + bf16 + refs, TP_FULL_LAUNCHES)
    gib = 2.0 ** 30
    loss_gap = {k: bf16[0]["losses"][k] - refs[1]["losses"][k]
                for k in ("class_loss", "rel_loss", "total")}
    print(f"{name}: {grid[0] * grid[1]} gloo ranks (data {grid[0]} x model {grid[1]}) on one "
          f"{smi}, _full_scale_model's widths at the default budgets, 1 image "
          f"{C.IM_SCALE}x{C.IM_SCALE}, f32 == 1 process: losses "
          f"{({k: round(v, 6) for k, v in exp['losses'].items() if 'loss' in k})} within rtol "
          f"{DP_LOSS_RTOL}, gradients within {worst:.2e} of each leaf's max, parameters within "
          f"{DP_PARAM_TOL}, BN statistics within {DP_BN_TOL}; the replicated tensors equal on "
          f"both ranks; launches a rank {TP_FULL_LAUNCHES}; {time.time() - t0:.1f} s",
          flush=True)
    print(f"{name} bf16: the bench dtype, losses ranks - 1 process "
          f"{({k: f'{v:+.3e}' for k, v in loss_gap.items()})} (row-parallel partial products "
          f"round in bf16 before their sum: not required)", flush=True)
    for label, ranks, one in (("f32", f32, refs[0]), ("bf16", bf16, refs[1])):
        print(f"{name} {label} memory: peak {[round(r['peak_bytes'] / gib, 3) for r in ranks]} "
              f"GiB a rank against {one['peak_bytes'] / gib:.3f} for 1 process; the towers' "
              f"parameters {[round(r['tower_bytes'] / 1e6, 1) for r in ranks]} MB a rank "
              f"against {one['tower_bytes'] / 1e6:.1f} MB ({ranks[0]['tower_bytes'] / one['tower_bytes']:.3f}x); "
              f"the step call {[round(r['step_s'], 3) for r in ranks]} s a rank against "
              f"{one['step_s']:.3f} s", flush=True)
        print(f"{name} {label} model-group all-reduces a rank (calls, payload, host time "
              f"through host memory, the wait for the other rank included): "
              + "; ".join(f"rank {r['rank']}: {tp_reduces(r)}" for r in ranks), flush=True)
    for part, n in launches.items():
        paths[f"tp full {part} (gloo, {grid[0]}x{grid[1]} ranks, f32 + bf16, "
              f"with the references)"] = n
    del got, f32, bf16, refs, exp
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 28: the int8 towers (NM_QUANT=int8, ops/quant.py)
# ---------------------------------------------------------------------------

# (a) int8_matmul at the bench request's shapes (4 images): the union
# tower's fc0 and fc1 over 4 x 1024 pairs, the detector's RoI head fc0 over
# 4 x 1000 RoIs, and 5 rows (at most 16: _int_mm's rows padded); (M, K, N)
INT8_SHAPES = {"union fc0": (4096, 25088, 4096), "union fc1": (4096, 4096, 4096),
               "roi_head fc0": (4000, 25088, 4096), "5 rows": (5, 25088, 4096)}
# the published dense int8 and bf16 tensor-core peaks of one H100 SXM
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BF16_OPS_PER_S = 989e12
# (b) card against CPU under int8: decisions equal, scores and boxes within
# tests/test_torch_quant.py's tolerances for the port's own run against
# JAX's (an input within the two devices' f32 residual of a rounding
# boundary flips an int8 level; the flips are printed)
INT8_SCORE_TOL, INT8_BOX_TOL = dict(rtol=1e-3, atol=2e-2), dict(rtol=1e-4, atol=5e-3)
INT8_TIMING_REPS = 10
# the host cores phase 28 takes beside phase 27's CPU process (which takes 6)
INT8_CPU_THREADS = 2


def tower_flops(shapes) -> float:
    return sum(2.0 * m * k * n for m, k, n in shapes)


def check_int8_matmul(smi: str, dev) -> None:
    """Phase 28 (a): int8_matmul on the card == on the CPU bit for bit at
    INT8_SHAPES (bf16 activations after a ReLU, f32 weights); the card's
    int32 product == the float64 product of the same int8 operands (exact
    at these K); the time of the int8 path (quantization and _int_mm)
    against the bf16 product the float path takes, and _int_mm's alone,
    beside the int8 bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    for name, (m, k, n) in INT8_SHAPES.items():
        x = torch.relu(torch.randn(m, k, generator=gen, device=dev)).bfloat16()
        w = torch.randn(n, k, generator=gen, device=dev) * k ** -0.5
        got = quant.int8_matmul(x, w)
        exp = quant.int8_matmul(x.cpu(), w.cpu())
        require(torch.equal(got.cpu().view(torch.int32), exp.view(torch.int32)),
                f"int8 {name}: card and CPU differ in {int((got.cpu() != exp).sum())} elements")
        x32 = x.float()
        xq = quant.quantize(x32, quant.scale(x32.abs().amax(-1, keepdim=True), quant.X_FLOOR))
        wq = quant.quantize(w, quant.scale(w.abs().amax(-1, keepdim=True), quant.W_FLOOR))
        acc = quant.int_mm(xq, wq)
        require(torch.equal(acc.double(), xq.double() @ wq.double().T),
                f"int8 {name}: the int32 product differs from float64's")
        wb = w.bfloat16()
        t_int8 = time_ms(lambda: quant.int8_matmul(x, w))
        t_mm = time_ms(lambda: quant.int_mm(xq, wq))
        t_bf16 = time_ms(lambda: torch.nn.functional.linear(x, w.to(torch.bfloat16)))
        t_bf16_mm = time_ms(lambda: torch.nn.functional.linear(x, wb))
        ops = tower_flops([(m, k, n)])
        print(f"int8 {name} [{m}, {k}] x [{n}, {k}]^T on {smi}: card == CPU bit for bit, the "
              f"int32 product == float64's; int8_matmul {t_int8:.4f} ms (_int_mm alone "
              f"{t_mm:.4f}), bf16 as the float path computes it (the weight cast each call) "
              f"{t_bf16:.4f} ms (the product alone {t_bf16_mm:.4f}); bound int8 "
              f"{ops / PEAK_INT8_OPS_PER_S * 1e3:.4f} ms (operations), bf16 "
              f"{ops / PEAK_BF16_OPS_PER_S * 1e3:.4f} ms", flush=True)
        del x, w, got, exp, x32, xq, wq, acc, wb
    torch.cuda.empty_cache()


def record_tower_inputs(model, rec: dict) -> list:
    """Forward pre-hooks that append each QuantLinear's input to `rec`."""
    return [m.register_forward_pre_hook(
        lambda mod, args, n=n: rec.setdefault(n, []).append(args[0].detach().float().cpu()))
        for n, m in model.named_modules() if isinstance(m, QuantLinear)]


def int8_levels(rows: torch.Tensor) -> torch.Tensor:
    return quant.quantize(rows, quant.scale(rows.abs().amax(-1, keepdim=True), quant.X_FLOOR))


def flipped_levels(a: dict, b: dict) -> dict:
    """{tower layer: levels differing} of `b`'s rows against `a`'s row
    nearest to each (tied pairs may take their rows in another order)."""
    out = {}
    for name, parts in b.items():
        ra = torch.cat([p.reshape(-1, p.shape[-1]) for p in a[name]])
        rb = torch.cat([p.reshape(-1, p.shape[-1]) for p in parts])
        near = torch.stack([(ra - row).abs().amax(-1).argmin() for row in rb])
        out[name] = int((int8_levels(ra[near]) != int8_levels(rb)).sum())
    return out


def int8_reference_models() -> dict:
    """Phase 28 (b)'s small f32 models (CPU, random weights): phase 4's
    MotifNet in sgdet and sgcls, and phase 13's Stanford model in sgcls."""
    budgets = C.PadBudgets(max_gt_boxes=8, max_gt_rels=8, rpn_pre_nms_topn_test=720,
                           rpn_post_nms_topn_test=32, objs_per_img=8, max_pairs_eval=32,
                           per_class_nms_topk=16)
    kw = dict(num_classes=12, num_rels=8, embed_dim=16, hidden_dim=24, obj_dim=128,
              pooling_dim=128, nl_obj=2, nl_edge=2, order="leftright", thresh=0.0,
              dtype=torch.float32, budgets=budgets, union_chunk=16, **BENCH_FLAGS)
    models = {"motifnet sgdet": RelModel(mode="sgdet", **kw),
              "motifnet sgcls": RelModel(mode="sgcls", **kw),
              "stanford sgcls": small_stanford("sgcls", budgets)}
    for m in models.values():
        random_init_(m, torch.Generator().manual_seed(SEED))
        if hasattr(m, "context"):   # a 96^2 image's box statistics, as phase 19 sets them
            with torch.no_grad():
                m.context.pos_bn.running_mean.copy_(torch.tensor([48.0, 48.0, 30.0, 30.0]))
                m.context.pos_bn.running_var.copy_(torch.tensor([700.0, 700.0, 300.0, 300.0]))
        m.eval()
    return models


def int8_relations_match(got, exp, what: str) -> tuple:
    """The same valid relation pairs in each image, each pair's scores
    within INT8_SCORE_TOL of the CPU's for that pair (a flipped level may
    reorder triplet scores within that of each other). Returns the rows
    ranked apart and the largest score difference."""
    require(torch.equal(got.rel_valid, exp.rel_valid), f"{what}: rel_valid differ")
    moved, worst = 0, 0.0
    for i, v in enumerate(exp.rel_valid):
        pos = {tuple(p): k for k, p in enumerate(exp.rel_inds[i][v].tolist())}
        pairs = [tuple(p) for p in got.rel_inds[i][v].tolist()]
        require(sorted(pairs) == sorted(pos) and len(pos) == len(pairs),
                f"{what}: image {i}'s relation pairs differ")
        perm = torch.tensor([pos[p] for p in pairs], dtype=torch.long)
        want = exp.rel_scores[i][v][perm]
        torch.testing.assert_close(got.rel_scores[i][v], want, **INT8_SCORE_TOL)
        moved += int((perm != torch.arange(len(perm))).sum())
        worst = max(worst, float((got.rel_scores[i][v] - want).abs().max()))
    return moved, worst


def check_int8_reference(smi: str, dev) -> None:
    """Phase 28 (b), first part: each small model under int8 on the card ==
    on the CPU: decisions equal; scores and boxes within INT8_SCORE_TOL /
    INT8_BOX_TOL; the tower inputs' flipped levels printed."""
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(2, 96, 96, 3, generator=gen) * 0.4
    boxes, classes, mask, _ = small_gt(gen, 2, 96, 12)
    for name, cpu_model in int8_reference_models().items():
        kw = dict(images=images, im_hw=torch.full((2, 2), 96.0))
        if name.endswith("sgcls"):
            kw.update(gt_boxes=boxes, gt_classes=classes, gt_mask=mask)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        rec_cpu, rec_gpu = {}, {}
        hooks = record_tower_inputs(cpu_model, rec_cpu) + record_tower_inputs(gpu_model, rec_gpu)
        try:
            with quant.int8_env(), torch.no_grad():
                exp = cpu_model(**kw)
                got = gpu_model(**{k: v.to(dev) for k, v in kw.items()})
        finally:
            for h in hooks:
                h.remove()
        with torch.no_grad():
            flt = cpu_model(**kw)
        got = type(got)(*(t.cpu() for t in got))
        ov, rv = exp.obj_valid, exp.rel_valid
        require(ov.sum() > 0 and rv.sum() > 0, f"int8-reference {name}: degenerate input")
        require(not torch.equal(flt.rel_scores, exp.rel_scores),
                f"int8-reference {name}: the towers did not take the int8 path")
        for field in ("obj_valid", "rel_valid", "num_valid_pairs"):
            require(torch.equal(getattr(got, field), getattr(exp, field)),
                    f"int8-reference {name}: {field} differ")
        require(torch.equal(got.obj_classes[ov], exp.obj_classes[ov]),
                f"int8-reference {name}: obj_classes differ")
        torch.testing.assert_close(got.obj_scores[ov], exp.obj_scores[ov], **INT8_SCORE_TOL)
        torch.testing.assert_close(got.boxes[ov], exp.boxes[ov], **INT8_BOX_TOL)
        moved, rel_diff = int8_relations_match(got, exp, f"int8-reference {name}")
        diffs = {f: float((getattr(got, f)[ov] - getattr(exp, f)[ov]).abs().max())
                 for f in ("obj_scores", "boxes")}
        diffs["rel_scores"] = rel_diff
        print(f"int8-reference {name}: small f32 model under NM_QUANT=int8 on the card == on "
              f"the CPU ({int(ov.sum())} objects, {int(rv.sum())} relations): decisions equal, "
              f"the same relation pairs ({moved} ranked apart within near ties), "
              f"largest differences {({k: f'{v:.2e}' for k, v in diffs.items()})} (scores "
              f"within {INT8_SCORE_TOL}, boxes {INT8_BOX_TOL}); tower-input int8 levels that "
              f"differ between the devices {flipped_levels(rec_cpu, rec_gpu)}", flush=True)


def check_int8_bench(smi: str, dev) -> dict:
    """Phase 28 (b), second part: the bench config's SGDet model (phase 5)
    under int8: REQUESTS requests with 4 / 1 / 1 / 6 launches each and valid
    predictions; the union tower, the RoI head and the object tower at
    their calls' shapes, and a synced request, int8 against bf16 (CUDA
    events, the median of INT8_TIMING_REPS); then one sgcls eval batch of
    the bench widths, int8 against bf16. Returns the requests' launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = bench_model(dev, gen)
    im = C.IM_SCALE
    budgets = C.PadBudgets()
    images = torch.randn(BATCH, im, im, 3, generator=gen, device=dev) * 0.3
    im_hw = torch.full((BATCH, 2), float(im), device=dev)
    with quant.int8_env(), torch.no_grad():
        model(images, im_hw)
        torch.cuda.synchronize()
        zero_launches()
        for _ in range(REQUESTS):
            pred = model(images, im_hw)
            check_prediction(pred, BATCH, budgets.objs_per_img, budgets.max_pairs_eval,
                             C.VG_NUM_CLASSES, C.VG_NUM_PREDICATES)
        torch.cuda.synchronize()
        launches = count_launches()
    require(tuple(launches.values()) == tuple(REQUESTS * n for n in REQUEST_LAUNCHES),
            f"int8 requests: launches {launches}, expected {REQUEST_LAUNCHES} a request")
    p = 7   # the RoIAlign crops' size
    towers = {"union tower (a chunk)": (model.roi_fmap, model.union_chunk),
              "RoI head": (model.detector.roi_head, budgets.rpn_post_nms_topn_test),
              "object tower": (model.roi_fmap_obj, budgets.objs_per_img)}
    with torch.no_grad():
        for name, (tower, rows) in towers.items():
            x = torch.relu(torch.randn(BATCH, rows, p, p, 512, generator=gen,
                                       device=dev)).bfloat16()
            shapes = [(BATCH * rows, m.in_features, m.out_features) for m in tower.children()
                      if isinstance(m, QuantLinear)]
            t_bf16 = time_ms(lambda: tower(x), INT8_TIMING_REPS)
            with quant.int8_env():
                t_int8 = time_ms(lambda: tower(x), INT8_TIMING_REPS)
            ops = tower_flops(shapes)
            print(f"int8 {name} [{BATCH}, {rows}, {p}, {p}, 512] on {smi}: int8 "
                  f"{t_int8:.4f} ms, bf16 {t_bf16:.4f} ms ({t_bf16 / t_int8:.3f}x); layers "
                  f"{shapes}; bound int8 {ops / PEAK_INT8_OPS_PER_S * 1e3:.4f} ms, bf16 "
                  f"{ops / PEAK_BF16_OPS_PER_S * 1e3:.4f} ms (operations)", flush=True)
        t_bf16 = time_ms(lambda: model(images, im_hw), INT8_TIMING_REPS)
        with quant.int8_env():
            t_int8 = time_ms(lambda: model(images, im_hw), INT8_TIMING_REPS)
        t_bf16_again = time_ms(lambda: model(images, im_hw), INT8_TIMING_REPS)
    print(f"int8 request: {BATCH} images {im}x{im} at the bench widths on {smi}, synced: int8 "
          f"{t_int8:.3f} ms, bf16 {t_bf16:.3f} / {t_bf16_again:.3f} ms (before / after); "
          f"{REQUESTS} requests under int8 valid, launches {launches}", flush=True)
    del model
    torch.cuda.empty_cache()

    with torch.device(dev):
        sgcls = RelModel(num_classes=C.VG_NUM_CLASSES, num_rels=C.VG_NUM_PREDICATES,
                         mode="sgcls", embed_dim=200, hidden_dim=512, pooling_dim=4096,
                         obj_dim=4096, nl_obj=2, nl_edge=4, order="leftright", thresh=0.0,
                         dtype=torch.bfloat16, budgets=budgets, union_chunk=512,
                         **BENCH_FLAGS)
    random_init_(sgcls, gen)
    sgcls.eval()
    boxes, classes, mask, _ = small_gt(torch.Generator().manual_seed(SEED + 28), BATCH, im,
                                       C.VG_NUM_CLASSES, n_obj=8)
    kw = dict(images=images, im_hw=im_hw, gt_boxes=boxes.to(dev), gt_classes=classes.to(dev),
              gt_mask=mask.to(dev))
    with torch.no_grad():
        t_bf16 = time_ms(lambda: sgcls(**kw), INT8_TIMING_REPS)
        with quant.int8_env():
            t_int8 = time_ms(lambda: sgcls(**kw), INT8_TIMING_REPS)
            pred = sgcls(**kw)
    check_prediction(pred, BATCH, 8, pred.rel_inds.shape[1], C.VG_NUM_CLASSES,
                     C.VG_NUM_PREDICATES)
    print(f"int8 sgcls eval batch: {BATCH} images {im}x{im}, 8 GT boxes each, bench widths on "
          f"{smi}, synced: int8 {t_int8:.3f} ms, bf16 {t_bf16:.3f} ms", flush=True)
    del sgcls
    torch.cuda.empty_cache()
    return launches


def unequal_tower_slices(sd: dict) -> dict:
    """The second half of every tower hidden scaled by 8 (fc0's rows and
    bias, fc1's / proj's columns), as tests/test_torch_quant.py sets it:
    a row-split layer's K slices then differ in absmax."""
    sd = {k: v.clone() for k, v in sd.items()}
    for prefix in ("detector.roi_head", "roi_fmap_obj", "roi_fmap"):
        half = sd[f"{prefix}.fc0.weight"].shape[0] // 2
        sd[f"{prefix}.fc0.weight"][half:] *= 8.0
        sd[f"{prefix}.fc0.bias"][half:] *= 8.0
        second = "fc1" if f"{prefix}.fc1.weight" in sd else "proj"
        sd[f"{prefix}.{second}.weight"][:, half:] *= 8.0
    return sd


def check_int8_tp(smi: str, dev) -> None:
    """Phase 28 (c): the tiny sgcls model's eval forward under int8 with its
    towers split over 2 gloo ranks on the card (data 1 x model 2;
    `unequal_tower_slices`) == the one process's bit for bit; the float
    towers' scores differ."""
    t0 = time.time()
    model_kw, vecs, _ = dryrun.tiny_setup(2, mode="sgcls")
    sd = unequal_tower_slices(dryrun.build(model_kw, vecs, "cpu").state_dict())
    spec = dict(kind="tiny", mode="sgcls", num_images=2, state_dict=sd, train=False,
                quant="int8")
    run = dryrun.start_ranks(2, dev, num_model=2, passes=[spec])
    one = dryrun.run_pass(spec, dev)
    flt = dryrun.run_pass(dict(spec, quant=None), dev)
    ranks = [r[0] for r in dryrun.wait_ranks(run, TP_JOIN_TIMEOUT_S)]
    try:
        dryrun.check_ranks(ranks)
    except AssertionError as e:
        require(False, f"tensor-parallel int8: {e}")
    require(not torch.equal(one["pred"]["rel_scores"], flt["pred"]["rel_scores"]),
            "tensor-parallel int8: the towers did not take the int8 path")
    for r in ranks:
        bad = [k for k, v in r["pred"].items() if not torch.equal(v, one["pred"][k])]
        require(not bad, f"tensor-parallel int8: rank {r['rank']}'s {bad} differ from 1 process")
    print(f"tensor-parallel int8: the tiny sgcls eval forward under NM_QUANT=int8, 2 gloo ranks "
          f"(data 1 x model 2) on one {smi}, the row-split layers' K slices of unequal absmax "
          f"== 1 process bit for bit (every prediction field); model-group all-reduces on rank "
          f"0: {tp_reduces(ranks[0])}; {time.time() - t0:.1f} s", flush=True)


def check_int8(smi: str, dev) -> dict:
    """Phase 28: (a)-(c); (d) runs in phase 25. NM_QUANT is set inside each
    check alone (quant.int8_env). It runs beside phase 27's CPU reference,
    its own CPU work on INT8_CPU_THREADS threads. Returns the int8
    requests' launches."""
    t0 = time.time()
    threads = torch.get_num_threads()
    torch.set_num_threads(INT8_CPU_THREADS)
    try:
        check_int8_matmul(smi, dev)
        check_int8_reference(smi, dev)
        launches = check_int8_bench(smi, dev)
        check_int8_tp(smi, dev)
    finally:
        torch.set_num_threads(threads)
    require(quant.quant_mode() == "", "NM_QUANT left set after phase 28")
    print(f"phase 28 (int8 towers): {time.time() - t0:.1f} s", flush=True)
    return {"int8 request": launches}


def check_host_runtime() -> None:
    """Phase 2's host part: the host runtime built from
    neural_motifs_tpu_torch/csrc/host/ (the JPEG library where the compiler
    finds libjpeg), and its resize held to the recorded digest of PIL's,
    to PIL's own output where PIL is installed, and to its plain version."""
    t0 = time.time()
    runtime.lib()
    probe = runtime.jpeg_probe()
    if probe["found"]:
        runtime.jpeg_lib()
    cxx = runtime.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    jpeg = (f"libjpeg found: header {probe['header']}, library {probe['library']}"
            if probe["found"] else
            f"libjpeg not found ({(probe['output'].splitlines() or ['?'])[0]})")
    print(f"host runtime: {cxx} ({version}), {time.time() - t0:.1f} s; {jpeg}", flush=True)
    img = np.random.RandomState(SEED).randint(0, 256, (600, 800, 3)).astype(np.uint8)
    got = runtime.resize_bilinear_u8(img, 444, 592)
    require(hashlib.sha256(got.tobytes()).hexdigest() == RESIZE_DIGEST,
            "host resize: not PIL's recorded output")
    require(np.array_equal(got, runtime.resize_bilinear_u8_plain(img, 444, 592)),
            "host resize: the native resize and its plain version differ")
    against = "the recorded digest of PIL's output"
    try:
        from PIL import Image
    except ImportError:
        against += " (no PIL on this host)"
    else:
        pil = np.asarray(Image.fromarray(img).resize((592, 444), Image.BILINEAR))
        require(np.array_equal(got, pil), "host resize: differs from PIL here")
        against += " and PIL's own here"
    t0 = time.perf_counter()
    for _ in range(10):
        runtime.resize_bilinear_u8(img, 444, 592)
    ms = (time.perf_counter() - t0) * 100
    print(f"host resize: [600, 800, 3] -> [444, 592] byte-identical to {against} and to "
          f"its plain version; {ms:.3f} ms a call (host)", flush=True)


def predict_decode() -> str:
    """How predict decodes the fixtures here, printed on a line of its own:
    the native libjpeg decode where its self-check passed, else PIL (a
    host with neither fails the phase: predict raises and names both)."""
    how = ("native libjpeg" if transforms._native_decode_ok()
           else "PIL (no libjpeg on this host)")
    print(f"decode: {how}", flush=True)
    return how


def run_predict(argv: list, device) -> tuple:
    """predict.main with its output captured: (records, printed text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = predict.main(argv, device=device)
    return records, buf.getvalue()


def check_records(records: list, paths: list, what: str) -> tuple:
    """One record a listed image, in order, at its size; boxes inside the
    image; relations between listed objects; scores in [0, 1] (the checks
    of tests/test_predict.py). Returns (objects, relations)."""
    require([r["file"] for r in records] == list(paths), f"{what}: records != images")
    n_obj = n_rel = 0
    for r in records:
        h, w = transforms.image_size(r["file"])
        require((r["height"], r["width"]) == (h, w), f"{what}: {r['file']} size")
        ids = {o["id"] for o in r["objects"]}
        for o in r["objects"]:
            x1, y1, x2, y2 = o["box"]
            require(0 <= x1 <= x2 <= w + 1e-3 and 0 <= y1 <= y2 <= h + 1e-3,
                    f"{what}: box {o['box']} outside {w}x{h}")
            require(0.0 <= o["score"] <= 1.0, f"{what}: object score {o['score']}")
        for rel in r["relations"]:
            require(rel["subject"] in ids and rel["object"] in ids,
                    f"{what}: relation of an unlisted object")
            require(0.0 <= rel["score"] <= 1.0, f"{what}: relation score {rel['score']}")
        n_obj, n_rel = n_obj + len(r["objects"]), n_rel + len(r["relations"])
    return n_obj, n_rel


def check_predict_reference() -> None:
    """Phase 22, in a process of its own at NM_TPU_IM_SCALE=128:
    tools/predict.py with a small f32 sgdet model (phase 6's widths, its
    position statistics from StructuredSyntheticVG boxes, the detector's
    class biases spread) from one -ckpt, over the committed fixtures with
    -b 2 -im_budget auto, on the CPU (plain versions) and on the card
    (kernels): the same record for each file, the same object ids and
    labels, the same relation order, boxes and scores within rtol 1e-3 /
    atol 1e-4."""
    require(C.IM_SCALE == PREDICT_REF_SCALE, "predict-reference needs NM_TPU_IM_SCALE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    how = predict_decode()
    paths = [os.path.join(PREDICT_DIR, n) for n, _, _ in PREDICT_FIXTURES]
    argv = ["-m", "sgdet", *SMALL_ARGS, "-im_budget", "auto"]
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            cfg = C.ModelConfig.from_args(argv)
            taxonomy = predict.load_taxonomy(None)
        model = build_model(cfg, taxonomy, "cpu", torch.Generator().manual_seed(SEED))
        set_position_stats_(model, StructuredSyntheticVG(num_images=8, seed=SEED,
                                                         im_size=C.IM_SCALE))
        spread_class_biases_(model.detector, torch.Generator().manual_seed(SEED + 5))
        ckpt = os.path.join(tmp, "small.pt")
        torch.save(model.state_dict(), ckpt)
        runs = [run_predict(argv + ["-ckpt", ckpt, "-images", *paths,
                                    "-out", os.path.join(tmp, f"{i}.json")], where)[0]
                for i, where in enumerate(("cpu", "cuda"))]
    exp, got = runs
    n_obj, n_rel = check_records(got, paths, "predict-reference")
    require(n_obj > 0 and n_rel > 0, "predict-reference: no objects or relations")
    box_gap = score_gap = 0.0
    for g, e in zip(got, exp):
        require([(o["id"], o["label"]) for o in g["objects"]]
                == [(o["id"], o["label"]) for o in e["objects"]],
                f"predict-reference: objects of {g['file']} differ")
        require([(r["subject"], r["object"], r["predicate"]) for r in g["relations"]]
                == [(r["subject"], r["object"], r["predicate"]) for r in e["relations"]],
                f"predict-reference: relations of {g['file']} differ")
        for key, row in (("objects", "box"), ("objects", "score"), ("relations", "score")):
            a = np.array([o[row] for o in g[key]], np.float64)
            b = np.array([o[row] for o in e[key]], np.float64)
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=f"{g['file']} {row}")
            gap = float(np.abs(a - b).max()) if a.size else 0.0
            if row == "box":
                box_gap = max(box_gap, gap)
            else:
                score_gap = max(score_gap, gap)
    print(f"predict-reference: card == CPU for tools/predict.py over the {len(paths)} "
          f"fixtures at {C.IM_SCALE} px (-b 2 -im_budget auto, decode {how}): {n_obj} "
          f"objects, {n_rel} relations, ids, labels and relation order identical; boxes "
          f"within {box_gap:.2e} px, scores within {score_gap:.2e}", flush=True)


def predict_reference_subprocess() -> None:
    """Phase 22 in a process of its own (the IM_SCALE hook is read at
    import); its lines are printed here."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--predict-reference"],
                          env=dict(os.environ, NM_TPU_IM_SCALE=str(PREDICT_REF_SCALE)),
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"predict-reference failed ({proc.returncode}):\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for ln in proc.stdout.splitlines():
        if ln.startswith("predict-reference"):
            print(f"{ln}; the phase {time.time() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def predecoded(paths: list):
    """predict's ImageFolder with every image of `paths` decoded and
    resized before the run: its decode returns the cached pixels and its
    resize the cached result, so a run's time leaves both out."""
    pixels = {p: transforms.decode_image_rgb(p) for p in set(paths)}
    resized = {id(a): transforms.square_pad_resize(a) for a in pixels.values()}
    saved = predict.decode_image_rgb, predict.square_pad_resize
    predict.decode_image_rgb = pixels.__getitem__
    predict.square_pad_resize = lambda a: resized[id(a)]
    try:
        yield
    finally:
        predict.decode_image_rgb, predict.square_pad_resize = saved


@contextlib.contextmanager
def split_batches(split: dict, profile: bool = False):
    """eval_rels.run_batches, as predict.main calls it, timed by part on the
    host's clock and summed into `split`: `loader`, the wait for the
    loader's next batch (its thread decodes, resizes and collates);
    `forward`, the model's call (the eager dispatch, with the syncs inside
    it); `consume`, the caller's records; `other`, the rest of the loop (the
    host-to-device copies one batch ahead, the wait for each batch's
    device-to-host copies); `wall`, the whole loop; `batches`. With
    `profile`, `device` is the loop's device time (torch.profiler: every
    kernel and copy)."""
    orig = eval_rels.run_batches

    class TimedLoader:
        def __init__(self, loader):
            self.loader = loader

        def __iter__(self):
            it = iter(self.loader)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                split["loader"] += time.perf_counter() - t0
                if batch is None:
                    return
                split["batches"] += 1
                yield batch

    def run(model, loader, device, consume, **kw):
        marks = []
        hooks = [model.register_forward_pre_hook(lambda *_: marks.append(time.perf_counter())),
                 model.register_forward_hook(lambda *_: marks.append(time.perf_counter()))]

        def timed_consume(*args):
            t0 = time.perf_counter()
            consume(*args)
            split["consume"] += time.perf_counter() - t0

        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof:
            orig(model, TimedLoader(loader), device, timed_consume, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
        split["wall"] += time.perf_counter() - t0
        for h in hooks:
            h.remove()
        split["forward"] += sum(marks[1::2]) - sum(marks[0::2])
        if profile:
            split["device"] += sum(
                (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0)) / 1e6
                for e in prof.key_averages())

    for key in ("loader", "forward", "consume", "wall", "batches", "device"):
        split.setdefault(key, 0.0)
    eval_rels.run_batches = run
    try:
        yield split
    finally:
        eval_rels.run_batches = orig
    split["other"] = split["wall"] - split["loader"] - split["forward"] - split["consume"]


def predict_rate(text: str) -> tuple:
    """predict's timing lines: (run seconds, img/s, decode + resize ms an
    image, images decoded; 0 where the run decoded none)."""
    rate = re.search(r"\[predict\] (\d+) images in ([\d.]+) s, ([\d.]+) img/s", text)
    require(rate, "predict printed no timing line")
    dec = re.search(r"decode \+ resize: ([\d.]+) ms an image over (\d+) images", text)
    return (float(rate.group(2)), float(rate.group(3)),
            float(dec.group(1)) if dec else 0.0, int(dec.group(2)) if dec else 0)


def split_ms(split: dict) -> str:
    """A run's loop split, in ms a batch."""
    n = split["batches"]
    return ", ".join(f"{k} {1e3 * split[k] / n:.1f}"
                     for k in ("wall", "loader", "forward", "consume", "other"))


def check_predict(smi: str) -> dict:
    """Phase 23: tools/predict.py at the published widths (-m sgdet -b 4
    -im_budget auto, bench-width weights from the seed with the detector's
    class biases spread) over PREDICT_IMAGES images after a warm-up run:
    images/s end to end, the decode + resize share, the launches (K1 4, K2
    and K3 1, K4 6 a batch), peak memory, every record checked; the rate with and
    without the decode (PREDICT_ROUNDS runs each, interleaved), each run's
    loop split, the busy share; then NM_FAST_DECODE=1 on the large fixture.
    Returns its launches."""
    predict_decode()
    t_phase = time.time()
    fixtures = [os.path.join(PREDICT_DIR, n) for n, _, _ in PREDICT_FIXTURES]
    timed = [fixtures[i % len(fixtures)] for i in range(PREDICT_IMAGES)]
    argv = ["-m", "sgdet", *PUBLISHED_ARGS, "-im_budget", "auto"]
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = C.ModelConfig.from_args(argv)
    batches = len(Loader(predict.ImageFolder(timed), cfg.batch_size, shuffle=False,
                         drop_last=False, **loader_im_kw(cfg)))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench.pt")
        with contextlib.redirect_stdout(io.StringIO()):
            init_ckpt(ckpt, argv, predict.load_taxonomy(None), spread=True)
        argv += ["-ckpt", ckpt, "-out", os.path.join(tmp, "predictions.json")]
        t0 = time.perf_counter()
        records, _ = run_predict(argv + ["-images", *fixtures], "cuda")   # warm-up
        warm_s = time.perf_counter() - t0
        check_records(records, fixtures, "predict warm-up")
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with split_batches({}) as split:
            records, text = run_predict(argv + ["-images", *timed], "cuda")
        call_s = time.perf_counter() - t0
        launches = count_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_obj, n_rel = check_records(records, timed, "predict")
        # the rate with and without the decode, runs interleaved (the
        # counted run is the first decoded one), then one decoded run
        # profiled for the device's busy share
        runs = {"decoded": [(predict_rate(text), split)], "pre-decoded": []}
        for i in range(PREDICT_ROUNDS):
            with predecoded(timed), split_batches({}) as split:
                _, text = run_predict(argv + ["-images", *timed], "cuda")
            runs["pre-decoded"].append((predict_rate(text), split))
            if i + 1 < PREDICT_ROUNDS:
                with split_batches({}) as split:
                    _, text = run_predict(argv + ["-images", *timed], "cuda")
                runs["decoded"].append((predict_rate(text), split))
        with split_batches({}, profile=True) as traced:
            run_predict(argv + ["-images", *timed], "cuda")
        large = fixtures[-1]
        os.environ["NM_FAST_DECODE"] = "1"
        try:
            dims = transforms.decoded_dims(*transforms.image_size(large))
            img = predict.decode_image_rgb(large)
            require(tuple(img.shape[:2]) == dims,
                    f"predict fast-decode: decoded {img.shape[:2]}, decoded_dims {dims}")
            data = predict.ImageFolder([large])
            loader = Loader(data, 1, shuffle=False, drop_last=False, **loader_im_kw(cfg))
            hw = loader._resized_hw()
            bucket = tuple(C.DEFAULT_IM_BUCKETS[int(loader._bucket_of(hw)[0])])
            with contextlib.redirect_stdout(io.StringIO()):
                batch = loader.peek()
            require(tuple(batch.images.shape[1:3]) == bucket,
                    f"predict fast-decode: collated {batch.images.shape[1:3]}, bucket {bucket}")
            fast, _ = run_predict(argv + ["-images", large], "cuda")
            check_records(fast, [large], "predict fast-decode")
        finally:
            os.environ.pop("NM_FAST_DECODE")
    expected = tuple(batches * n for n in PREDICT_BATCH_LAUNCHES)
    require(tuple(launches.values()) == expected,
            f"predict: launches {launches}, expected {expected} ({batches} batches)")
    run_s, img_s, decode_ms, decoded = runs["decoded"][0][0]
    share = decode_ms * decoded / (run_s * 1e3)
    print(f"predict: {len(timed)} images (the {len(fixtures)} fixtures listed repeatedly) at "
          f"the published widths, -b 4 -im_budget auto, {batches} batches, after a warm-up "
          f"run of {len(fixtures)} ({warm_s:.1f} s with its model build) on {smi}: "
          f"{img_s:.3f} img/s end to end on the host clock ({run_s:.3f} s: "
          f"decode, resize, collate, model, JSON; the call {call_s:.3f} s with its model "
          f"build and -ckpt load); {n_obj} objects, {n_rel} relations; peak memory "
          f"{peak:.2f} GiB; launches {launches}", flush=True)
    print(f"predict decode: {decode_ms:.3f} ms an image to decode and resize over {decoded} "
          f"images (the loader's thread, beside the model), {share:.3f} of the run's wall "
          f"time", flush=True)
    summary = {}
    for kind, got in runs.items():
        rates = [r[0][1] for r in got]
        med = statistics.median(rates)
        mid = sorted(got, key=lambda r: r[1]["wall"])[len(got) // 2][1]
        summary[kind] = dict(rates=rates, median=med, spread=(max(rates) - min(rates)) / med,
                             wall_ms=1e3 * mid["wall"] / mid["batches"])
        print(f"predict {kind}: {len(rates)} runs {[round(r, 3) for r in rates]} img/s, median "
              f"{med:.3f}, spread {summary[kind]['spread']:.3f} of the median; the loop a "
              f"batch (the median run, ms): {split_ms(mid)}", flush=True)
    dev_ms = 1e3 * traced["device"] / traced["batches"]
    busy = dev_ms / summary["decoded"]["wall_ms"] if traced["device"] else None
    print(f"predict busy share: device time (kernels and copies, torch.profiler) "
          f"{dev_ms:.1f} ms a batch of a profiled decoded run (its loop {split_ms(traced)}) "
          f"over the decoded runs' median loop {summary['decoded']['wall_ms']:.1f} ms a batch: "
          f"{fmt_ms(busy)}; without the decode "
          f"{summary['pre-decoded']['median'] / summary['decoded']['median']:.3f}x the rate",
          flush=True)
    print(f"predict fast-decode: NM_FAST_DECODE=1 on large.jpg 960x1280: decoded at {dims}"
          + ("" if transforms._native_decode_ok() else " (full size: no native decode here)")
          + f", resized to {tuple(int(v) for v in hw[0])}, collated into its bucket {bucket}; "
          f"the phase {time.time() - t_phase:.1f} s", flush=True)
    return {"predict": launches}


# phase 25: the learning proof (tools/train_synth.py) and the training and
# precision tools. (a) every stage of train_synth at the full scale, its
# step counts cut to SYNTH_WARMUP + SYNTH_TIMED (the trunk warm-up's too);
# the plateau recipe takes SYNTH_PLATEAU_STEPS (chunks of 2: at least 8
# chunks, each calibrated and evaluated, run before its early exit)
SYNTH_STAGES = ("det", "sgcls", "sgdet", "stanford", "stanford-sgdet", "sgcls-plateau")
SYNTH_WARMUP, SYNTH_TIMED = 2, 10
SYNTH_PLATEAU_STEPS = 16
# the launches (K1, K2, K3, K1's backward, K4: KERNELS' order) of one unit of
# each part of a stage at the full scale (batch 8, 592^2): a trunk warm-up
# step (gtbox: K1 and its backward); a detector train step (rpntrain: K1,
# K3 over 12 000 anchors, K1's backward); a heldout mAP batch (K1, K2 over
# 1 000 RoIs, K3); a relation model's train step, calibration forward (its
# training forward) and eval batch: in sgcls K1 for the detector's RoIs,
# the objects and the unions (one chunk: 16 x 15 pairs an image); in sgdet
# the RPN's K3 and the decode's K2 too, and 8 union chunks of 64 x 63
# pairs in eval (Stanford's decode runs K3's lanes as well); MotifNet's
# calibration forward (no_grad) and eval batch run K4 on its 2 + 2 LSTM
# layers. Checked exactly against each stage's parts.
SYNTH_UNITS = {
    "det": {"trunk_warmup": (1, 0, 0, 1, 0), "train_loop": (1, 0, 1, 1, 0),
            "detector_map50": (1, 1, 1, 0, 0)},
    "motifnet sgcls": {"train_loop": (3, 0, 0, 0, 0), "calibrate_batch_stats": (3, 0, 0, 0, 4),
                       "eval_recall": (3, 0, 0, 0, 4)},
    "motifnet sgdet": {"train_loop": (3, 1, 1, 0, 0), "calibrate_batch_stats": (3, 1, 1, 0, 4),
                       "eval_recall": (10, 1, 1, 0, 4)},
    "stanford sgcls": {"train_loop": (3, 0, 0, 0, 0), "calibrate_batch_stats": (3, 0, 0, 0, 0),
                       "eval_recall": (3, 0, 0, 0, 0)},
    "stanford sgdet": {"train_loop": (3, 1, 1, 0, 0), "calibrate_batch_stats": (3, 1, 1, 0, 0),
                       "eval_recall": (10, 1, 2, 0, 0)},
}
SYNTH_PARTS = ("trunk_warmup", "train_loop", "calibrate_batch_stats", "eval_recall",
               "detector_map50")
# (b) the JAX test's bars at --scale tiny (tests/test_train_synth.py), and
# what the JAX tool itself reached with them on a CPU (tools/train_synth.py
# --scale tiny --platform cpu --stages det,sgcls): its mAP misses its own
# bar, and the heldout recall over 8 scenes spans 0-25 between runs, so
# those two bars are reported and not required (ROADMAP Queue 3); the
# train recall bar is required, with a detector above a random one's
TINY_BARS = dict(map50=0.3, train_r20=60.0, heldout_r20=20.0)
JAX_TINY = dict(map50=0.1226, train_r20=94.55, heldout_r20=25.0)
OVERFIT_STEPS = 40   # (c)


@contextlib.contextmanager
def synth_parts():
    """Within: each call of one of train_synth's SYNTH_PARTS adds its
    launches (synced after it) and its units (steps, or batches) to the
    record, and every train step that train_synth builds is synced and
    timed (`step_s`)."""
    rec = dict(launches=collections.defaultdict(lambda: np.zeros(len(KERNELS), np.int64)),
               units=collections.Counter(), seconds=collections.Counter(), step_s=[])
    real = {name: getattr(train_synth, name) for name in SYNTH_PARTS + ("make_train_step",)}
    units_of = {"trunk_warmup": lambda a: a[2], "train_loop": lambda a: a[2],
                "calibrate_batch_stats": lambda a: len(a[1]),
                "eval_recall": lambda a: len(a[1]),
                "detector_map50": lambda a: len(a[1].heldout)}

    def counted(name):
        def wrap(*args, **kw):
            before = np.array(list(count_launches().values()))
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            rec["seconds"][name] += time.perf_counter() - t0
            rec["launches"][name] += np.array(list(count_launches().values())) - before
            rec["units"][name] += units_of[name](args)
            return out
        return wrap

    def timed_train_step(*args, **kw):
        step = real["make_train_step"](*args, **kw)

        def timed(*sargs, **skw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*sargs, **skw)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            return out
        return timed

    for name in SYNTH_PARTS:
        setattr(train_synth, name, counted(name))
    train_synth.make_train_step = timed_train_step
    try:
        yield rec
    finally:
        for name, fn in real.items():
            setattr(train_synth, name, fn)


def synth_unit_key(stage: str) -> str:
    if stage == "det":
        return "det"
    model = "stanford" if stage.startswith("stanford") else "motifnet"
    return f"{model} {'sgdet' if stage.endswith('sgdet') else 'sgcls'}"


def synth_full_steps(stage: str, full: dict) -> int:
    return {"det": full["det_steps"], "sgdet": full["sgdet_steps"],
            "stanford": full["stanford_steps"],
            "stanford-sgdet": full["sgdet_steps"]}.get(stage, full["rel_steps"])


def check_synth_stages(smi: str) -> dict:
    """Phase 25 (a): every train_synth stage at the full scale through
    run_stage, the stages' weights handed on as main hands them, the step
    counts cut. Each stage's launches are the sum of its parts' and each
    part's are its units x SYNTH_UNITS; its losses finite, its R@K in [0,
    100] and mAP in [0, 1] (no bar: a few steps of random weights). Prints
    s/step over SYNTH_TIMED synced steps after SYNTH_WARMUP, peak memory and
    the full stage's projected time. Returns the stages' launches by path."""
    full = train_synth.scale_cfg("full")
    sc = dict(full, warmup_steps=SYNTH_WARMUP + SYNTH_TIMED,
              det_steps=SYNTH_WARMUP + SYNTH_TIMED, rel_steps=SYNTH_WARMUP + SYNTH_TIMED,
              sgdet_steps=SYNTH_WARMUP + SYNTH_TIMED, stanford_steps=SYNTH_WARMUP + SYNTH_TIMED)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        data = train_synth.prepare_data(sc, "cuda")
    print(f"train_synth full: {len(data.train)} + {len(data.heldout)} batches of "
          f"{sc['batch']} images {sc['im']}x{sc['im']} rendered and copied to the card "
          f"in {time.time() - t0:.1f} s", flush=True)
    weights, paths = {}, {}
    for stage in SYNTH_STAGES:
        stage_sc = dict(sc, rel_steps=SYNTH_PLATEAU_STEPS) if stage == "sgcls-plateau" else sc
        name = f"train_synth {stage}"
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with synth_parts() as rec, contextlib.redirect_stdout(io.StringIO()):
            model, rep = train_synth.run_stage(stage, stage_sc, data, weights, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = paths[name] = count_launches()
        got = np.array(list(launches.values()))
        parts = {part: tuple(int(x) for x in n) for part, n in rec["launches"].items()}
        require(np.array_equal(sum(rec["launches"].values()), got),
                f"{name}: launches {launches} outside its parts {parts}")
        units = SYNTH_UNITS[synth_unit_key(stage)]
        for part, n in parts.items():
            want = tuple(rec["units"][part] * np.array(units[part]))
            require(n == want, f"{name}: {part} launched {n} over {rec['units'][part]} "
                               f"units, expected {want}")
        losses = rep["final_losses"]
        require(all(math.isfinite(v) for v in losses.values()), f"{name}: {losses}")
        if stage == "det":
            require(0.0 <= rep["heldout_map50"] <= 1.0, f"{name}: mAP {rep['heldout_map50']}")
            quality = f"heldout mAP@0.5 {rep['heldout_map50']}"
        else:
            for key in ("recall_train", "recall_heldout"):
                require(all(0.0 <= v <= 100.0 for v in rep[key].values()), f"{name}: {rep}")
            quality = f"R@20/50/100 train {rep['recall_train']}, heldout {rep['recall_heldout']}"
        timed = rec["step_s"][SYNTH_WARMUP:SYNTH_WARMUP + SYNTH_TIMED]
        require(len(timed) == SYNTH_TIMED, f"{name}: {len(rec['step_s'])} steps")
        s_step = statistics.mean(timed)
        steps = synth_full_steps(stage, full)
        projected = steps * s_step
        warm = ""
        if stage == "det":
            # the warm-up's first calls set the trunk's convolutions up, so
            # its steps are projected at the train step's rate
            projected += full.get("warmup_steps", 400) * s_step
            warm_s = rec["seconds"]["trunk_warmup"] / rec["units"]["trunk_warmup"]
            warm = f", the trunk warm-up {warm_s:.4f} s/step with its first calls' set-up"
        rest = wall - rec["seconds"]["train_loop"]
        print(f"{name}: {rec['units']['train_loop']} steps of {sc['batch']} images "
              f"{sc['im']}x{sc['im']} on {smi}: {s_step:.4f} s/step over {SYNTH_TIMED} synced "
              f"steps after {SYNTH_WARMUP} (median {statistics.median(timed):.4f}, min "
              f"{min(timed):.4f}, max {max(timed):.4f}){warm}; peak memory {peak:.2f} GiB; "
              f"the full stage's {steps} steps projected at {projected / 60:.1f} min; the "
              f"stage {wall:.1f} s, {rest:.1f} s of it outside the train steps "
              f"(calibration, evaluation, building); launches {launches}, by part "
              f"{parts} over units {dict(rec['units'])}; last losses {losses}; {quality}",
              flush=True)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if stage in ("det", "sgcls", "stanford"):
            weights[stage] = sd
        del model, sd
        torch.cuda.empty_cache()
    return paths


def check_synth_tiny(smi: str) -> dict:
    """Phase 25 (b): train_synth.main at --scale tiny, stages det and sgcls
    at their full step counts (400 + 300 detector, 600 relation steps),
    against the JAX test's bars (TINY_BARS): the train recall bar required,
    the heldout mAP above a random detector's (0.02), each bar's verdict
    printed beside what the JAX tool reached (JAX_TINY)."""
    t0 = time.time()
    zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rep = train_synth.main(["--scale", "tiny", "--stages", "det,sgcls", "--no-assert",
                                    "--out", os.path.join(tmp, "tiny.json"),
                                    "--save-dir", os.path.join(tmp, "ckpt")], device="cuda")
    launches = count_launches()
    for ln in buf.getvalue().splitlines():
        if ln.startswith(("# [det/warmup] step 399", "# [det/warmup] 400", "# [det] step 299",
                          "# [det] 300", "# [det] heldout", "# [motifnet/sgcls] step 599",
                          "# [motifnet/sgcls] 600", "# [motifnet/sgcls] train R@K")):
            print(f"  {ln}", flush=True)
    det, sg = rep["stages"]["det"], rep["stages"]["sgcls"]
    got = dict(map50=det["heldout_map50"], train_r20=sg["recall_train"][20],
               heldout_r20=sg["recall_heldout"][20])
    require(got["train_r20"] >= TINY_BARS["train_r20"] and got["map50"] > 0.02,
            f"train_synth tiny: {got} against {TINY_BARS}")
    verdict = {k: "held" if (got[k] > v if k == "map50" else got[k] >= v) else "MISSED"
               for k, v in TINY_BARS.items()}
    print(f"train_synth tiny: det + sgcls through main on {smi}: heldout mAP@0.5 "
          f"{got['map50']} (bar > {TINY_BARS['map50']}: {verdict['map50']}), sgcls train "
          f"R@20 {got['train_r20']} (bar >= {TINY_BARS['train_r20']}: {verdict['train_r20']}), "
          f"heldout R@20 {got['heldout_r20']} (bar >= {TINY_BARS['heldout_r20']}: "
          f"{verdict['heldout_r20']}); the JAX tool on a CPU {JAX_TINY}; launches "
          f"{launches}; {time.time() - t0:.1f} s", flush=True)
    return {"train_synth tiny": launches}


def check_overfit(smi: str) -> dict:
    """Phase 25 (c): overfit_smoke for MotifNet and Stanford sgcls,
    OVERFIT_STEPS steps each: the loss must drop (the tool raises)."""
    paths = {}
    for model_name in ("motifnet", "stanford"):
        t0 = time.time()
        zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            losses = overfit_smoke.main(OVERFIT_STEPS, "sgcls", model_name, device="cuda")
        launches = paths[f"overfit {model_name}"] = count_launches()
        print(f"overfit {model_name} sgcls: {OVERFIT_STEPS} steps on {smi}: loss "
              f"{statistics.mean(losses[:5]):.4f} -> {statistics.mean(losses[-5:]):.4f} "
              f"(first five -> last five, must fall below 0.8x); launches {launches}; "
              f"{time.time() - t0:.1f} s", flush=True)
    return paths


def check_precision_audit(smi: str) -> dict:
    """Phase 25 (d): precision_audit --int8 at the published widths on
    random weights (--det-steps 0 --train-steps 0 --n-batches 1: the
    conservative near-tie case): the flip rates and the R@K deltas of sgcls
    and sgdet, bf16 against f32 and int8 against bf16."""
    t0 = time.time()
    zero_launches()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        art = precision_audit.main(["--det-steps", "0", "--train-steps", "0", "--n-batches",
                                    "1", "--int8", "--out", os.path.join(tmp, "audit.json")],
                                   device="cuda")
    launches = count_launches()
    require(quant.quant_mode() == "", "precision_audit left NM_QUANT set")
    for m in art["modes"]:
        d, c, q = m["bf16_vs_f32"], m["chaos_control_f32_vs_f32perturbed"], m["int8_vs_bf16"]
        require(d["images"] == 8 and all(math.isfinite(v) for v in m["recall_delta_pts"].values()),
                f"precision_audit {m['mode']}: {m}")
        require(q["images"] == 8 and set(m["int8_recall_delta_pts"]) == set(m["recall_delta_pts"])
                and all(math.isfinite(v) for v in m["int8_recall_delta_pts"].values()),
                f"precision_audit {m['mode']}: the int8 keys {m}")
        print(f"precision_audit {m['mode']} (random weights, 8 images, published widths) on "
              f"{smi}: bf16 vs f32 NMS keep flips {d['nms_keep_flip_rate']:.4f}, decoder "
              f"commit flips {d['decoder_commit_flip_rate']:.4f}, top-K triplet Jaccard "
              f"{d['topk_triplet_jaccard_mean']}; chaos control {c['nms_keep_flip_rate']:.4f} / "
              f"{c['decoder_commit_flip_rate']:.4f} / {c['topk_triplet_jaccard_mean']}; R@K "
              f"delta {m['recall_delta_pts']} (chaos {m['chaos_recall_delta_pts_per_seed']}, "
              f"inside {m['bf16_delta_inside_chaos_envelope']}); int8 vs bf16 NMS keep flips "
              f"{q['nms_keep_flip_rate']:.4f}, decoder commit flips "
              f"{q['decoder_commit_flip_rate']:.4f}, top-K triplet Jaccard "
              f"{q['topk_triplet_jaccard_mean']}, R@K delta {m['int8_recall_delta_pts']}",
              flush=True)
    print(f"precision_audit: {time.time() - t0:.1f} s, launches {launches}", flush=True)
    return {"precision_audit": launches}


def check_learning_proof(smi: str) -> dict:
    """Phase 25: (a)-(d); returns the launches by path."""
    t0 = time.time()
    paths = check_synth_stages(smi)
    paths.update(check_synth_tiny(smi))
    paths.update(check_overfit(smi))
    paths.update(check_precision_audit(smi))
    print(f"phase 25 (learning proof): {time.time() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 26: the parity runbook and the dress rehearsal
# (neural_motifs_tpu_torch/tools/parity_runbook.py, dress_rehearsal.py)
# ---------------------------------------------------------------------------

RUNBOOK_MODES = ("predcls", "sgcls", "sgdet")
# (a): (mode, -proposals); sgdet over proposals around the GT, then through
# the random reference detector's RPN, whose boxes (BOX_SCALE units) agree
# within RUNBOOK_RPN_BOX_ATOL between card and CPU: 9.5e-3 measured (NVIDIA
# H100 80GB HBM3, 700 W), the gap of the f32 convolutions summed in another
# order
RUNBOOK_REFERENCE_RUNS = (("predcls", False), ("sgcls", False), ("sgdet", True),
                          ("sgdet", False))
RUNBOOK_RPN_BOX_ATOL = 2e-2
RUNBOOK_IMAGES = 16   # (b): the -test split a mode, 3 batches at the canonical -b 6
# (b)'s launches (K1, K2, K3, K1's backward, K4) a batch at the canonical
# flags (-max_pairs_eval 4096: every pair scored): predcls and sgcls
# RoIAlign the objects and the union chunks; sgdet runs the RPN's NMS and
# filter_det too; K4 on the 6 LSTM layers
RUNBOOK_BATCH_LAUNCHES = {"predcls": (10, 0, 0, 0, 6), "sgcls": (10, 0, 0, 0, 6),
                          "sgdet": (10, 1, 1, 0, 6)}
DRESS_STEPS = 200   # (c): the dress rehearsal's train stage
DRESS_STEP_LAUNCHES = (3, 0, 0, 0, 0)
# (c)'s steps are cut only where the phase would outlast it (90 s since
# phase 28 was added: the script keeps its margin under the 1200 s limit)
PHASE26_BUDGET_S = 90


@contextlib.contextmanager
def runbook_evals():
    """Within: every eval_rels.main call (the runbook makes one a mode)
    starts with the kernels' counts at 0 and records (mode, evaluator,
    launches) just after it."""
    rec = []
    real = eval_rels.main

    def main(argv=None, datasets=None, device="cuda"):
        zero_launches()
        ev = real(argv, datasets=datasets, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        rec.append((argv[argv.index("-m") + 1], ev, count_launches()))
        return ev

    eval_rels.main = main
    try:
        yield rec
    finally:
        eval_rels.main = real


@contextlib.contextmanager
def rpn_path():
    """Within: what the sgdet path decides on the way, a dict of lists of
    host arrays: "keeps", the anchors each rpn_proposals call keeps through
    K3's NMS at 0.7, an index array an image in score order; "orders", each
    sort_by_order call's (boxes [B,O,4], valid [B,O], perm [B,O]); "boxes",
    the object boxes [B,O,4] that each rel_pairs call (one a batch) filters
    for overlap."""
    rec = {"keeps": [], "orders": [], "boxes": []}
    real = detector_mod.nms_topk, context_mod.sort_by_order, rel_model_mod.rel_pairs

    def nms_topk(boxes, scores, valid, iou_thresh, pre_topn, post_topn):
        idx, ok = real[0](boxes, scores, valid, iou_thresh, pre_topn, post_topn)
        rec["keeps"].extend(i[k] for i, k in zip(idx.cpu().numpy(), ok.cpu().numpy()))
        return idx, ok

    def sort_by_order(order, obj_dists, boxes, valid, draws=None):
        out = real[1](order, obj_dists, boxes, valid, draws)
        rec["orders"].append(tuple(t.detach().cpu().numpy() for t in (boxes, valid, out[0])))
        return out

    def rel_pairs(det, budget, require_overlap):
        rec["boxes"].append(det.rm_boxes.detach().cpu().numpy())
        return real[2](det, budget, require_overlap)

    detector_mod.nms_topk, context_mod.sort_by_order, rel_model_mod.rel_pairs = (
        nms_topk, sort_by_order, rel_pairs)
    try:
        yield rec
    finally:
        detector_mod.nms_topk, context_mod.sort_by_order, rel_model_mod.rel_pairs = real


@contextlib.contextmanager
def plain_nms():
    """Within: K2 and K3 replaced by their plain versions, on any device."""
    real = nms.greedy_nms_mask, nms.perclass_nms
    nms.greedy_nms_mask, nms.perclass_nms = nms._greedy_nms_plain, nms._perclass_nms_plain
    try:
        yield
    finally:
        nms.greedy_nms_mask, nms.perclass_nms = real


def box_gap(exp: list, got: list) -> float:
    """The largest gap between two runs' boxes of valid objects."""
    return max(float(np.abs(g["pred_boxes"][e["obj_valid"]]
                            - e["pred_boxes"][e["obj_valid"]]).max(initial=0.0))
               for g, e in zip(got, exp))


def runbook_run(tar: str, mode: str, extra: list, splits, where, out: str, nms_plain=False):
    """One parity_runbook.main call in `mode` on `where`: (exit code,
    payload, result_dict, cached entries, `rpn_path`'s record, launches)."""
    cache = out.replace(".json", ".pkl")
    argv = ["--sgcls-ckpt", tar, "--sgdet-ckpt", tar, "--modes", mode, "--out", out,
            "--extra-args", *extra, "-cache", cache]
    with contextlib.ExitStack() as stack:
        if nms_plain:
            stack.enter_context(plain_nms())
        path = stack.enter_context(rpn_path())
        rec = stack.enter_context(runbook_evals())
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        rc = parity_runbook.main(argv, datasets=splits, device=where)
    with open(out) as f, open(cache, "rb") as g:
        return rc, json.load(f), rec[0][1].result_dict, pickle.load(g), path, rec[0][2]


def near_tie_images(what: str, exp_path: dict, got_path: dict, exp: list, got: list) -> set:
    """The images where the card decided otherwise than the CPU at a near
    tie that the two sides' box gap explains: the leftright order places
    objects differently only where their centres on the CPU are within
    twice the image's largest box shift, and the overlapping pairs differ
    only where a pair's overlap (min of the +1-convention width and
    height) on the CPU is within twice that shift of 0. Fails on any other
    difference."""
    flipped = set()
    n_batches = len(exp_path["boxes"])
    require(len(got_path["orders"]) == len(exp_path["orders"]) and len(got_path["boxes"])
            == n_batches and sum(map(len, exp_path["boxes"])) == len(exp),
            f"{what}: the two sides ran different batches")
    calls = len(exp_path["orders"]) // n_batches   # sort_by_order calls a batch
    first = np.cumsum([0] + [len(b) for b in exp_path["boxes"]])
    for c, ((eb, ev, ep), (gb, gv, gp)) in enumerate(zip(exp_path["orders"],
                                                         got_path["orders"])):
        img = first[c // calls]
        for j in range(len(ep)):
            require(np.array_equal(ev[j], gv[j]), f"{what}: valid objects differ")
            moved = np.flatnonzero(ep[j] != gp[j])
            if len(moved):
                shift = float(np.abs(eb[j][ev[j]] - gb[j][gv[j]]).max())
                cx = (eb[j, :, 0] + eb[j, :, 2]) / 2
                gap = float(np.abs(cx[ep[j][moved]] - cx[gp[j][moved]]).max())
                require(gap <= 2 * shift, f"{what}: the object order differs at centres "
                        f"{gap:.3e} px apart, beyond twice the box shift {shift:.3e} px")
                flipped.add(int(img + j))
    for k, (eb, gb, e, g) in enumerate(zip(np.concatenate(exp_path["boxes"]),
                                           np.concatenate(got_path["boxes"]), exp, got)):
        pairs = set(map(tuple, e["pred_rel_inds"].tolist())) ^ set(
            map(tuple, g["pred_rel_inds"].tolist()))
        if not pairs:
            continue
        ov = e["obj_valid"]
        shift = float(np.abs(eb[ov] - gb[ov]).max())
        for s, o in pairs:
            lo, hi = np.maximum(eb[s], eb[o]), np.minimum(eb[s], eb[o])
            overlap = float(min(hi[2] - lo[0], hi[3] - lo[1])) + 1.0
            require(abs(overlap) <= 2 * shift, f"{what}: pair ({s}, {o}) kept on one side "
                    f"only, its overlap {overlap:.3e} px beyond twice the shift {shift:.3e}")
        flipped.add(k)
    return flipped


def check_rpn_run(what: str, runs: list, witness) -> None:
    """Phase 26 (a)'s sgdet run through the RPN: `runs` [CPU, card],
    `witness` the card's run with K2 and K3's plain versions. The anchors
    K3 keeps equal on both sides, in order; classes and valid objects
    equal, boxes within RUNBOOK_RPN_BOX_ATOL; where no near tie flipped a
    decision (`near_tie_images`), an image's relations compare as phase
    17's do; the witness equals the kernels' run to the bit."""
    (exp_rc, exp_rep, exp_rd, exp, exp_path, _), (_, _, got_rd, got, got_path, _) = runs
    keeps = exp_path["keeps"]
    require(len(got_path["keeps"]) == len(keeps) == len(exp)
            and all(np.array_equal(g, e) for g, e in zip(got_path["keeps"], keeps)),
            f"{what}: the anchors K3 keeps differ between the card and the CPU")
    for g, e in zip(got, exp):
        for key in ("pred_classes", "obj_valid"):
            require(np.array_equal(g[key], e[key]), f"{what}: {key} differ")
        ov = e["obj_valid"]
        np.testing.assert_allclose(g["pred_boxes"][ov], e["pred_boxes"][ov], rtol=0,
                                   atol=RUNBOOK_RPN_BOX_ATOL)
    flipped = near_tie_images(what, exp_path, got_path, exp, got)
    same = [k for k in range(len(exp)) if k not in flipped]
    require(same, f"{what}: a near tie flipped every image")
    n_objs, n_rels, n_moved, worst = compare_eval_runs(
        what, "sgdet", exp_rd, [exp[k] for k in same], got_rd, [got[k] for k in same],
        len(same), box_atol=RUNBOOK_RPN_BOX_ATOL)
    _, _, w_rd, w, w_path, w_launches = witness
    require(w_launches["perclass_nms"] == w_launches["greedy_nms"] == 0,
            f"{what}: the plain-NMS run launched {w_launches}")
    require(w_rd == got_rd and len(w) == len(got)
            and all(np.array_equal(a[k], b[k]) for a, b in zip(w, got) for k in b)
            and all(np.array_equal(a, b) for a, b in zip(w_path["keeps"], got_path["keeps"])),
            f"{what}: K2 and K3 differ from their plain versions on the card")
    measured = exp_rep["report"]["sgdet"]["measured"]
    print(f"{what}: K3 keeps the same {sum(map(len, keeps))} anchors in the same order on card "
          f"and CPU; {len(exp)} test images 128x128, classes equal, boxes apart by up to "
          f"{box_gap(exp, got):.3e} (BOX_SCALE units, atol {RUNBOOK_RPN_BOX_ATOL}); images "
          f"{sorted(flipped)} decided a near tie otherwise (object order or box overlap within "
          f"twice the box shift); the other {len(same)} agree as phase 17's ({n_objs} objects, "
          f"{n_rels} relations, {n_moved} ranked apart within near ties, triplet scores within "
          f"{worst:.2e}); R@20/50/100 {measured['20']:.2f} / {measured['50']:.2f} / "
          f"{measured['100']:.2f}, exit {exp_rc}; on the card K2 and K3's plain versions give "
          f"the kernels' entries to the bit", flush=True)


def check_runbook_reference(dev) -> None:
    """Phase 26 (a): a reference vgrel .tar at phase 6's widths through
    parity_runbook.main (the canonical flags, phase 6's small widths after
    them) over StructuredSyntheticVG splits, on the CPU (plain versions)
    and on the card (kernels), a mode a call: predcls and sgcls on 4 test
    images of 592^2; sgdet on 4 of 128^2 twice, with -proposals around the
    GT (`WithProposals`) as phase 17 runs it, and through the random
    reference detector's RPN (`check_rpn_run`). The measured R@K equal;
    but for the RPN run, the evaluations agree as phase 17's do
    (compare_eval_runs: identical recall lists, classes and pair order,
    scores within rtol 1e-3 / atol 1e-4)."""
    with tempfile.TemporaryDirectory() as tmp:
        for mode, proposals in RUNBOOK_REFERENCE_RUNS:
            im = 128 if mode == "sgdet" else C.IM_SCALE
            splits = StructuredSyntheticVG.splits(num_images=8, val_images=4, num_classes=12,
                                                  seed=SEED, im_size=im)
            tar = os.path.join(tmp, "small.tar")
            gen = torch.Generator(device=dev).manual_seed(SEED + 12)
            torch.save({"state_dict": reference_rel_sd(
                gen, **dict(SMALL_WIDTHS, nc=splits[0].num_classes,
                            npred=splits[0].num_predicates))}, tar)
            extra = SMALL_ARGS
            if mode == "sgdet":
                extra = extra + ["-im_budget", f"{im}x{im}"]
            if proposals:
                extra = extra + ["-proposals"]
                splits = tuple(WithProposals(d, gen, im, n=64) for d in splits)
            what = f"runbook-reference {mode}"
            runs = [runbook_run(tar, mode, extra, splits, where,
                                os.path.join(tmp, f"{mode}_{i}.json"))
                    for i, where in enumerate(("cpu", dev))]   # [CPU, card]
            (exp_rc, exp_rep, exp_rd, exp, _, _), (got_rc, got_rep, got_rd, got, _, _) = runs
            measured = got_rep["report"][mode]["measured"]
            require(measured == exp_rep["report"][mode]["measured"] and got_rc == exp_rc
                    and got_rep["all_pass"] == exp_rep["all_pass"],
                    f"{what}: card {got_rep} (exit {got_rc}) vs CPU {exp_rep} (exit {exp_rc})")
            if mode == "sgdet" and not proposals:
                check_rpn_run(what + " (RPN)", runs, runbook_run(
                    tar, mode, extra, splits, dev, os.path.join(tmp, f"{mode}_plain.json"),
                    nms_plain=True))
                continue
            n_objs, n_rels, n_moved, worst = compare_eval_runs(what, mode, exp_rd, exp,
                                                               got_rd, got, len(splits[2]))
            ties = (f"; {n_moved} relations ranked apart within near ties (triplet scores "
                    f"within {worst:.2e})" if mode == "sgdet" else "")
            print(f"{what}: card == CPU through parity_runbook.main on {len(splits[2])} test "
                  f"images {im}x{im} uint8 ({n_objs} objects, {n_rels} relations; R@20/50/100 "
                  f"{measured['20']:.2f} / {measured['50']:.2f} / {measured['100']:.2f} on both, "
                  f"exit {got_rc} on both{ties})", flush=True)


def check_runbook_published(smi: str, dev) -> dict:
    """Phase 26 (b): a reference vgrel .tar at the published MotifNet widths
    (`reference_rel_sd`) through parity_runbook.main at its canonical flags
    on the card, predcls, sgcls and sgdet in one call over RUNBOOK_IMAGES
    SyntheticVG test images: no relation-model key missing, each image
    evaluated once a mode, exactly RUNBOOK_BATCH_LAUNCHES a batch, and on
    random weights the report written with all_pass false and exit 1.
    Returns the launches by mode."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    timed = SyntheticVG.splits(num_images=4 * RUNBOOK_IMAGES)
    n_batches = math.ceil(RUNBOOK_IMAGES / 6)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        tar = os.path.join(tmp, "vgrel-motifnet.tar")
        sd = reference_rel_sd(gen, **PUBLISHED_WIDTHS)
        n_ref = len(sd)
        torch.save({"state_dict": sd}, tar)
        del sd
        t_tar = time.time() - t0
        out = os.path.join(tmp, "PARITY.json")
        buf = io.StringIO()
        t0 = time.time()
        with runbook_evals() as rec, contextlib.redirect_stdout(buf):
            rc = parity_runbook.main(["--sgcls-ckpt", tar, "--sgdet-ckpt", tar, "--modes",
                                      ",".join(RUNBOOK_MODES), "--out", out],
                                     datasets=timed, device="cuda")
        wall = time.time() - t0
        with open(out) as f:
            payload = json.load(f)
    text = buf.getvalue()
    bad = [ln for ln in text.splitlines()
           if ln.startswith(("optimistic_restore: missing", "optimistic_restore: shape"))]
    require(not bad, f"runbook published: the import left {bad[:3]} ...")
    copied = re.findall(r"optimistic_restore: copied (\d+/\d+) tensors", text)
    rates = re.findall(r"\[eval_rels\] \d+ images in [\d.]+ s, ([\d.]+) img/s", text)
    require([m for m, _, _ in rec] == list(RUNBOOK_MODES) and len(copied) == len(rates)
            == len(RUNBOOK_MODES), f"runbook published: ran {[m for m, _, _ in rec]}")
    for (mode, ev, launches), n_copied, rate in zip(rec, copied, rates):
        r = check_recalls(ev, mode, RUNBOOK_IMAGES)
        want = tuple(n * n_batches for n in RUNBOOK_BATCH_LAUNCHES[mode])
        require(tuple(launches.values()) == want,
                f"runbook published {mode}: launches {launches}, expected {want}")
        paths[f"runbook {mode}"] = launches
        print(f"runbook published {mode}: {RUNBOOK_IMAGES} test images at the canonical flags "
              f"(-b 6, -max_pairs_eval 4096, f32) on {smi}: {float(rate):.3f} img/s; -ckpt a "
              f"reference .tar of {n_ref} tensors (copied {n_copied}, none missing); R@20/50/100 "
              f"{r[20]} / {r[50]} / {r[100]}; launches {launches} ({n_batches} batches)",
              flush=True)
    require(rc == 1 and payload["all_pass"] is False and not payload["skipped_modes"]
            and set(payload["report"]) == set(RUNBOOK_MODES)
            and not any(v["pass"] for v in payload["report"].values()),
            f"runbook published: exit {rc}, payload {payload}")
    print(f"runbook published: the report written, all_pass false, exit 1 (random weights: "
          f"expected); the .tar made in {t_tar:.1f} s, the runbook {wall:.1f} s", flush=True)
    return paths


def check_dress_train(smi: str, t_phase: float) -> dict:
    """Phase 26 (c): dress_rehearsal.stage_train at the published config
    (batch 6, hidden 512, pooling 4096, nl_obj 2, nl_edge 4, lr 1e-5, clip
    5) over SyntheticVG, DRESS_STEPS steps unless the phase would outlast
    PHASE26_BUDGET_S (the cut printed): finite losses, no step skipped,
    exactly DRESS_STEP_LAUNCHES a step."""
    data = (SyntheticVG(DRESS_STEPS * 6, "train"), SyntheticVG(8, "val"),
            SyntheticVG(8, "test"))
    limit = PHASE26_BUDGET_S - (time.time() - t_phase)
    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = dress_rehearsal.stage_train("", steps=DRESS_STEPS, datasets=data, device="cuda",
                                          time_limit_s=limit)
    torch.cuda.synchronize()
    launches = count_launches()
    steps = rep["steps"]
    want = tuple(n * steps for n in DRESS_STEP_LAUNCHES)
    require(tuple(launches.values()) == want,
            f"dress train: launches {launches} over {steps} steps, expected {want}")
    require(rep["skipped_steps"] == 0 and steps >= 2, f"dress train: {rep}")
    cut = ("" if steps == DRESS_STEPS else
           f"; CUT to {steps} of {DRESS_STEPS} steps: the phase would have outlasted "
           f"{PHASE26_BUDGET_S} s")
    print(f"dress train: {steps} steps of 6 images 592x592 (dress_rehearsal.stage_train, the "
          f"published config, lr 1e-5) over SyntheticVG on {smi}: first step "
          f"{rep['first_step_s']} s, then {rep['s_per_step']} s/step, {rep['imgs_per_s']} img/s "
          f"(loader included); peak memory {rep['peak_cuda_gb']} GB, host peak RSS "
          f"{rep['peak_rss_gb']} GB; final losses {rep['final_losses']}; skipped 0; launches "
          f"{launches}{cut}", flush=True)
    return {"dress train": launches}


def check_runbook_and_dress(smi: str, dev) -> dict:
    """Phase 26: (a)-(c); returns the launches by path."""
    t0 = time.time()
    check_runbook_reference(dev)
    paths = check_runbook_published(smi, dev)
    torch.cuda.empty_cache()
    paths.update(check_dress_train(smi, t0))
    torch.cuda.empty_cache()
    print(f"phase 26 (parity runbook and dress rehearsal): {time.time() - t0:.1f} s", flush=True)
    return paths


TRAJECTORY_CPU_THREADS = 6
TRAJECTORY_CPU_TIMEOUT_S = 480


def trajectory_cpu(path: str) -> None:
    """Phase 27's CPU side, in a process of its own: the port's initial
    weights and the reference run of the eight loops (its samples
    recorded), saved to `path` + ".ref", then the control, saved to
    `path`."""
    torch.set_num_threads(TRAJECTORY_CPU_THREADS)
    t0 = time.time()
    init = trajectory.port_init(trajectory.tiny_config())
    tapes = {loop: trajectory.SampleTape() for loop in trajectory.LOOPS}
    with contextlib.redirect_stdout(io.StringIO()):
        ref = trajectory.run_loops("cpu", init, tapes)
    torch.save({"init": init, "tapes": tapes, "ref": ref, "seconds": time.time() - t0},
               path + ".tmp")
    os.replace(path + ".tmp", path + ".ref")
    t1 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        ctrl = trajectory.run_loops("cpu", init, {k: t.replay() for k, t in tapes.items()},
                                    ref=ref, perturb=True)
    torch.save({"ctrl": ctrl, "seconds": time.time() - t1}, path + ".tmp")
    os.replace(path + ".tmp", path)


def wait_for_file(proc, log, path: str, deadline: float) -> None:
    """Waits for `proc` to write `path`; fails with its log's tail where it
    exits first or outlasts `deadline`."""
    while not os.path.exists(path) and proc.poll() is None and time.time() < deadline:
        time.sleep(0.5)
    if not os.path.exists(path) and proc.poll() is None:
        proc.kill()
        proc.wait()
    log.flush()
    with open(log.name) as f:
        tail = f.read()[-3000:]
    require(os.path.exists(path), f"trajectories: the CPU process wrote no {path} "
            f"(exit {proc.returncode}):\n{tail}")


def check_trajectories(smi: str, beside=None) -> dict:
    """Phase 27, after every timed phase: a CPU process runs the eight loops
    (the reference, then the control); the card runs them with the
    reference's samples replayed, beside the CPU's control, and is held in
    the band around it; every step's lr and every plateau epoch's scale
    equal the CPU's; no replayed RoI box is missed at a loop's first step;
    the card's gradient norm against float64. `beside()`, card work that
    needs none of it, runs while the CPU computes its reference; its
    launches by path are returned with phase 27's."""
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trajectory_")
    path = os.path.join(tmp, "trajectory_cpu.pt")
    log = open(os.path.join(tmp, "trajectory_cpu.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--trajectory-cpu",
                             path], stdout=log, stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS=str(TRAJECTORY_CPU_THREADS),
                                     CUDA_VISIBLE_DEVICES=""))
    paths = {}
    try:
        if beside is not None:
            paths.update(beside())
        deadline = t0 + TRAJECTORY_CPU_TIMEOUT_S
        wait_for_file(proc, log, path + ".ref", deadline)
        cpu_run = torch.load(path + ".ref", weights_only=False)
        waited = time.time() - t0
        tapes = {k: t.replay() for k, t in cpu_run["tapes"].items()}
        zero_launches()
        t1 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            card = trajectory.run_loops("cuda", cpu_run["init"], tapes, ref=cpu_run["ref"])
        torch.cuda.synchronize()
        launches = count_launches()
        card_s = time.time() - t1
        wait_for_file(proc, log, path, deadline)
        ctrl = torch.load(path, weights_only=False)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    ref = cpu_run["ref"]
    for loop, t in tapes.items():
        require(t.used_up(), f"trajectories {loop}: samples left on the tape {t.cursor}")
        require(not t.missed or t.missed[0] == 0,
                f"trajectories {loop}: {t.missed[0] if t.missed else 0} replayed RoI boxes are "
                f"none of the card's candidates at the first step")
        scales = [[s for _, s in run[loop].get("plateau", [])] for run in (card, ref)]
        require(card[loop].get("lr") == ref[loop].get("lr") and scales[0] == scales[1],
                f"trajectories {loop}: the card's lr a step or plateau scales {scales[0]} are "
                f"not the CPU's {scales[1]}")
    out = []
    for band in trajectory.bands(card, ref, ctrl["ctrl"]):
        print(f"trajectory {band.summary()}; replayed RoI boxes missed a step "
              f"{tapes[band.name].missed}", flush=True)
        if not band.ok():
            out.append(band.name)
    require(not out, f"trajectories: the card leaves the band in {out}")
    x = torch.randn(10 ** 8, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED)) * 1e-2
    norm_err = float(mesh.grad_norm(x).double() / x.double().norm() - 1.0)
    require(abs(norm_err) < 1e-5, f"trajectories: the card's gradient norm of 10^8 elements "
            f"is {norm_err:.2e} off float64's")
    del x
    torch.cuda.empty_cache()
    print(f"phase 27 (trajectories): the eight loops of the tools on {smi}, 40 steps each, "
          f"inside the band around the CPU control in every loop, every step's lr and plateau "
          f"scale the CPU's; the CPU's reference {cpu_run['seconds']:.1f} s ({waited:.1f} s "
          f"here, phase 28 beside it included) and control {ctrl['seconds']:.1f} s in their "
          f"own process "
          f"({TRAJECTORY_CPU_THREADS} threads), the card's run {card_s:.1f} s beside the "
          f"control; launches {launches}; the card's f32 gradient norm of 10^8 elements "
          f"{norm_err:.2e} off float64's; the phase {time.time() - t0:.1f} s", flush=True)
    return dict(paths, trajectories=launches)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on a GPU")
    dev = torch.device("cuda")
    # the int8 towers run where phase 28 sets NM_QUANT, and nowhere else
    os.environ.pop("NM_QUANT", None)
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
    check_host_runtime()

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
    # data parallelism: an NCCL group of one rank, then two gloo ranks
    paths.update(check_dp_nccl(smi, dev))
    paths.update(check_dp_gloo(smi, dev))
    # tensor parallelism: the fc towers split over model ranks (phase 24)
    paths.update(check_tp(smi, dev))
    # the ResNet-101 C4 path (-resnet): card == CPU on small f32 models, the
    # full-width SGDet request, detector training, relation training and
    # evaluation
    check_reference(dev, "resnet-", use_resnet=True)
    check_detector_reference(dev, "resnet ", use_resnet=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    model = bench_model(dev, gen, use_resnet=True)
    paths["resnet request"] = check_requests("resnet ", model, dev, gen, smi,
                                             REQUEST_LAUNCHES)
    del model
    torch.cuda.empty_cache()
    paths.update(check_detector_train(smi, dev, "resnet ", RESNET_DET_ARGS,
                                      RESNET_DET_WARMUP, RESNET_DET_TIMED))
    paths.update(check_train(smi, "resnet ", RESNET_TRAIN_ARGS, "motifnet",
                             RESNET_TRAIN_LAUNCHES, RESNET_TRAIN_WARMUP, RESNET_TRAIN_TIMED))
    paths.update(check_eval(smi, "resnet ", RESNET_EVAL_ARGS, RESNET_EVAL_LAUNCHES))
    # the serving entry point: card == CPU at a small size, then the
    # published widths
    predict_reference_subprocess()
    paths.update(check_predict(smi))
    # the learning proof and the training and precision tools
    paths.update(check_learning_proof(smi))
    # the parity runbook and the dress rehearsal's train stage
    paths.update(check_runbook_and_dress(smi, dev))
    # the tools' training loops on the card against the CPU's, the int8
    # towers (phase 28) on the card while the CPU computes its reference
    paths.update(check_trajectories(smi, beside=lambda: check_int8(smi, dev)))
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
    if sys.argv[1:] == ["--predict-reference"]:   # phase 22's own process
        check_predict_reference()
    elif sys.argv[1:2] == ["--trajectory-cpu"]:    # phase 27's CPU process
        trajectory_cpu(sys.argv[2])
    else:
        main()
