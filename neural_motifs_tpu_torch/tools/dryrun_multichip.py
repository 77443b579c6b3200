"""The multichip dry run (counterpart of __graft_entry__.dryrun_multichip):
one relation training step and one eval step of MotifNet sgdet over a data
x model grid of ranks, the three VGG fc towers split over the model ranks
(parallel/mesh.py's Megatron split).

    torchrun --standalone --nproc_per_node N -m neural_motifs_tpu_torch.tools.dryrun_multichip
    python -m neural_motifs_tpu_torch.tools.dryrun_multichip      # one rank, no group

N ranks are laid out as JAX's dry run lays out its devices: model 2 where
N >= 4 and even, else 1; data N / model. The step is the relation
training step (`train_state.make_train_step`, `make_optimizer` with the
`roi_fmap*` towers at lr / 10, clip 5) on `tiny_setup`'s model and batch,
one image a data rank, dropout on and the samplers drawn; then the eval
forward. Then, unless NM_DRYRUN_TINY_ONLY=1, the same two steps at the
full shapes: the default PadBudgets, IM_SCALE^2 images, JAX's
`_full_scale_model` widths in bf16, N / model images. (JAX compiles the
full-shape steps without running them; PyTorch has no such compile, so
they run.) Each rank prints nothing but rank 0 its OK line.

From Python, `dryrun_multichip(n, device="cuda")`: a rank of a group of n
runs its part; a process without a group starts the n ranks itself, as
processes of this module with torchrun's environment sharing `device` (a
gloo group: NCCL takes one card a rank), and returns their results. It
raises without a card unless `device="cpu"`.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from neural_motifs_tpu_torch import config as C
from neural_motifs_tpu_torch.models.rel_model import RelModel, disable_dropout_
from neural_motifs_tpu_torch.ops import highway_lstm as hl, nms, quant, roi_align as ra
from neural_motifs_tpu_torch.parallel import distributed as D
from neural_motifs_tpu_torch.parallel import mesh
from neural_motifs_tpu_torch.training import train_state
from neural_motifs_tpu_torch.training.eval_rels import require_device
from neural_motifs_tpu_torch.training.losses import rel_losses
from neural_motifs_tpu_torch.weights import random_init_, set_embeddings_

SEED = 0
LR, CLIP = 1e-3, 5.0
JOIN_TIMEOUT_S = 900   # the ranks' whole run, group formation included
# __graft_entry__._tiny_setup's model
TINY_NC, TINY_NP = 16, 8
TINY_BUDGETS = dict(max_gt_boxes=8, max_gt_rels=8, rois_per_img=16, objs_per_img=8,
                    rels_per_img=16, rels_per_img_refine=8, max_pairs_eval=56,
                    rpn_pre_nms_topn_train=64, rpn_post_nms_topn_train=32,
                    rpn_pre_nms_topn_test=64, rpn_post_nms_topn_test=16)
TINY_WIDTHS = dict(hidden_dim=16, pooling_dim=64, obj_dim=64, embed_dim=8, nl_obj=1,
                   nl_edge=1, use_bias=True, limit_vision=False, thresh=0.0)
# __graft_entry__._full_scale_model's
FULL_WIDTHS = dict(hidden_dim=512, pooling_dim=4096, obj_dim=4096, embed_dim=200, nl_obj=2,
                   nl_edge=4, order="leftright", use_bias=True, use_tanh=False,
                   limit_vision=False, thresh=0.05)
KERNELS = {"roi_align_fwd": ra.roi_align_cuda, "perclass_nms": nms.perclass_nms_cuda,
           "greedy_nms": nms.greedy_nms_cuda, "roi_align_bwd": ra.roi_align_bwd_cuda,
           "highway_lstm": hl.highway_lstm_cuda}


def grid_shape(n: int, num_model: Optional[int] = None) -> tuple:
    """(data, model) of n ranks: model 2 where n >= 4 and even, else 1, as
    JAX's dry run; or `num_model`."""
    if num_model is None:
        num_model = 2 if n >= 4 and n % 2 == 0 else 1
    if n % num_model:
        raise ValueError(f"{n} ranks do not divide into model {num_model}")
    return n // num_model, num_model


def _gt_batch(rng, b: int, im: int, g: int, r: int, nc: int, npred: int, n_obj: int,
              n_rel: int, min_wh: float) -> dict:
    """_tiny_setup's batch: per image n_obj GT boxes and n_rel relations,
    then the images, drawn from `rng` in its order."""
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_classes = np.zeros((b, g), np.int32)
    gt_mask = np.zeros((b, g), bool)
    gt_rels = np.zeros((b, r, 3), np.int32)
    gt_rel_mask = np.zeros((b, r), bool)
    for i in range(b):
        xy = rng.uniform(0, im * 0.5, (n_obj, 2))
        wh = rng.uniform(min_wh, im * 0.45, (n_obj, 2))
        gt_boxes[i, :n_obj] = np.concatenate([xy, np.minimum(xy + wh, im - 1)], 1)
        gt_classes[i, :n_obj] = rng.randint(1, nc, n_obj)
        gt_mask[i, :n_obj] = True
        sub = rng.randint(0, n_obj, n_rel)
        obj = (sub + rng.randint(1, n_obj, n_rel)) % n_obj
        gt_rels[i, :n_rel] = np.stack([sub, obj, rng.randint(1, npred, n_rel)], 1)
        gt_rel_mask[i, :n_rel] = True
    return dict(images=rng.randn(b, im, im, 3).astype(np.float32) * 0.1,
                im_hw=np.full((b, 2), float(im), np.float32), gt_boxes=gt_boxes,
                gt_classes=gt_classes, gt_mask=gt_mask, gt_rels=gt_rels,
                gt_rel_mask=gt_rel_mask)


def tiny_setup(num_images: int, im: int = 64, mode: str = "sgdet") -> tuple:
    """__graft_entry__._tiny_setup for the port: (RelModel keywords, word
    vectors and frequency table, batch), drawn from RandomState(0) in its
    order, so that the batch is JAX's."""
    rng = np.random.RandomState(0)
    vecs = dict(embed_vecs=rng.randn(TINY_NC, 8).astype(np.float32),
                decoder_embed_vecs=rng.randn(TINY_NC + 1, 100).astype(np.float32),
                freq_table=rng.randn(TINY_NC * TINY_NC, TINY_NP).astype(np.float32))
    budgets = C.PadBudgets(**TINY_BUDGETS)
    model_kw = dict(num_classes=TINY_NC, num_rels=TINY_NP, mode=mode, budgets=budgets,
                    dtype=torch.float32, **TINY_WIDTHS)
    batch = _gt_batch(rng, num_images, im, budgets.max_gt_boxes, budgets.max_gt_rels,
                      TINY_NC, TINY_NP, 5, 3, 8)
    return model_kw, vecs, batch


def full_setup(num_images: int, dtype: torch.dtype = torch.bfloat16) -> tuple:
    """__graft_entry__._full_scale_model's keywords at the default
    PadBudgets in `dtype`, its vectors, and a batch of IM_SCALE^2 images
    with 8 GT boxes and 6 relations each."""
    nc, npred = C.VG_NUM_CLASSES, C.VG_NUM_PREDICATES
    rng = np.random.RandomState(0)
    vecs = dict(embed_vecs=rng.randn(nc, 200).astype(np.float32) * 0.1,
                decoder_embed_vecs=rng.randn(nc + 1, 100).astype(np.float32) * 0.1,
                freq_table=rng.randn(nc * nc, npred).astype(np.float32) * 0.1)
    budgets = C.PadBudgets()
    model_kw = dict(num_classes=nc, num_rels=npred, mode="sgdet", budgets=budgets,
                    dtype=dtype, **FULL_WIDTHS)
    batch = _gt_batch(rng, num_images, C.IM_SCALE, budgets.max_gt_boxes,
                      budgets.max_gt_rels, nc, npred, 8, 6, 32)
    return model_kw, vecs, batch


@torch.no_grad()
def build(model_kw: dict, vecs: dict, device) -> RelModel:
    """The RelModel on `device`, its weights drawn from SEED as
    `random_init_` draws them and the word vectors and frequency table
    set from `vecs` (the JAX model's initializers), the detector frozen."""
    with torch.device(device):
        model = RelModel(**model_kw)
    random_init_(model, torch.Generator(device=device).manual_seed(SEED))
    set_embeddings_(model, vecs["embed_vecs"], vecs["decoder_embed_vecs"], vecs["freq_table"])
    return train_state.freeze_detector_(model)


def launches() -> dict:
    return {k: w.launches for k, w in KERNELS.items()}


def zero_launches() -> None:
    for w in KERNELS.values():
        w.launches = 0


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pass(spec: dict, device) -> dict:
    """One train step and one eval forward of this rank on its rows, the
    towers split over the group's model ranks. `spec`: `kind` ("tiny" or
    "full"), `num_images` (the global batch), `dtype` (full; tiny is f32),
    and optionally `mode` (tiny: sgdet by default), `dropout` (default
    on), `state_dict` (weights to load before the split), `samples` (a
    RelSample of the global batch to replay), `tensors` (default on: the
    parameters, gradients and statistics below), `train` (default on:
    False leaves out the step, its results and the tensors) and `quant`
    ("int8": the eval forward under NM_QUANT=int8). The full model's
    detector gets spread class biases (`spread_class_biases_`).

    Returns the global losses, the step's and the eval forward's launches
    and model-group all-reduces, the step call's seconds, peak memory, the
    towers' parameter bytes, digests of the replicated and of the split
    trainable parameters (the replicated with the buffers), this rank's
    predictions; with `tensors`, data rank 0's ranks add their slices of
    the split trainable parameters and their gradients (dim, tensor,
    gradient), rank 0 the replicated trainable ones and the BatchNorm
    statistics."""
    device = torch.device(device)
    n = spec["num_images"]
    if spec["kind"] == "tiny":
        model_kw, vecs, batch = tiny_setup(n, mode=spec.get("mode", "sgdet"))
    else:
        model_kw, vecs, batch = full_setup(n, getattr(torch, spec.get("dtype", "bfloat16")))
    model = build(model_kw, vecs, device)
    if spec["kind"] == "full":
        spread_class_biases_(model.detector)
    if spec.get("state_dict") is not None:
        model.load_state_dict(spec["state_dict"])
    if not spec.get("dropout", True):
        disable_dropout_(model)
    mesh.shard_fc_(model)
    kw = {k: D.local_batch_slice(torch.as_tensor(v)).to(device) for k, v in batch.items()}
    samples = {k: type(v)(*(D.local_batch_slice(t).to(device) for t in v))
               for k, v in spec.get("samples", {}).items()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = dict(grid=tuple(D.grid()), rank=D.rank(), launches={}, model_reduces={})
    if spec.get("train", True):
        step = train_state.make_train_step(model, train_state.make_optimizer(model, LR),
                                           rel_losses, clip=CLIP)
        zero_launches()
        D.reset_model_stats()
        t0 = time.perf_counter()
        losses, _ = step(kw, torch.Generator(device=device).manual_seed(SEED + 1), **samples)
        _sync(device)
        res.update(step_s=time.perf_counter() - t0,
                   losses={k: float(v) for k, v in losses.items()},
                   launches={"train": launches()},
                   model_reduces={"train": dict(D.model_stats)})
    zero_launches()
    D.reset_model_stats()
    with quant.int8_env() if spec.get("quant") == "int8" else contextlib.nullcontext():
        pred = model(**{k: kw[k] for k in ("images", "im_hw", "gt_boxes", "gt_classes",
                                           "gt_mask")})
    _sync(device)
    res["launches"]["eval"] = launches()
    res["model_reduces"]["eval"] = dict(D.model_stats)
    res["pred"] = {k: v.cpu() for k, v in pred._asdict().items()}
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                         else None)
    if spec.get("train", True):
        res.update(_rank_state(model, spec.get("tensors", True)))
    return res


@torch.no_grad()
def spread_class_biases_(detector) -> None:
    """The detector's class biases from N(0, 3^2): a random detector's
    class scores sit near 1 / 151, below the full model's 0.05 threshold,
    and would leave its sgdet step no object; spread priors let boxes
    clear it, as a trained detector's do."""
    gen = torch.Generator(device=detector.score_fc.bias.device).manual_seed(SEED + 5)
    detector.score_fc.bias.normal_(0.0, 3.0, generator=gen)


def _rank_state(model, tensors: bool = True) -> dict:
    g = D.grid()
    split = mesh.sharded_params(model)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    out = dict(
        tower_bytes=sum(p.numel() * p.element_size() for name, p in model.named_parameters()
                        if {"fc0", "fc1", "proj"} & set(name.split("."))),
        digest_replicated=_digest([p for _, p in named if id(p) not in split]
                                  + list(model.buffers())),
        digest_split=_digest([p for _, p in named if id(p) in split]))
    if not tensors:
        return out
    if g.data_rank == 0:
        out["split"] = {name: (split[id(p)], p.detach().cpu(), p.grad.cpu())
                        for name, p in named if id(p) in split}
    if D.rank() == 0:
        out["replicated"] = {name: (p.detach().cpu(), p.grad.cpu())
                             for name, p in named if id(p) not in split}
        out["buffers"] = {name: b.cpu() for name, b in model.named_buffers()}
    return out


def assemble(results: list) -> dict:
    """The whole trainable parameters and gradients, and the BatchNorm
    statistics, from the ranks' `run_pass` results of one pass (rank
    order): {"params", "grads", "buffers"}."""
    out = {"params": {}, "grads": {}, "buffers": dict(results[0]["buffers"])}
    for name, (p, g) in results[0]["replicated"].items():
        out["params"][name], out["grads"][name] = p, g
    slices = sorted((r for r in results if r["grid"][2] == 0), key=lambda r: r["grid"][3])
    for name in slices[0].get("split", {}):
        dim = slices[0]["split"][name][0]
        out["params"][name] = torch.cat([r["split"][name][1] for r in slices], dim)
        out["grads"][name] = torch.cat([r["split"][name][2] for r in slices], dim)
    return out


def check_ranks(results: list) -> None:
    """What every grid must show: finite losses and eval scores, no
    skipped step, the replicated tensors equal bit for bit on every rank,
    the split ones equal on the ranks of a model rank, and the model ranks
    of a data rank holding equal predictions (an eval-only pass: the
    scores and the predictions)."""
    for r in results:
        if not bool(torch.isfinite(r["pred"]["obj_scores"]).all()):
            raise AssertionError(f"rank {r['rank']}: non-finite eval scores")
        if "losses" not in r:
            continue
        if not all(math.isfinite(v) for v in r["losses"].values()):
            raise AssertionError(f"rank {r['rank']}: non-finite loss {r['losses']}")
        if r["losses"]["skipped"]:
            raise AssertionError(f"rank {r['rank']}: the step skipped")
    if "losses" in results[0] and len({r["digest_replicated"] for r in results}) != 1:
        raise AssertionError("the replicated parameters or buffers differ between ranks")
    for m in {r["grid"][3] for r in results if "losses" in r}:
        if len({r["digest_split"] for r in results if r["grid"][3] == m}) != 1:
            raise AssertionError(f"model rank {m}'s slices differ between data ranks")
    for d in {r["grid"][2] for r in results}:
        same = [r for r in results if r["grid"][2] == d]
        for r in same[1:]:
            for k, v in r["pred"].items():
                if not torch.equal(v, same[0]["pred"][k]):
                    raise AssertionError(f"data rank {d}: the model ranks' {k} differ")


def default_passes(n_data: int) -> list:
    """JAX's dry run: the tiny step, one image a data rank; then, unless
    NM_DRYRUN_TINY_ONLY=1, the full shapes in bf16."""
    passes = [dict(kind="tiny", num_images=n_data)]
    if os.environ.get("NM_DRYRUN_TINY_ONLY") != "1":
        passes.append(dict(kind="full", num_images=n_data, dtype="bfloat16"))
    return passes


def run_rank(n: int, device, num_model: Optional[int] = None,
             passes: Optional[list] = None) -> list:
    """This rank's part of the dry run in a group of n (or alone, n = 1):
    the grid, then each pass; rank 0 prints the OK line."""
    n_data, n_model = grid_shape(n, num_model)
    if D.active():
        mesh.make_mesh(n_data, n_model)
    passes = passes if passes is not None else default_passes(n_data)
    out = [run_pass(p, device) for p in passes]
    for r in out:
        check_ranks([r])
    if D.is_main():
        kinds = ", ".join(f"{p['kind']} loss={r['losses']['total']:.4f}" if "losses" in r
                          else f"{p['kind']} eval only" for p, r in zip(passes, out))
        print(f"dryrun_multichip({n}): OK (grid data={n_data} x model={n_model}), {kinds}, "
              f"eval step OK", flush=True)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(n: int, device, num_model: Optional[int] = None,
                passes: Optional[list] = None) -> dict:
    """Start n ranks, processes of this module with torchrun's environment
    sharing `device` through a gloo group, without waiting for them."""
    device = torch.device(device)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    tmp = tempfile.TemporaryDirectory(prefix="dryrun_")
    spec = os.path.join(tmp.name, "spec.pt")
    torch.save({"passes": passes}, spec)
    procs, logs, outs = [], [], []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        if device.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        outs.append(os.path.join(tmp.name, f"rank{r}.pt"))
        logs.append(open(os.path.join(tmp.name, f"rank{r}.log"), "w+"))
        argv = [sys.executable, "-m", "neural_motifs_tpu_torch.tools.dryrun_multichip",
                "--device", device.type, "--backend", "gloo", "--spec", spec,
                "--out", outs[-1]]
        if num_model is not None:
            argv += ["--num_model", str(num_model)]
        procs.append(subprocess.Popen(argv, env=env, stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    return dict(n=n, tmp=tmp, procs=procs, logs=logs, outs=outs)


def wait_ranks(run: dict, timeout_s: float = JOIN_TIMEOUT_S) -> list:
    """Each `start_ranks` rank's results (rank order); a rank that fails or
    outlives `timeout_s` fails the run, and every rank is ended either way.
    Rank 0's OK line is printed here; the ranks' files are deleted."""
    procs, n = run["procs"], run["n"]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    try:
        text = []
        for log in run["logs"]:
            log.seek(0)
            text.append(log.read())
            log.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip({n}): rank {r} exited {p.returncode}:\n"
                                   f"{text[r][-4000:]}")
        for line in text[0].splitlines():
            if line.startswith("dryrun_multichip("):
                print(line, flush=True)
        return [torch.load(o, weights_only=False) for o in run["outs"]]
    finally:
        run["tmp"].cleanup()


def dryrun_multichip(n: int, device="cuda", num_model: Optional[int] = None,
                     passes: Optional[list] = None) -> list:
    """The dry run over n ranks: in a group of n this rank's results (a
    list, one entry a pass); alone with n = 1 those of the one process;
    otherwise the n ranks started here (`start_ranks`) and checked
    together, each rank's results in rank order."""
    device = require_device(device, "dryrun_multichip")
    if D.active():
        if D.world() != n:
            raise ValueError(f"dryrun_multichip({n}) in a group of {D.world()}")
        return run_rank(n, device, num_model, passes)
    if n == 1:
        return [run_rank(1, device, num_model, passes)]
    ranks = wait_ranks(start_ranks(n, device, num_model, passes))
    for i in range(len(ranks[0])):
        check_ranks([r[i] for r in ranks])
    return ranks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on a card)")
    ap.add_argument("--num_model", type=int, default=None)
    ap.add_argument("--spec", default=None, help="a torch.save'd {'passes': [...]}")
    ap.add_argument("--out", default=None, help="where this rank's results are saved")
    args = ap.parse_args(argv)
    device = mesh.setup(require_device(args.device, "dryrun_multichip"), args.backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    passes = torch.load(args.spec, weights_only=False)["passes"] if args.spec else None
    try:
        res = dryrun_multichip(D.world(), device, args.num_model, passes)
        if args.out:
            torch.save(res, args.out)
    finally:
        D.shutdown()


if __name__ == "__main__":
    main()
