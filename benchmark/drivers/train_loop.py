"""train_loop: detector pretraining as the port runs it. A closed loop of
training steps through `training/train_state.train_epoch` over
`make_train_step(model, optimizer, detector_losses, clip)`, the batches
collated by the port's Loader from a pool of scenes in host memory. The
window ends at the deadline: the loader handed to `train_epoch` stops
yielding.

Set-up builds the one train step, drives it through its first three steps
by the window's own call and feed (`train_epoch`), keeping what the
judgement needs (the step's output, the proposals' anchor indices through
a wrapper around the detector module's `nms_topk`, the momentum after
step 1, the parameters' change after step 3), and hands the same step to
the window. After the window the plain reference follows those three
steps (benchmark/reference/judge_train.py).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.arith import flops as F
from benchmark.drivers import common
from benchmark.lib.kernels import Observer
from benchmark.lib.profile import Slices
from benchmark.lib.record import Record, Spans, device_info, power_limit
from benchmark.reference import judge_train
from benchmark.traffic import scenes
from benchmark.traffic.weights import make_weights, spec_of

FIRST_STEPS = 3
PROFILE_FIRSTS, PROFILE_STEPS = (20, 60, 100), 15


def _half_batch_loss(loss_fn):
    """The fault 'half_batch': the loss over the first half of the batch,
    the mean taken over it alone."""
    def half(out):
        b = out.od_valid.shape[0]
        keep = torch.arange(b, device=out.od_valid.device) < b // 2
        lbl = torch.where(keep[:, None, None, None], out.rpn_labels,
                          torch.full_like(out.rpn_labels, -1))
        return loss_fn(out._replace(od_valid=out.od_valid & keep[:, None], rpn_labels=lbl))
    return half


def run(ctx) -> Record:
    args, conf, traffic = ctx.args, ctx.conf, ctx.traffic
    dev, batch = ctx.device, traffic["batch"]
    rec = Record("train_loop", ctx.cell["name"])
    trace = bool(args.trace)
    spans = Spans(rec, trace)
    limits = ctx.limits()
    bud = common.budgets(conf, "sgdet")
    im = conf["image_size"]
    pool = scenes.make_pool(traffic["scenes"], common.seed_of(args.seed, 1),
                            conf["num_classes"], 51)
    gen_seed = common.seed_of(args.seed, 4)

    def weights_for(spec):
        return make_weights(spec, common.seed_of(args.seed, 2), dev, conf["score_bias_std"])

    if args.control:
        return _control(ctx, rec, pool, weights_for, gen_seed, bud, limits)

    from neural_motifs_tpu_torch import config as C
    from neural_motifs_tpu_torch.data.batching import Loader, to_device
    from neural_motifs_tpu_torch.models import detector as det_mod
    from neural_motifs_tpu_torch.training import train_detector
    from neural_motifs_tpu_torch.training.losses import detector_losses
    from neural_motifs_tpu_torch.training.train_state import (make_optimizer,
                                                              make_train_step, train_epoch)

    cfg = C.ModelConfig.from_args(common.port_argv(conf, traffic))
    model = train_detector.build_detector(cfg, conf["num_classes"], dev,
                                          torch.Generator(device=dev).manual_seed(0))
    spec = spec_of(model)
    model.load_state_dict(weights_for(spec), strict=True)
    lr = cfg.lr * cfg.num_devices * cfg.batch_size
    opt = make_optimizer(model, lr, l2=cfg.l2, adam=cfg.adam)
    loss_fn = detector_losses
    if args.fault == "half_batch":
        loss_fn = _half_batch_loss(detector_losses)
    elif args.fault == "frozen":          # the step returns its state unchanged
        opt.step = lambda *a, **kw: None
    elif args.fault:
        raise SystemExit(f"unknown fault {args.fault!r} for train_loop; "
                         f"['frozen', 'half_batch']")
    step = make_train_step(model, opt, loss_fn, clip=cfg.clip)
    generator = torch.Generator(device=dev).manual_seed(gen_seed)
    max_steps = int(args.seconds * traffic["max_steps_per_s"]) + FIRST_STEPS + 8
    stream = scenes.PoolStream(pool, batch * max_steps)
    loader = Loader(stream, batch, shuffle=True, budgets=cfg.budgets, num_workers=1,
                    seed=common.seed_of(args.seed, 5) % (1 << 32))
    loader_it = iter(loader)

    def prepare(b):
        return to_device(train_detector.batch_kwargs(b), dev)

    # the first steps, recorded for the judgement
    first_ids, steps, nms_calls = [], [], []
    orig_nms = det_mod.nms_topk

    def nms_recorded(*a, **kw):
        out = orig_nms(*a, **kw)
        nms_calls.append(out)
        return out

    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    norms = {}

    def first_step(kw, gen, **samples):
        losses, out = step(kw, gen, **samples)
        idx, ok = nms_calls[-1]
        rec_s = judge_train.step_record(out, losses)
        rec_s.update(prop_idx=idx, prop_valid=ok, skipped=float(losses["skipped"]))
        steps.append(rec_s)
        if len(steps) == 1:
            norms["grad"] = judge_train.leaf_norms(
                {n: opt.state[p].get("momentum_buffer", torch.zeros(()))
                 for n, p in model.named_parameters()})
        return losses, out

    def first_batches():
        for _ in range(FIRST_STEPS):
            b = next(loader_it)
            first_ids.append(b.image_ids.copy())
            yield b

    det_mod.nms_topk = nms_recorded
    try:
        hist0 = train_epoch(first_step, first_batches(), prepare, generator, 0, 10 ** 9,
                            "benchmark")
    finally:
        det_mod.nms_topk = orig_nms
    norms["change"] = judge_train.leaf_norms(
        {n: p.detach() - p0[n] for n, p in model.named_parameters()})
    del p0, nms_calls
    common.sync(dev)
    setup_peak = common.peak_bytes(dev)
    rec.setup_s = time.perf_counter() - ctx.t0

    # the window
    slices = Slices(PROFILE_FIRSTS if trace else (), PROFILE_STEPS, Observer)
    st = {"k": 0}
    rois = []

    def window_step(kw, gen, **samples):
        k = st["k"]
        slices.before(k)
        with spans.span("step"):
            losses, out = step(kw, gen, **samples)
        if trace:
            rois.append(out.od_valid.sum(1))
        slices.after(k)
        st["k"] += 1
        return losses, out

    common.reset_peak(dev)
    t_start = time.perf_counter()
    deadline = t_start + args.seconds

    def window_batches():
        while time.perf_counter() < deadline:
            with spans.span("loader_wait"):
                b = next(loader_it)
            yield b

    hist = train_epoch(window_step, window_batches(), prepare, generator, 1, 10 ** 9,
                       "benchmark")
    common.sync(dev)
    rec.window_s = time.perf_counter() - t_start - slices.read_s   # less the slice's reading
    rec.batches = len(hist)
    rec.images = rec.batches * batch
    rec.attempted = rec.images
    rec.failed = int(sum(h["skipped"] for h in hist + hist0)) * batch
    rec.step_s = [h["step_s"] for h in hist]
    rec.peak_window_bytes = common.peak_bytes(dev)
    rec.device = device_info(dev, max(setup_peak, rec.peak_window_bytes))
    rec.power = power_limit()
    print(f"window: {rec.batches} steps; {rec.power}", flush=True)
    slices.close()
    if trace:
        rec.profile, rec.kernel_bound_ms = slices.read()
        for n in torch.cat(rois).tolist() if rois else []:
            rec.flops += F.detector_train(conf, im, int(n))
    stream.stop()
    with contextlib.suppress(scenes.Stopped, StopIteration):
        for _ in loader_it:
            pass
    del model, opt, step, slices, rois
    common.free_device()

    inputs = [_inputs(pool, ids, bud, im, dev) for ids in first_ids]
    run_rec = {"steps": steps, "grad_norms": norms["grad"], "change_norms": norms["change"]}
    out = judge_train.judge_run(conf, bud, weights_for(spec), inputs, run_rec,
                                torch.Generator(device=dev).manual_seed(gen_seed), dev)
    return _conclude(rec, out, limits)


def _inputs(pool, ids, bud, im, dev) -> dict:
    """The benchmark's own collation of the pool images a step took."""
    parts = [scenes.collate(pool, int(i), 1, bud.max_gt_boxes, im) for i in ids]
    return common.to_device({k: np.concatenate([p[k] for p in parts]) for k in parts[0]},
                            dev)


def _conclude(rec: Record, out: dict, limits: dict) -> Record:
    print(f"judged leaves left out: {out.pop('left_out')}; worst: {out.pop('worst_leaves')}",
          flush=True)
    for k, v in out.items():
        print(f"judged {k}: {v!r}", flush=True)
    rec.checks = common.limited(out, limits)
    rec.correct = rec.failed == 0 and all(v <= lim for v, lim in rec.checks.values())
    return rec


def _control(ctx, rec, pool, weights_for, gen_seed, bud, limits) -> Record:
    """`--control fp8`: the reference at fp8 takes the program's three
    steps on the same batches, judged as the program is. No window."""
    from benchmark.reference import common as ref_common
    conf, traffic, dev = ctx.conf, ctx.traffic, ctx.device
    batch, im = traffic["batch"], conf["image_size"]
    rng = np.random.default_rng(common.seed_of(ctx.args.seed, 5))
    ids = [rng.choice(len(pool.gt_boxes), batch, replace=False) for _ in range(FIRST_STEPS)]
    inputs = [_inputs(pool, i, bud, im, dev) for i in ids]
    spec = judge_train.detector_spec(conf, bud)
    ref_common.set_precision("fp8")
    lowp = judge_train.build_detector(conf, bud, weights_for(spec), dev)
    run_rec = judge_train.free_run(lowp, conf, inputs,
                                   torch.Generator(device=dev).manual_seed(gen_seed))
    del lowp
    common.free_device()
    ref_common.set_precision("f32")
    rec.attempted = batch * FIRST_STEPS
    out = judge_train.judge_run(conf, bud, weights_for(spec), inputs, run_rec,
                                torch.Generator(device=dev).manual_seed(gen_seed), dev)
    rec.device = device_info(dev, common.peak_bytes(dev))
    return _conclude(rec, out, limits)
