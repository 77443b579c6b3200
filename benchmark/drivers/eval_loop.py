"""eval_loop: relation evaluation as the port runs it. A closed loop of
batches from a pool of scenes through `training/eval_rels.run_batches`
(one batch ahead), each batch's `consume` turning the prediction into the
evaluator's entries (`prediction_to_entries`) and scoring them
(`BasicSceneGraphEvaluator`). The window ends at the deadline: the loader
handed to `run_batches` stops yielding, and the batches already taken
are finished.

After the window a sample of the batches it finished, drawn from the seed
with the one of most objects in it, is judged against the plain reference
(benchmark/reference/judge.py), from the intermediates that hooks on the
program's detector and context kept for those batches.
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
from benchmark.reference import judge
from benchmark.reference.rel_model import capture_det
from benchmark.traffic import scenes
from benchmark.traffic.weights import make_weights, spec_of

PROFILE_FIRSTS, PROFILE_BATCHES = (10, 20, 30), 3   # the traced run's profiled slice
WARMUP_BATCHES = 2
JUDGED = 4                               # batches judged after the window


def judged_batches(pool: scenes.Pool, batch: int, seed: int, n: int = JUDGED) -> list:
    """Indices (among the first pool-length batches of the window) of the
    judged batches: the one whose images hold the most objects, and n - 1
    more drawn from the seed."""
    per = len(pool.gt_boxes) // batch
    objs = [sum(len(pool.gt_boxes[k * batch + i]) for i in range(batch)) for k in range(per)]
    first = int(np.argmax(objs))
    rest = [k for k in range(per) if k != first]
    rng = np.random.default_rng(common.seed_of(seed, 3))
    return sorted([first] + list(rng.choice(rest, min(n - 1, len(rest)), replace=False)))


def host_pred(pred) -> dict:
    return {k: (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
            for k, t in zip(pred._fields, pred)}


def well_formed(pred: dict, i: int, nc: int) -> bool:
    """Image i's answers have finite values and valid indices."""
    o = pred["obj_valid"].shape[1]
    return bool(np.isfinite(pred["rel_scores"][i]).all() and np.isfinite(pred["boxes"][i]).all()
                and np.isfinite(pred["obj_scores"][i]).all()
                and (pred["rel_inds"][i] >= 0).all() and (pred["rel_inds"][i] < o).all()
                and (pred["obj_classes"][i] >= 0).all() and (pred["obj_classes"][i] < nc).all())


def batch_flops(conf: dict, mode: str, pred: dict, proposals: np.ndarray | None,
                budget: int, im: int) -> float:
    total = 0.0
    for i in range(pred["obj_valid"].shape[0]):
        objs = int(pred["obj_valid"][i].sum())
        pairs = (min(int(pred["num_valid_pairs"][i]), budget) if mode == "sgdet"
                 else int(pred["rel_valid"][i].sum()))
        props = int(proposals[i]) if proposals is not None else 0
        total += F.motifnet_eval(conf, mode, im, objs, pairs, props)
    return total


def _fault(model, name: str):
    """A forward hook that breaks the program's answers (`--fault`):
    'half_batch' answers the second half of the batch with the first
    half's answers; 'altered' changes the class of one object."""
    def half(m, args, out):
        h = out.boxes.shape[0] // 2
        return type(out)(*(torch.cat([t[:h], t[:out.boxes.shape[0] - h]]) for t in out))

    def altered(m, args, out):
        classes = out.obj_classes.clone()
        classes[0, 0] = classes[0, 0] % (classes.max() + 1) + 1
        return out._replace(obj_classes=classes)

    hooks = {"half_batch": half, "altered": altered}
    if name not in hooks:
        raise SystemExit(f"unknown fault {name!r} for eval_loop; {sorted(hooks)}")
    return model.register_forward_hook(hooks[name])


def run(ctx) -> Record:
    args, conf, traffic = ctx.args, ctx.conf, ctx.traffic
    dev, mode, batch = ctx.device, traffic["mode"], traffic["batch"]
    rec = Record("eval_loop", ctx.cell["name"])
    trace = bool(args.trace)
    spans = Spans(rec, trace)
    limits = ctx.limits()
    bud = common.budgets(conf, mode)
    im = conf["image_size"]

    pool = scenes.make_pool(traffic["scenes"], common.seed_of(args.seed, 1),
                            conf["num_classes"], conf["num_predicates"])
    sample = judged_batches(pool, batch, args.seed)
    pos_stats = scenes.position_stats(pool, im)

    def weights_for(spec):
        return make_weights(spec, common.seed_of(args.seed, 2), dev,
                            conf["score_bias_std"], pos_stats)

    if args.control:
        return _control(ctx, rec, pool, sample, weights_for, bud, limits)

    from neural_motifs_tpu_torch import config as C
    from neural_motifs_tpu_torch.data.batching import Loader
    from neural_motifs_tpu_torch.evaluation.sg_eval import BasicSceneGraphEvaluator
    from neural_motifs_tpu_torch.models.rel_model import prediction_to_entries
    from neural_motifs_tpu_torch.training.build import build_model
    from neural_motifs_tpu_torch.training.eval_rels import run_batches

    cfg = C.ModelConfig.from_args(common.port_argv(conf, traffic))
    common.check_port_config(cfg, conf, mode)
    max_batches = int(args.seconds * traffic["max_batches_per_s"]) + 8
    stream = scenes.PoolStream(pool, batch * max_batches)
    model = build_model(cfg, scenes.PoolSplit(stream), dev,
                        torch.Generator(device=dev).manual_seed(0))
    spec = spec_of(model)
    weights = weights_for(spec)
    model.load_state_dict(weights, strict=True)
    del weights
    model.eval()

    def loader_for(data):
        return Loader(data, batch, shuffle=False, budgets=cfg.budgets, num_workers=1,
                      drop_last=False)

    # warm-up: the cell's own shapes, through the same loop and evaluator
    warm = scenes.PoolStream(pool, batch * WARMUP_BATCHES)
    warm_eval = BasicSceneGraphEvaluator(mode)

    def warm_consume(b, pred):
        for idx, entry in zip(b.image_ids, prediction_to_entries(pred)):
            warm_eval.evaluate_scene_graph_entry(warm.gt_entry(int(idx)), entry)

    run_batches(model, loader_for(warm), dev, warm_consume)
    common.sync(dev)
    setup_peak = common.peak_bytes(dev)
    rec.setup_s = time.perf_counter() - ctx.t0
    if args.fault:
        _fault(model, args.fault)

    # the window
    evaluator = BasicSceneGraphEvaluator(mode)
    st = {"k": 0, "consumed": 0, "capture": None}
    fwd_t, kept, proposals = {}, {}, {}
    work = [0, 0]                    # valid objects and pairs answered
    slices = Slices(PROFILE_FIRSTS if trace else (), PROFILE_BATCHES, Observer)
    judged_set = set(sample)

    def pre_forward(m, a, kw):
        k = st["k"]
        slices.before(k)
        fwd_t[k] = time.perf_counter()
        st["capture"] = {} if k in judged_set else None
        spans.open("forward")

    def post_forward(m, a, kw, out):
        spans.close("forward")
        if st["capture"] is not None:
            kept[st["k"]] = {"cap": st["capture"]}
        st["k"] += 1

    def keep_det(m, a, out):
        if st["capture"] is not None:
            st["capture"].update(capture_det(out))
        if trace and mode == "sgdet":
            proposals[st["k"]] = out.od_valid.sum(1)

    def keep_ctx(m, a, out):
        if st["capture"] is not None:
            st["capture"]["ctx_obj_dists"] = out.obj_dists
            st["capture"]["ctx_obj_preds"] = out.obj_preds

    hooks = [model.register_forward_pre_hook(pre_forward, with_kwargs=True),
             model.register_forward_hook(post_forward, with_kwargs=True),
             model.detector.register_forward_hook(keep_det),
             model.context.register_forward_hook(keep_ctx)]
    hooks += spans.module(model.context, "context")
    hooks += spans.module(model.union_boxes, "relhead") + spans.module(model.roi_fmap, "relhead")

    def consume(b, pred):
        k = st["consumed"]
        with spans.span("consume"):
            p = host_pred(pred)
            for i, (idx, entry) in enumerate(zip(b.image_ids, prediction_to_entries(pred))):
                rec.attempted += 1
                if not well_formed(p, i, conf["num_classes"]):
                    rec.failed += 1
                    continue
                try:
                    evaluator.evaluate_scene_graph_entry(stream.gt_entry(int(idx)), entry)
                except (IndexError, ValueError):   # an answer the evaluator cannot read
                    rec.failed += 1
            if k in kept:
                kept[k].update(ids=b.image_ids.copy(), pred=p)
            work[0] += int(p["obj_valid"].sum())
            work[1] += int(p["rel_valid"].sum())
            if trace:
                props = proposals.pop(k, None)
                rec.flops += batch_flops(conf, mode, p, None if props is None
                                         else props.cpu().numpy(), bud.max_pairs_eval, im)
        rec.latencies_s.append(time.perf_counter() - fwd_t.pop(k))
        st["consumed"] += 1
        slices.after(k)

    loader_it = iter(loader_for(stream))
    common.reset_peak(dev)
    t_start = time.perf_counter()
    deadline = t_start + args.seconds

    def window_batches():
        while time.perf_counter() < deadline:
            with spans.span("loader_wait"):
                b = next(loader_it)
            yield b

    run_batches(model, window_batches(), dev, consume)
    common.sync(dev)
    rec.window_s = time.perf_counter() - t_start - slices.read_s   # less the slice's reading
    rec.batches = st["consumed"]
    rec.images = rec.batches * batch
    rec.peak_window_bytes = common.peak_bytes(dev)
    rec.device = device_info(dev, max(setup_peak, rec.peak_window_bytes))
    rec.power = power_limit()
    print(f"window: {rec.batches} batches, {work[0] / max(rec.images, 1):.2f} objects and "
          f"{work[1] / max(rec.images, 1):.2f} pairs an image; {rec.power}", flush=True)
    slices.close()
    if trace:
        rec.profile, rec.kernel_bound_ms = slices.read()
    stream.stop()
    with contextlib.suppress(scenes.Stopped, StopIteration):
        for _ in loader_it:
            pass
    for h in hooks:
        h.remove()
    del model, slices
    common.free_device()

    missing = [k for k in sample if "pred" not in kept.get(k, {})]
    if missing:
        raise RuntimeError(f"the window finished {rec.batches} batches; the judged "
                           f"batches {missing} are not among them (--seconds too short)")
    inputs = {k: scenes.collate(pool, k * batch, batch, bud.max_gt_boxes, im)
              for k in sample}
    for k in sample:
        if list(kept[k]["ids"]) != list(range(k * batch, (k + 1) * batch)):
            raise RuntimeError(f"batch {k} held images {list(kept[k]['ids'])}")
    checks = _judge(conf, mode, bud, weights_for(spec),
                    [dict(kept[k], inputs=inputs[k]) for k in sample], dev)
    return _conclude(rec, checks, limits)


def _judge(conf, mode, bud, weights, batches, dev) -> dict:
    ref = judge.build_reference(conf, mode, bud, weights, dev)
    del weights
    out = [judge.judge_batch(ref, mode, common.to_device(b["inputs"], dev), b["cap"],
                             b["pred"]) for b in batches]
    return judge.worst(out)


def _conclude(rec: Record, checks: dict, limits: dict) -> Record:
    rec.checks = common.limited(checks, limits)
    for k, v in checks.items():
        print(f"judged {k}: {v!r}", flush=True)
    rec.correct = rec.failed == 0 and all(v <= lim for v, lim in rec.checks.values())
    return rec


def _control(ctx, rec, pool, sample, weights_for, bud, limits) -> Record:
    """`--control fp8`: the reference at fp8 in the program's place on the
    judged batches, judged as the program is. No window."""
    from benchmark.reference import common as ref_common
    conf, traffic, dev = ctx.conf, ctx.traffic, ctx.device
    mode, batch, im = traffic["mode"], traffic["batch"], conf["image_size"]
    spec = judge.reference_spec(conf, mode, bud)
    kept = []
    ref_common.set_precision("fp8")
    lowp = judge.build_reference(conf, mode, bud, weights_for(spec), dev)
    for k in sample:
        inputs = scenes.collate(pool, k * batch, batch, bud.max_gt_boxes, im)
        d = common.to_device(inputs, dev)
        pred, cap = (lowp(**d) if mode == "predcls" else lowp(d["images"], d["im_hw"]))
        kept.append({"inputs": inputs, "cap": cap, "pred": host_pred(pred)})
        rec.attempted += batch
    del lowp
    common.free_device()
    ref_common.set_precision("f32")
    checks = _judge(conf, mode, bud, weights_for(spec), kept, dev)
    rec.device = device_info(dev, common.peak_bytes(dev))
    return _conclude(rec, checks, limits)
