"""The port's NMS (neural_motifs_tpu_torch.ops.nms) against the JAX XLA
functions and the Pallas kernels in interpret mode, on the CPU. Keep masks
and indices are discrete decisions and must be identical; scores are
uniform random f32 draws, so no two candidates tie. The CUDA kernels are
held against these plain versions in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neural_motifs_tpu.ops import nms as jnms
from neural_motifs_tpu.ops.pallas_nms import pallas_greedy_nms, pallas_perclass_nms
from neural_motifs_tpu_torch.ops import nms as port
from tests.test_boxes import rand_boxes

T = torch.from_numpy


def lanes(rng, l, n, scale=150, p_valid=0.9):
    boxes = np.stack([rand_boxes(rng, n, scale=scale) for _ in range(l)])
    scores = rng.uniform(0, 1, (l, n)).astype(np.float32)
    valid = rng.uniform(0, 1, (l, n)) < p_valid
    return boxes, scores, valid


@pytest.mark.parametrize("n", [64, 300])
def test_greedy_nms_mask_matches_jax(rng, n):
    """Single-tile (n <= 128) and tiled paths, per lane."""
    boxes, scores, valid = lanes(rng, 3, n)
    got = port.greedy_nms_mask(T(boxes), T(scores), T(valid), 0.4).numpy()
    for li in range(3):
        exp = jnms.greedy_nms_mask(jnp.asarray(boxes[li]), jnp.asarray(scores[li]),
                                   jnp.asarray(valid[li]), 0.4)
        np.testing.assert_array_equal(got[li], np.asarray(exp), err_msg=f"lane {li}")


def test_greedy_nms_mask_matches_pallas_interpret(rng):
    boxes, scores, valid = lanes(rng, 2, 300)
    exp = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(valid), 0.4, tile=128, interpret=True)
    got = port.greedy_nms_mask(T(boxes), T(scores), T(valid), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("pre,post", [(200, 50), (40, 64)])
def test_nms_topk_matches_jax(rng, pre, post):
    """Indices and valid flags, including the pad when post > pre."""
    boxes, scores, valid = lanes(rng, 2, 260, scale=300)
    idx, ok = port.nms_topk(T(boxes), T(scores), T(valid), 0.7, pre, post)
    for li in range(2):
        ei, eo = jnms.nms_topk(jnp.asarray(boxes[li]), jnp.asarray(scores[li]),
                               jnp.asarray(valid[li]), 0.7, pre, post)
        np.testing.assert_array_equal(ok[li].numpy(), np.asarray(eo))
        np.testing.assert_array_equal(idx[li].numpy(), np.asarray(ei))


def test_ties_keep_index_order():
    """Equal scores rank the lower index first (lax.top_k's rule): of two
    identical tied boxes NMS keeps the first; the stable sort keeps it."""
    boxes = np.array([[[0, 0, 10, 10]] * 3 + [[50, 50, 60, 60]]], np.float32)
    scores = np.array([[0.5, 0.5, 0.5, 0.5]], np.float32)
    valid = np.ones((1, 4), bool)
    idx, ok = port.nms_topk(T(boxes), T(scores), T(valid), 0.5, 4, 4)
    ei, eo = jnms.nms_topk(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                           jnp.asarray(valid[0]), 0.5, 4, 4)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ei))
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(eo))
    assert idx[0, :2].tolist() == [0, 3] and ok[0].tolist() == [True, True, False, False]
    _, order = port.sort_desc(torch.tensor([0.2, 0.7, 0.2, 0.7]))
    assert order.tolist() == [1, 3, 0, 2]


def perclass_case(rng, b=2, c=5, k=128):
    boxes = np.stack([[rand_boxes(rng, k, scale=120) for _ in range(c)]
                      for _ in range(b)])                       # [B, C, K, 4]
    valid = np.cumsum(np.ones((b, c, k)), -1) <= rng.randint(3, k, (b, c, 1))
    return boxes, valid


def test_perclass_nms_matches_pallas_interpret(rng):
    boxes, valid = perclass_case(rng)
    exp = pallas_perclass_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.4,
                              interpret=True)
    got = port.perclass_nms(T(boxes), T(valid), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("topk", [16, None])
def test_per_class_nms_mask_matches_jax(rng, topk):
    """The filter_det rule set: top-K cut (or exact), cls_ok, background
    never kept; a class with all probs below the threshold is dropped."""
    b, n, c = 2, 40, 6
    boxes = np.stack([[rand_boxes(rng, c, scale=100) for _ in range(n)]
                      for _ in range(b)])                       # [B, N, C, 4]
    probs = rng.dirichlet(np.ones(c), (b, n)).astype(np.float32)
    probs[:, :, 4] *= 0.01                                      # class 4 < thresh
    valid = rng.uniform(0, 1, (b, n)) < 0.85
    got = port.per_class_nms_mask(T(boxes), T(probs), T(valid), 0.3, 0.05,
                                  per_class_topk=topk).numpy()
    for bi in range(b):
        exp = jnms.per_class_nms_mask(jnp.asarray(boxes[bi]), jnp.asarray(probs[bi]),
                                      jnp.asarray(valid[bi]), 0.3, 0.05,
                                      per_class_topk=topk)
        np.testing.assert_array_equal(got[bi], np.asarray(exp), err_msg=f"image {bi}")
    assert not got[..., 0].any() and not got[..., 4].any() and got.any()


def suppression_hits(boxes, thresh):
    """hit[i, j] = IoU(box i, box j) > thresh as the kernels (csrc/nms.cu
    `suppresses`) decide it: f32 with one rounding an operation, the
    division skipped where the boxes do not meet."""
    f = np.float32
    x1, y1, x2, y2 = boxes.astype(np.float32).T
    one = f(1)
    area = ((x2 - x1) + one) * ((y2 - y1) + one)
    iw = (np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None])) + one
    ih = (np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None])) + one
    inter = np.maximum(iw, f(0)) * np.maximum(ih, f(0))
    union = np.maximum((area[:, None] + area[None]) - inter, f(1e-8))
    with np.errstate(invalid="ignore"):
        return np.where(inter == 0, f(0) > f(thresh), (inter / union) > f(thresh))


def chunked_scan_mirror(boxes, scores, valid, thresh):
    """numpy mirror of K3 (csrc/nms.cu) for one lane: 64-bit mask words as
    nms_mask_kernel builds them (IoU of box i with box 64v + k > i, f32
    with one rounding an operation), then nms_scan_kernel's walk: per
    64-box chunk, the warp fixpoint alive = base & ~OR(alive rows) on the
    chunk's own word, then the kept rows ORed into the later words."""
    n = len(scores)
    masked = np.where(valid, scores, -np.inf).astype(np.float32)
    order = np.argsort(-masked, kind="stable")
    v = valid[order]
    hit = suppression_hits(boxes[order], thresh) & np.triu(np.ones((n, n), bool), 1)
    nw = (n + 63) // 64
    words = [[sum(1 << k for k in range(64) if 64 * w + k < n and hit[i, 64 * w + k])
              for w in range(nw)] for i in range(n)]
    removed = [0] * nw
    keep = np.zeros(n, bool)
    for w in range(nw):
        rows = range(64 * w, min(n, 64 * w + 64))
        base = sum(1 << (i - 64 * w) for i in rows if v[i]) & ~removed[w]
        alive = base
        while True:
            sup = 0
            for i in rows:
                if alive >> (i - 64 * w) & 1:
                    sup |= words[i][w]
            nxt = base & ~sup
            if nxt == alive:
                break
            alive = nxt
        for i in rows:
            keep[i] = bool(alive >> (i - 64 * w) & 1)
            if keep[i]:
                for u in range(w + 1, nw):
                    removed[u] |= words[i][u]
    out = np.zeros(n, bool)
    out[order] = keep
    return out


def clustered_lanes(rng, l, n, im=96):
    """RPN-like clustered boxes: n of the 6x6x20 anchors of a 96^2 image,
    decoded with small seeded deltas and clipped."""
    from neural_motifs_tpu_torch.ops.anchors import generate_anchors
    from neural_motifs_tpu_torch.ops.boxes import bbox_preds, clip_boxes
    anchors = generate_anchors(im_scale=im).reshape(-1, 4)
    pick = np.stack([rng.permutation(len(anchors))[:n] for _ in range(l)])
    deltas = (rng.standard_normal((l, n, 4)) * [0.1, 0.1, 0.2, 0.2]).astype(np.float32)
    size = torch.full((l, 1), float(im))
    boxes = clip_boxes(bbox_preds(T(anchors[pick]), T(deltas)), size, size).numpy()
    return boxes, rng.uniform(0, 1, (l, n)).astype(np.float32), rng.uniform(0, 1, (l, n)) < 0.9


@pytest.mark.parametrize("n", [77, 150])
@pytest.mark.parametrize("kind", ["random", "clustered", "at_threshold"])
def test_chunked_scan_mirror_matches_jax(rng, kind, n):
    """The chunked scan of K3, mirrored in numpy, == the JAX greedy_nms_mask
    and the port's plain tiled fixpoint, lane by lane, at t = 0.7 (N not a
    multiple of 64; several chunks)."""
    from tests.test_torch_kernels import at_threshold_boxes
    if kind == "random":
        boxes, scores, valid = lanes(rng, 2, n)
    elif kind == "clustered":
        boxes, scores, valid = clustered_lanes(rng, 2, n)
    else:
        boxes = np.stack([at_threshold_boxes(rng, n) for _ in range(2)])
        if n % 2:
            boxes = np.concatenate([boxes, boxes[:, :1] + 500.0], 1)
        scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
        valid = np.ones((2, n), bool)
    plain = port._greedy_nms_plain(T(boxes), T(scores), T(valid), 0.7).numpy()
    for li in range(2):
        got = chunked_scan_mirror(boxes[li], scores[li], valid[li], 0.7)
        exp = jnms.greedy_nms_mask(jnp.asarray(boxes[li]), jnp.asarray(scores[li]),
                                   jnp.asarray(valid[li]), 0.7)
        np.testing.assert_array_equal(got, np.asarray(exp), err_msg=f"lane {li}")
        np.testing.assert_array_equal(got, plain[li], err_msg=f"lane {li}")
    assert got.any() and not got.all()


def perclass_chunk_mirror(boxes, valid, thresh):
    """numpy mirror of K2's walk (csrc/nms.cu perclass_nms_kernel) for one
    lane of rank-sorted candidates. Per 64-rank chunk: base = the ranks
    still valid and not removed; the tile's bits only between two ranks of
    base (1.); the fixpoint alive = base & ~OR(rows of alive ranks) (2.);
    then every later rank still alive that a kept row hits is removed (3.;
    the kernel tests all kept rows, stopping at the first hit here is the
    same answer)."""
    k = len(valid)
    hit = suppression_hits(boxes, thresh)
    removed = np.zeros(k, bool)
    keep = np.zeros(k, bool)
    for c0 in range(0, k, 64):
        rows = np.arange(c0, min(k, c0 + 64))
        base = valid[rows] & ~removed[rows]
        tile = hit[np.ix_(rows, rows)] & np.triu(np.ones((len(rows),) * 2, bool), 1)
        tile &= base[:, None] & base[None, :]
        alive = base
        for _ in range(65):
            nxt = base & ~(tile & alive[:, None]).any(0)
            if np.array_equal(nxt, alive):
                break
            alive = nxt
        keep[rows] = alive
        for j in range(c0 + 64, k):
            if valid[j] and not removed[j]:
                for i in rows[alive]:
                    if hit[i, j]:
                        removed[j] = True
                        break
    return keep


def perclass_lanes(rng, kind, n_lanes, k):
    """Rank-sorted candidate lanes [lanes, K, 4] and valid flags with holes:
    uniform random boxes, RPN-like clustered ones, or nested pairs whose f32
    IoU is exactly 0.3 (10x3 in 10x10, kept at t = 0.3), 0.4 (10x4) or 0.2
    (10x2), shuffled."""
    from tests.test_torch_kernels import at_threshold_boxes
    if kind == "random":
        boxes, _, _ = lanes(rng, n_lanes, k, scale=120)
    elif kind == "clustered":
        boxes, _, _ = clustered_lanes(rng, n_lanes, k)
    else:   # k even
        boxes = np.stack([at_threshold_boxes(rng, k, PAIRS_03)[rng.permutation(k)]
                          for _ in range(n_lanes)])
    return boxes.astype(np.float32), rng.uniform(0, 1, (n_lanes, k)) < 0.85


PAIRS_03 = ((10, 3), (10, 4), (10, 2))


@pytest.mark.parametrize("k", [100, 150])
@pytest.mark.parametrize("kind", ["random", "clustered", "at_threshold"])
def test_perclass_chunk_mirror_matches_pallas(rng, kind, k):
    """K2's chunk walk, mirrored in numpy lane by lane, == the Pallas
    pallas_perclass_nms in interpret mode and the port's plain
    rank-sequential pass at t = 0.3 (K not a multiple of 64, several
    chunks, valid flags with holes)."""
    boxes, valid = perclass_lanes(rng, kind, 3, k)
    boxes, valid = boxes.reshape(1, 3, k, 4), valid.reshape(1, 3, k)
    exp = np.asarray(pallas_perclass_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.3,
                                         interpret=True))
    plain = port._perclass_nms_plain(T(boxes), T(valid), 0.3).numpy()
    np.testing.assert_array_equal(plain, exp)
    for li in range(3):
        got = perclass_chunk_mirror(boxes[0, li], valid[0, li], 0.3)
        np.testing.assert_array_equal(got, exp[0, li], err_msg=f"lane {li}")
    assert exp.any() and (exp != valid).any(), "the lanes must keep and suppress"


def k2_decision(boxes_p, boxes_q, thresh):
    """numpy mirror of K2's threshold test (csrc/nms.cu k2_hit) on pairs
    of boxes: the +1 IoU terms in f32, then hit = inter > s * uni and
    open = not hit and inter > t * uni, each sign exact (the f64 product of
    two f32 values is exact and a rounded difference keeps its sign)."""
    f = np.float32
    p, q = boxes_p.astype(f), boxes_q.astype(f)
    one = f(1)
    iw = (np.minimum(p[:, 2], q[:, 2]) - np.maximum(p[:, 0], q[:, 0])) + one
    ih = (np.minimum(p[:, 3], q[:, 3]) - np.maximum(p[:, 1], q[:, 1])) + one
    inter = np.maximum(iw, f(0)) * np.maximum(ih, f(0))
    area = lambda b: ((b[:, 2] - b[:, 0]) + one) * ((b[:, 3] - b[:, 1]) + one)
    uni = np.maximum((area(p) + area(q)) - inter, f(1e-8))
    exceeds = lambda x: (inter.astype(np.float64) - np.float64(x) * uni.astype(np.float64)) > 0
    hit = exceeds(np.nextafter(f(thresh), f(np.inf)))
    with np.errstate(invalid="ignore"):
        division = (inter / uni) > f(thresh)
    return hit, ~hit & exceeds(f(thresh)), division


@pytest.mark.parametrize("thresh", [0.3, 0.7, 0.5])
def test_k2_threshold_test_matches_division(rng, thresh):
    """K2's division-free test decides every pair it does not leave open as
    the IEEE division does, on random and clustered pairs and on nested
    pairs at and near the threshold (10x7 in 10x10 is exactly 0.7: open at
    t = 0.7, where the division keeps it); the pairs whose quotient lies
    within one ulp above t are all open, and the division decides them."""
    from tests.test_torch_kernels import at_threshold_boxes, band_pairs
    boxes, _, _ = lanes(rng, 2, 3000, scale=200)
    clustered, _, _ = clustered_lanes(rng, 2, 700)
    nested = at_threshold_boxes(rng, 4000, ((10, 3), (10, 7), (10, 5), (8, 9)))
    p = np.concatenate([boxes[0], clustered[0], nested[:2000]])
    q = np.concatenate([boxes[1], clustered[1], nested[2000:]])
    hit, open_, division = k2_decision(p, q, thresh)
    np.testing.assert_array_equal(hit[~open_], division[~open_])
    assert hit.any() and not division[open_].any() and open_.mean() < 0.2
    outer, inner, up = band_pairs(rng, 400_000, thresh)
    hit, open_, division = k2_decision(outer, inner, thresh)
    assert len(up) > 100 and open_.all() and not hit.any()
    np.testing.assert_array_equal(division, up)
