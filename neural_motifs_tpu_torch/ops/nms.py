"""Greedy NMS, batched over lanes, on the device with no host round-trip
(counterpart of neural_motifs_tpu/ops/nms.py and ops/pallas_nms.py).

Two functions carry a kernel each:
  * `greedy_nms_mask` — exact greedy NMS over [L, N] lanes. CUDA tensors go
    to `greedy_nms_cuda` (csrc/nms.cu: a 64-bit suppression mask over the
    upper triangle, then a scan that resolves 64-box chunks in shared
    memory; replacing the Pallas `pallas_greedy_nms`); CPU tensors to
    `_greedy_nms_plain`, the tiled fixpoint of the JAX `greedy_nms_mask`.
  * `perclass_nms` — exact greedy NMS over score-sorted per-class
    candidates. CUDA tensors go to `perclass_nms_cuda` (csrc/nms.cu: one
    block a lane walks 64-rank chunks in shared memory, replacing the
    Pallas `pallas_perclass_nms`); CPU tensors to `_perclass_nms_plain`,
    the rank-sequential pass of the Pallas kernel.

Ties: `lax.top_k` puts the lower index first and `jnp.argsort` is stable,
so every ranking here is `torch.sort(..., descending=True, stable=True)`.
"""

from __future__ import annotations

import torch

from neural_motifs_tpu_torch.ops import _cuda
from neural_motifs_tpu_torch.ops.boxes import area, bbox_overlaps

Tensor = torch.Tensor

NEG_INF = -1e10
_MAX_PERCLASS_K = 2048     # a lane's shared memory: 20 bytes a candidate, 43 KB
_MAX_GREEDY_N = 43000      # the mask scratch is N^2/8 bytes a lane (231 MB here)


def sort_desc(x: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    """Descending sort that keeps equal keys in index order (the tie rule
    of lax.top_k and of a stable argsort of the negated key)."""
    out = torch.sort(x, dim=dim, descending=True, stable=True)
    return out.values, out.indices


def _fixpoint_alive(sup: Tensor, v: Tensor) -> Tensor:
    """alive_{k+1}[j] = v[j] & !any_i(alive_k[i] & sup[i, j]) until it stops
    changing: the exact greedy solution (syncs once per sweep)."""
    alive = v
    for _ in range(sup.shape[-1] + 1):
        new = v & ~torch.any(sup & alive[..., :, None], dim=-2)
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def _greedy_nms_plain(boxes: Tensor, scores: Tensor, valid: Tensor,
                      iou_thresh: float, tile: int = 128) -> Tensor:
    """The JAX greedy_nms_mask's tiled fixpoint, batched over lanes: boxes in
    score order, a tile's internal suppression resolved by a fixpoint on
    [tile, tile], then its survivors kill all later boxes in one sweep."""
    l, n, _ = boxes.shape
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    _, order = sort_desc(masked, dim=1)
    b = boxes.gather(1, order[..., None].expand(l, n, 4))
    alive = valid.gather(1, order)
    tri = torch.arange(min(tile, n), device=boxes.device)
    upper = tri[:, None] < tri[None, :]
    col = torch.arange(n, device=boxes.device)
    for s in range(0, n, tile):
        e = min(s + tile, n)
        tb = b[:, s:e]
        ta = alive[:, s:e]
        k = e - s
        sup = (bbox_overlaps(tb, tb) > iou_thresh) & upper[:k, :k]
        sup = sup & ta[:, :, None] & ta[:, None, :]
        ta = _fixpoint_alive(sup, ta)
        alive = torch.cat([alive[:, :s], ta, alive[:, e:]], dim=1)
        kill = torch.any(ta[:, :, None] & (bbox_overlaps(tb, b) > iou_thresh),
                         dim=1)
        alive = alive & ~(kill & (col >= e))
    return torch.zeros_like(valid).scatter(1, order, alive)


def greedy_nms_cuda(boxes: Tensor, scores: Tensor, valid: Tensor,
                    iou_thresh: float) -> Tensor:
    """Launch the greedy NMS kernels (K3): boxes [L,N,4], scores [L,N],
    valid [L,N] bool on CUDA -> keep [L,N] bool in the original order."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or scores.shape != boxes.shape[:2] or valid.shape != scores.shape:
        raise ValueError("greedy_nms_cuda: expected boxes [L,N,4], "
                         "scores/valid [L,N]")
    if valid.dtype != torch.bool:
        raise TypeError("greedy_nms_cuda: valid must be bool")
    l, n, _ = boxes.shape
    if n > _MAX_GREEDY_N:
        raise ValueError(f"greedy_nms_cuda: N={n} exceeds {_MAX_GREEDY_N}")
    masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    _, order = sort_desc(masked, dim=1)
    b_sorted = boxes.float().gather(1, order[..., None].expand(l, n, 4)).contiguous()
    v_sorted = valid.gather(1, order).contiguous()
    _cuda.require_cuda("greedy_nms_cuda", b_sorted, v_sorted)
    words = (n + 63) // 64
    words += words % 2          # 16-byte mask rows for the scan's bulk copies
    mask = torch.empty((l, n, words), dtype=torch.int64, device=boxes.device)
    keep_sorted = torch.empty((l, n), dtype=torch.bool, device=boxes.device)
    code = _cuda.lib().nm_greedy_nms(
        b_sorted.data_ptr(), v_sorted.data_ptr(), mask.data_ptr(),
        keep_sorted.data_ptr(), l, n, float(iou_thresh),
        _cuda.stream_ptr(boxes.device))
    _cuda.check(code, "greedy_nms_cuda")
    greedy_nms_cuda.launches += 1
    return torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)


greedy_nms_cuda.launches = 0


def greedy_nms_mask(boxes: Tensor, scores: Tensor, valid: Tensor,
                    iou_thresh: float) -> Tensor:
    """Exact greedy NMS keep mask in the original box order, per lane.

    boxes: [L, N, 4]; scores: [L, N]; valid: [L, N] bool. Invalid rows are
    never kept and never suppress.
    """
    if boxes.is_cuda:
        return greedy_nms_cuda(boxes, scores, valid, iou_thresh)
    return _greedy_nms_plain(boxes, scores, valid, iou_thresh)


def nms_topk(boxes: Tensor, scores: Tensor, valid: Tensor, iou_thresh: float,
             pre_topn: int, post_topn: int) -> tuple[Tensor, Tensor]:
    """Score-sort, keep the top pre_topn, greedy-suppress, return the
    post_topn surviving indices (into the original arrays) in score order.

    boxes [L, N, 4], scores/valid [L, N] -> (indices [L, post_topn] int64,
    keep_valid [L, post_topn] bool). Padded slots point at index 0.
    """
    l, n = scores.shape
    pre = min(pre_topn, n)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = sort_desc(masked, dim=1)
    top_scores, top_idx = top_scores[:, :pre], top_idx[:, :pre]
    top_valid = top_scores > NEG_INF / 2
    top_boxes = boxes.gather(1, top_idx[..., None].expand(l, pre, 4))
    keep = greedy_nms_mask(top_boxes, top_scores, top_valid, iou_thresh)

    kscore = torch.where(keep, top_scores, torch.full_like(top_scores, NEG_INF))
    _, sel = sort_desc(kscore, dim=1)
    sel = sel[:, :min(post_topn, pre)]
    out_idx = top_idx.gather(1, sel)
    out_valid = keep.gather(1, sel)
    if post_topn > pre:
        pad = post_topn - pre
        out_idx = torch.cat([out_idx, out_idx.new_zeros((l, pad))], 1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((l, pad))], 1)
    return out_idx, out_valid


def _perclass_nms_plain(boxes: Tensor, valid: Tensor, iou_thresh: float) -> Tensor:
    """Rank-sequential greedy pass, vectorised over lanes: boxes [..., K, 4]
    sorted by descending score along K, valid [..., K] -> keep [..., K]."""
    k = boxes.shape[-2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    ar = area(boxes)
    col = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        bx1, by1 = x1[..., i:i + 1], y1[..., i:i + 1]
        bx2, by2 = x2[..., i:i + 1], y2[..., i:i + 1]
        iw = torch.minimum(bx2, x2) - torch.maximum(bx1, x1) + 1.0
        ih = torch.minimum(by2, y2) - torch.maximum(by1, y1) + 1.0
        inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
        iou = inter / torch.clamp(ar[..., i:i + 1] + ar - inter, min=1e-8)
        kill = (iou > iou_thresh) & (col > i) & keep[..., i:i + 1]
        keep = keep & ~kill
    return keep


def perclass_nms_cuda(boxes: Tensor, valid: Tensor, iou_thresh: float) -> Tensor:
    """Launch the per-class NMS kernel (K2): boxes [B,C,K,4] sorted by
    descending score within each (b, c), valid [B,C,K] bool on CUDA ->
    keep [B,C,K] bool."""
    if boxes.dim() != 4 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:3]:
        raise ValueError("perclass_nms_cuda: expected boxes [B,C,K,4], valid [B,C,K]")
    if valid.dtype != torch.bool:
        raise TypeError("perclass_nms_cuda: valid must be bool")
    b, c, k, _ = boxes.shape
    if k > _MAX_PERCLASS_K:
        raise ValueError(f"perclass_nms_cuda: K={k} exceeds {_MAX_PERCLASS_K}")
    boxes = boxes.float().contiguous()
    valid = valid.contiguous()
    _cuda.require_cuda("perclass_nms_cuda", boxes, valid)
    keep = torch.empty((b, c, k), dtype=torch.bool, device=boxes.device)
    code = _cuda.lib().nm_perclass_nms(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b * c, k,
        float(iou_thresh), _cuda.stream_ptr(boxes.device))
    _cuda.check(code, "perclass_nms_cuda")
    perclass_nms_cuda.launches += 1
    return keep


perclass_nms_cuda.launches = 0


def perclass_nms(boxes: Tensor, valid: Tensor, iou_thresh: float) -> Tensor:
    """Exact greedy keep mask over score-sorted-per-class candidates:
    boxes [B, C, K, 4], valid [B, C, K] bool -> keep [B, C, K] bool."""
    if boxes.is_cuda:
        return perclass_nms_cuda(boxes, valid, iou_thresh)
    return _perclass_nms_plain(boxes, valid, iou_thresh)


def per_class_nms_mask(boxes_per_cls: Tensor, probs: Tensor, valid: Tensor,
                       iou_thresh: float = 0.3, score_thresh: float = 0.05,
                       per_class_topk: int | None = 256) -> Tensor:
    """Per-class NMS keep mask over [B, N, C] detections (the per-class loop
    of the reference filter_det): for every non-background class, greedy
    NMS over (boxes[:, :, c], probs[:, :, c]). Classes whose max prob over
    valid rows is <= score_thresh are dropped; background is never kept.

    per_class_topk restricts each class's NMS to its top-K candidates by
    probability (exact for the top-K; None = the fully exact variant).

    boxes_per_cls: [B, N, C, 4]; probs: [B, N, C]; valid: [B, N].
    Returns keep: [B, N, C] bool.
    """
    b, n, c = probs.shape
    k = per_class_topk
    if k is None or k >= n:
        lanes_boxes = boxes_per_cls.permute(0, 2, 1, 3).reshape(b * c, n, 4)
        lanes_probs = probs.permute(0, 2, 1).reshape(b * c, n)
        lanes_valid = valid[:, None, :].expand(b, c, n).reshape(b * c, n)
        keep = greedy_nms_mask(lanes_boxes, lanes_probs, lanes_valid, iou_thresh)
        keep = keep.reshape(b, c, n)
    else:
        p = torch.where(valid[:, :, None], probs, torch.full_like(probs, -1.0))
        top_p, top_i = sort_desc(p.transpose(1, 2), dim=2)       # [B, C, N]
        top_p, top_i = top_p[..., :k], top_i[..., :k]            # [B, C, K]
        bc = boxes_per_cls.permute(0, 2, 1, 3).gather(
            2, top_i[..., None].expand(b, c, k, 4))              # [B, C, K, 4]
        keep_k = perclass_nms(bc, top_p >= 0.0, iou_thresh)
        keep = torch.zeros((b, c, n), dtype=torch.bool, device=probs.device)
        keep = keep.scatter(2, top_i, keep_k)
    keep = keep.transpose(1, 2)                                   # [B, N, C]
    cls_ok = torch.amax(torch.where(valid[:, :, None], probs,
                                    torch.zeros_like(probs)), dim=1) > score_thresh
    keep = keep & cls_ok[:, None, :]
    keep[..., 0] = False
    return keep
