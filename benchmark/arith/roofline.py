"""Peaks of one H100 SXM and the least time of each kernel launch, copied
from the port's chip_smoke.py (`bound`, `roi_align_bound`,
`roi_align_bwd_bound`, `greedy_pairs`, `nms_bound`) with the bf16 dense
peak added."""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 dense, the tensor cores
# f32 operations of one +1-convention IoU test: per axis min, max, sub, +1
# (8); two clamps and the product (3); union add, sub, clamp (3); the
# division; the comparison with the threshold
IOU_OPS = 16
# f32 operations of one RoIAlign output value: three lerps w0 * a + w1 * b
LERP_OPS = 9

# substrings of the kernels' names in a device trace, by task
KERNEL_NAMES = {
    "roi_align_fwd": ("roi_align_fwd_kernel", "roi_align_smem_kernel"),
    "roi_align_bwd": ("roi_align_bwd_kernel", "roi_align_bwd_smem_kernel",
                      "cast_bf16_kernel"),
    "perclass_nms": ("perclass_nms_kernel",),
    "greedy_nms": ("nms_mask_kernel", "nms_scan_kernel"),
}


def bound(n_bytes: float, n_ops: float) -> tuple:
    """The least time (ms): bytes over the HBM rate or f32 operations over
    the f32 peak, whichever is larger, and which it is."""
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
    """The upstream gradient read once, the RoIs and flags, the map's
    gradient written once; per gradient value two tap products and four
    weighted adds (10 f32 operations)."""
    n_g = b * r * p * p * c
    return bound(n_g * elem + b * r * (4 * 4 + 1) + b * h * w * c * elem, n_g * 10)


def greedy_pairs(keep_sorted: torch.Tensor, valid_sorted: torch.Tensor) -> int:
    """The IoU tests this data needs: every kept box against each valid box
    ranked after it (a suppressed box suppresses nothing)."""
    v = valid_sorted.long()
    later = v.flip(-1).cumsum(-1).flip(-1) - v
    return int((later * keep_sorted.long()).sum())


def nms_bound(n_boxes: int, bytes_per_box: int, pairs: int) -> tuple:
    return bound(n_boxes * bytes_per_box, pairs * IOU_OPS)


def kernel_share(bound_ms: float, kernel_s: dict) -> float | None:
    """The launches' summed bounds over the device time of the kernels of
    their tasks (kernel_s: device seconds by kernel name), in %."""
    names = [s for subs in KERNEL_NAMES.values() for s in subs]
    t = sum(v for k, v in kernel_s.items() if any(s in k for s in names))
    return None if t <= 0 or bound_ms <= 0 else 100.0 * bound_ms / (t * 1e3)
