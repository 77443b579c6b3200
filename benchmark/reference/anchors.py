"""Anchor generation for the single-level (stride 16) RPN — the port's
ops/anchors.py. Returns [H, W, A, 4] float32 anchors in
(x1, y1, x2, y2) with the pixel-inclusive convention."""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference.common import (ANCHOR_RATIOS, ANCHOR_SCALES, ANCHOR_SIZE,
                                        FEAT_STRIDE, IM_SCALE)


def generate_base_anchors(base_size: int = ANCHOR_SIZE,
                          ratios=ANCHOR_RATIOS,
                          scales=ANCHOR_SCALES) -> np.ndarray:
    """[A, 4] anchors around the (0,0,base-1,base-1) reference window:
    w = sqrt(base^2 / r), h = w * r, then each scale multiplies (w, h)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    ctr = (base_size - 1) / 2.0

    ws = np.sqrt(base_size * base_size / ratios)
    hs = ws * ratios
    ws = (ws[:, None] * scales[None, :]).reshape(-1)
    hs = (hs[:, None] * scales[None, :]).reshape(-1)
    anchors = np.stack([
        ctr - 0.5 * (ws - 1),
        ctr - 0.5 * (hs - 1),
        ctr + 0.5 * (ws - 1),
        ctr + 0.5 * (hs - 1),
    ], axis=1)
    return anchors.astype(np.float32)


@functools.lru_cache(maxsize=8)
def generate_anchors(base_size: int = ANCHOR_SIZE,
                     feat_stride: int = FEAT_STRIDE,
                     im_scale=IM_SCALE,
                     anchor_scales=ANCHOR_SCALES,
                     anchor_ratios=ANCHOR_RATIOS) -> np.ndarray:
    """[H, W, A, 4] anchor grid: base anchors shifted by (x*stride,
    y*stride). `im_scale` is the square image size or an (im_h, im_w)
    tuple. The cached array is shared: callers must not write to it."""
    base = generate_base_anchors(base_size, anchor_ratios, anchor_scales)
    im_h, im_w = ((im_scale, im_scale) if isinstance(im_scale, int)
                  else im_scale)
    shift_y = np.arange(im_h // feat_stride, dtype=np.float32) * feat_stride
    shift_x = np.arange(im_w // feat_stride, dtype=np.float32) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)
    return (shifts[:, :, None, :] + base[None, None]).astype(np.float32)
