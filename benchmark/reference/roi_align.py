"""RoIAlign, the plain separable form of the port's ops/roi_align.py
(`_roi_align_matmul`): the sample grid in feature-map coordinates is
u_p = linspace(x1*s, x2*s, P) per axis, bilinear between the two
neighbouring cells, zero outside [0, dim-1]; an invalid RoI gives zeros.
The map gets a gradient and the boxes none, as in the port.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def interp_matrix(lo: Tensor, hi: Tensor, out_size: int, grid_size: int) -> Tensor:
    """Tent-weight interpolation matrix [..., out_size, grid_size]."""
    p = torch.arange(out_size, dtype=lo.dtype, device=lo.device)
    step = (hi - lo) / (out_size - 1)
    u = lo[..., None] + p * step[..., None]
    c = torch.arange(grid_size, dtype=lo.dtype, device=lo.device)
    w = torch.clamp(1.0 - torch.abs(u[..., None] - c), min=0.0)
    in_range = (u >= 0.0) & (u <= grid_size - 1.0)
    return w * in_range[..., None]


def _roi_align_matmul(fmap: Tensor, rois: Tensor, valid: Tensor | None,
                      out_size: int, spatial_scale: float) -> Tensor:
    _, h, w, _ = fmap.shape
    rois = rois.float()
    ry = interp_matrix(rois[..., 1] * spatial_scale,
                       rois[..., 3] * spatial_scale, out_size, h)
    rx = interp_matrix(rois[..., 0] * spatial_scale,
                       rois[..., 2] * spatial_scale, out_size, w)
    if valid is not None:
        ry = ry * valid[..., None, None]
    ry = ry.to(fmap.dtype)
    rx = rx.to(fmap.dtype)
    t = torch.einsum("brph,bhwc->brpwc", ry, fmap)
    return torch.einsum("brpwc,brqw->brpqc", t, rx)


def roi_align(fmap: Tensor, rois: Tensor, valid: Tensor | None, out_size: int,
              spatial_scale: float, chunk: int = 128) -> Tensor:
    """fmap [B, H, W, C], rois [B, R, 4], valid [B, R] -> [B, R, P, P, C],
    `chunk` RoIs at a time."""
    rois = rois.detach()
    r = rois.shape[1]
    parts = []
    for s0 in range(0, r, chunk):
        sl = slice(s0, min(s0 + chunk, r))
        parts.append(_roi_align_matmul(
            fmap, rois[:, sl], None if valid is None else valid[:, sl],
            out_size, spatial_scale))
    return torch.cat(parts, dim=1)
