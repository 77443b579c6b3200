"""RoIAlign — crop-and-resize RoI pooling (counterpart of
neural_motifs_tpu/ops/roi_align.py and ops/pallas_roi_align.py).

The sample grid in feature-map coordinates is u_p = linspace(x1*s, x2*s, P)
per axis (s = spatial_scale, P = crop size), with bilinear interpolation
between the two neighbouring cells and zero extrapolation outside
[0, dim-1]; an invalid RoI gives zeros.

Two evaluations of the same function:
  * `_roi_align_matmul`, the plain separable form: per-RoI interpolation
    matrices R_y [P, H] and R_x [P, W] and out[r] = R_y[r] @ fmap @ R_x[r]^T.
    It runs for CPU tensors, in `roi_align_chunk` chunks of RoIs.
  * `roi_align_cuda`, the hand-written gather-and-lerp kernel
    (csrc/roi_align.cu: the taps gathered from a shared-memory copy of a
    channel slice of the map, or from device memory for a map too large
    for that) that replaces the Pallas `pallas_roi_align`. It runs for
    CUDA tensors, unchunked: it keeps no [R, P, W, C] intermediate.

The sample coordinates are always computed in f32 from f32 RoIs, whatever
the feature map's type.
"""

from __future__ import annotations

import torch

from neural_motifs_tpu_torch.ops import _cuda

Tensor = torch.Tensor


def interp_matrix(lo: Tensor, hi: Tensor, out_size: int, grid_size: int) -> Tensor:
    """Tent-weight interpolation matrix [..., out_size, grid_size] for
    sample intervals [lo, hi] (grid coordinates); rows sum to 1 for
    in-range samples and to 0 for out-of-range ones."""
    p = torch.arange(out_size, dtype=lo.dtype, device=lo.device)
    step = (hi - lo) / (out_size - 1)
    u = lo[..., None] + p * step[..., None]                     # [..., P]
    c = torch.arange(grid_size, dtype=lo.dtype, device=lo.device)
    w = torch.clamp(1.0 - torch.abs(u[..., None] - c), min=0.0)  # [..., P, G]
    in_range = (u >= 0.0) & (u <= grid_size - 1.0)
    return w * in_range[..., None]


def _roi_align_matmul(fmap: Tensor, rois: Tensor, valid: Tensor | None,
                      out_size: int, spatial_scale: float) -> Tensor:
    """Plain separable form: fmap [B,H,W,C], rois [B,R,4] -> [B,R,P,P,C]
    in the fmap's type (weights built in f32)."""
    _, h, w, _ = fmap.shape
    rois = rois.float()
    ry = interp_matrix(rois[..., 1] * spatial_scale,
                       rois[..., 3] * spatial_scale, out_size, h)   # [B,R,P,H]
    rx = interp_matrix(rois[..., 0] * spatial_scale,
                       rois[..., 2] * spatial_scale, out_size, w)   # [B,R,P,W]
    if valid is not None:
        ry = ry * valid[..., None, None]
    ry = ry.to(fmap.dtype)
    rx = rx.to(fmap.dtype)
    t = torch.einsum("brph,bhwc->brpwc", ry, fmap)
    return torch.einsum("brpwc,brqw->brpqc", t, rx)


def roi_align_cuda(fmap: Tensor, rois: Tensor, valid: Tensor | None,
                   out_size: int, spatial_scale: float) -> Tensor:
    """Launch the RoIAlign kernel: fmap [B,H,W,C] f32/bf16 on CUDA, rois
    [B,R,4], valid [B,R] bool or None -> [B,R,P,P,C] in the fmap's type."""
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align_cuda: fmap must be f32 or bf16, got {fmap.dtype}")
    if fmap.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4 \
            or rois.shape[0] != fmap.shape[0]:
        raise ValueError(f"roi_align_cuda: bad shapes fmap {tuple(fmap.shape)} "
                         f"rois {tuple(rois.shape)}")
    if out_size < 2:
        raise ValueError("roi_align_cuda: out_size must be >= 2")
    b, h, w, c = fmap.shape
    r = rois.shape[1]
    fmap = fmap.contiguous()
    rois = rois.float().contiguous()
    if valid is None:
        valid = torch.ones((b, r), dtype=torch.bool, device=rois.device)
    valid = valid.contiguous()
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, r):
        raise ValueError("roi_align_cuda: valid must be a [B, R] bool tensor")
    _cuda.require_cuda("roi_align_cuda", fmap, rois, valid)
    out = torch.empty((b, r, out_size, out_size, c), dtype=fmap.dtype,
                      device=fmap.device)
    code = _cuda.lib().nm_roi_align_fwd(
        fmap.data_ptr(), rois.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, h, w, c, r, out_size, float(spatial_scale),
        int(fmap.dtype == torch.bfloat16), _cuda.stream_ptr(fmap.device))
    _cuda.check(code, "roi_align_cuda")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def roi_align(fmap: Tensor, rois: Tensor, valid: Tensor | None, out_size: int,
              spatial_scale: float, chunk: int = 512) -> Tensor:
    """Crop-and-resize RoI pooling.

    fmap: [B, H, W, C] (NHWC); rois: [B, R, 4] image-coordinate boxes
    (x1, y1, x2, y2); valid: [B, R] bool or None. Returns
    [B, R, out_size, out_size, C] in the fmap's type.

    A CUDA tensor goes to the kernel; a CPU tensor to the separable form,
    `chunk` RoIs at a time so its [B, R, P, W, C] intermediate stays
    bounded. The kernel has no backward: relation training reads the
    feature map and the boxes as constants, and a CUDA input that needs a
    gradient raises.
    """
    if fmap.is_cuda:
        if torch.is_grad_enabled() and (fmap.requires_grad or rois.requires_grad):
            raise NotImplementedError(
                "roi_align: the CUDA kernel has no backward yet (detector "
                "training, ROADMAP item 13)")
        return roi_align_cuda(fmap, rois, valid, out_size, spatial_scale)
    r = rois.shape[1]
    if not chunk or r <= chunk:
        return _roi_align_matmul(fmap, rois, valid, out_size, spatial_scale)
    parts = []
    for s0 in range(0, r, chunk):
        sl = slice(s0, min(s0 + chunk, r))
        parts.append(_roi_align_matmul(
            fmap, rois[:, sl], None if valid is None else valid[:, sl],
            out_size, spatial_scale))
    return torch.cat(parts, dim=1)
