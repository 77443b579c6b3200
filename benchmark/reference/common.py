"""Constants, layers and random draws shared by the plain reference.

The reference is a frozen copy of the port's model code (its plain kernel
versions only), computed in float32 with TF32 off. It imports torch and
numpy and nothing of the program.

`set_precision("fp8")` turns it into the benchmark's lower-precision
control: every conv and fc layer that the configuration computes in bf16
takes its input and its weight through float8 e4m3 (each tensor scaled by
its absmax to e4m3's largest value, 448), then multiplies in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

Tensor = torch.Tensor

# The port's constants (neural_motifs_tpu_torch/config.py), fixed at 592
BOX_SCALE = 1024
IM_SCALE = 592
FEAT_STRIDE = 16
BG_THRESH_HI = 0.5
BG_THRESH_LO = 0.0
RPN_POSITIVE_OVERLAP = 0.7
RPN_NEGATIVE_OVERLAP = 0.3
RPN_FG_FRACTION = 0.5
FG_FRACTION = 0.25
ROIS_PER_IMG = 256
RPN_BATCHSIZE = 256
BATCHNORM_MOMENTUM = 0.01
ANCHOR_SIZE = 16
ANCHOR_RATIOS = (0.23232838, 0.63365731, 1.28478321, 3.15089189)
ANCHOR_SCALES = (2.22152954, 4.12315647, 7.21692515, 12.60263013, 22.7102731)
NUM_ANCHORS = len(ANCHOR_RATIOS) * len(ANCHOR_SCALES)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
FP8_MAX = 448.0

_PRECISION = {"mode": "f32"}


def set_precision(mode: str) -> None:
    """'f32' (the reference) or 'fp8' (the control); TF32 off either way."""
    if mode not in ("f32", "fp8"):
        raise ValueError(f"precision {mode!r}")
    _PRECISION["mode"] = mode
    no_tf32()


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: Tensor) -> Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    t = t.float()
    amax = t.abs().amax().clamp_min(1e-30)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def _operands(lowp: bool, *ts):
    if lowp and _PRECISION["mode"] == "fp8":
        return tuple(None if t is None else fp8(t) for t in ts)
    return tuple(None if t is None else t.float() for t in ts)


class Linear(nn.Linear):
    """nn.Linear in f32; `dtype` is the precision the configuration states
    for it (bf16 layers go through fp8 in the control)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.lowp = dtype != torch.float32

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        x, w = _operands(self.lowp, x, self.weight)
        return F.linear(x, w, self.bias.float())


class Conv2d(nn.Conv2d):
    """nn.Conv2d in f32, as `Linear`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.lowp = dtype != torch.float32

    def forward(self, x: Tensor) -> Tensor:
        x, w = _operands(self.lowp, x, self.weight)
        bias = None if self.bias is None else self.bias.float()
        return self._conv_forward(x, w, bias)


def rand_rows(shape: tuple, generator: Optional[torch.Generator] = None,
              device=None) -> Tensor:
    """Uniform [0, 1) f32 draws at `shape` (one process)."""
    return torch.rand(tuple(shape), generator=generator, device=device)


def bernoulli_rows(shape: tuple, p: float, generator: Optional[torch.Generator] = None,
                   device=None, dtype: torch.dtype = torch.float32) -> Tensor:
    """Bernoulli(p) 0 / 1 draws in `dtype` (drawn in the type the program
    draws them in, so that one generator gives both the same masks)."""
    return torch.empty(tuple(shape), dtype=dtype, device=device).bernoulli_(
        p, generator=generator)


def dropout(x: Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            mask_dtype: torch.dtype = torch.float32) -> Tensor:
    """Dropout in training, the mask drawn in `mask_dtype`; x otherwise."""
    if not train or rate == 0.0:
        return x
    keep = bernoulli_rows(x.shape, 1.0 - rate, generator, x.device, mask_dtype)
    return (x * keep.to(x.dtype)) * (1.0 / (1.0 - rate))


def to_onehot(labels: Tensor, num_classes: int, fill: float = 1000.0) -> Tensor:
    hit = F.one_hot(labels.long(), num_classes) > 0
    return torch.where(hit, torch.tensor(fill, device=labels.device),
                       torch.tensor(-fill, device=labels.device))


def all_sum(x: Tensor) -> Tensor:
    """One process: the identity."""
    return x
