"""VGG16 conv trunk and RoI fc head (a copy of the port's
models/backbone.py), in f32. Images and maps are NHWC at the boundary;
the fc head flattens (h, w, c)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from benchmark.reference.common import Conv2d, Linear, dropout

Tensor = torch.Tensor

VGG16_CFG: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512, "M", 512, 512, 512)


def to_nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class VGG16Features(nn.Module):
    """Images [B, H, W, 3] -> stride-16 map [B, H/16, W/16, 512]."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        convs = []
        c_in = 3
        for v in VGG16_CFG:
            if v != "M":
                convs.append(Conv2d(c_in, v, 3, padding=1, dtype=dtype))
                c_in = v
        self.convs = nn.ModuleList(convs)

    def forward(self, images: Tensor) -> Tensor:
        x = to_nchw(images.float()).contiguous()
        convs = iter(self.convs)
        for v in VGG16_CFG:
            if v == "M":
                x = nn.functional.max_pool2d(x, 2, 2)
            else:
                x = torch.relu(next(convs)(x))
        return to_nhwc(x)


class VGGRoIHead(nn.Module):
    """Flatten (h, w, c) -> fc0 -> ReLU -> dropout -> fc1 -> ReLU ->
    dropout; the masks drawn in the configuration's dtype, as the port
    draws them."""

    def __init__(self, in_dim: int = 7 * 7 * 512, fc_dim: int = 4096,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.mask_dtype = dtype
        self.dropout_rate = 0.5
        self.fc0 = Linear(in_dim, fc_dim, dtype=dtype)
        self.fc1 = Linear(fc_dim, fc_dim, dtype=dtype)

    def forward(self, x: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        x = x.reshape(x.shape[:-3] + (-1,))
        x = dropout(torch.relu(self.fc0(x)), self.dropout_rate, train, generator,
                    self.mask_dtype)
        return dropout(torch.relu(self.fc1(x)), self.dropout_rate, train, generator,
                       self.mask_dtype)
