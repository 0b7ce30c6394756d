"""Dilated ResNet backbone (NCHW, channels_last memory).

Counterpart of ucd_tpu/models/resnet.py: mod1 stem (7x7 s2 + ABN + 3x3 s2
max-pool) followed by four groups of residual blocks, with dilation
replacing stride in the late groups for output stride 8/16. Submodules are
named after the flax scopes (`mod2_block1.conv1`, `mod1_bn1`, ...) so the
weight bridge (models/convert.py) is a pure name mapping.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ABN, conv, wide_dtype

STRUCTURES = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
    "resnet152": ([3, 8, 36, 3], True),
}


class ResidualBlock(nn.Module):
    """Bottleneck (1x1 -> 3x3 -> 1x1) or basic (3x3 -> 3x3) residual block.
    The last norm of the main path and the projection shortcut have no
    activation; leaky_relu follows the residual add."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 stride: int = 1, dilation: int = 1,
                 activation_param: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or wide_dtype(dtype)
        ch = tuple(channels)
        self.is_bottleneck = len(ch) == 3
        self.activation_param = activation_param
        out_ch = ch[-1]
        self.need_proj = stride != 1 or in_channels != out_ch
        if self.need_proj:
            self.proj_conv = conv(in_channels, out_ch, 1, stride,
                                  dtype=param_dtype)
            self.proj_bn = ABN(out_ch, "identity", dtype=dtype)
        if self.is_bottleneck:
            self.conv1 = conv(in_channels, ch[0], 1, dtype=param_dtype)
            self.bn1 = ABN(ch[0], activation_param=activation_param,
                           dtype=dtype)
            self.conv2 = conv(ch[0], ch[1], 3, stride, dilation,
                              dtype=param_dtype)
            self.bn2 = ABN(ch[1], activation_param=activation_param,
                           dtype=dtype)
            self.conv3 = conv(ch[1], ch[2], 1, dtype=param_dtype)
            self.bn3 = ABN(ch[2], "identity", dtype=dtype)
        else:
            self.conv1 = conv(in_channels, ch[0], 3, stride, dilation,
                              dtype=param_dtype)
            self.bn1 = ABN(ch[0], activation_param=activation_param,
                           dtype=dtype)
            self.conv2 = conv(ch[0], ch[1], 3, 1, dilation,
                              dtype=param_dtype)
            self.bn2 = ABN(ch[1], "identity", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.proj_bn(self.proj_conv(x)) if self.need_proj else x
        y = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(y))
        if self.is_bottleneck:
            y = self.bn3(self.conv3(y))
        return F.leaky_relu(y + residual, self.activation_param)


class ResNet(nn.Module):
    """Four-group dilated ResNet; output stride 8 or 16.

    output_stride 16 -> dilation [1,1,1,2]; 8 -> [1,1,2,4]. Stride 2 goes on
    the first block of every group after the first, while that group's
    dilation is 1.

    The JAX package's `stem_s2d` option computes the same 7x7/s2 stem conv
    space-to-depth packed, a TPU layout over the same (7,7,3,64) parameter
    that is exactly equivalent; the port always computes the plain strided
    conv.

    `dtype` is the compute dtype; `param_dtype` the dtype of the stored conv
    weights (default f32 masters, f64 for the f64 test dtype)."""

    def __init__(self, structure: Sequence[int] = (3, 4, 23, 3),
                 bottleneck: bool = True, output_stride: int = 16,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or wide_dtype(dtype)
        if output_stride == 16:
            dilation = [1, 1, 1, 2]
        elif output_stride == 8:
            dilation = [1, 1, 2, 4]
        else:
            raise ValueError("output stride must be 8 or 16")
        self.out_channels = (256 if bottleneck else 64) * 8

        self.mod1_conv1 = conv(3, 64, 7, 2, dtype=param_dtype)
        self.mod1_bn1 = ABN(64, dtype=dtype)
        self.block_names = []
        channels = (64, 64, 256) if bottleneck else (64, 64)
        in_ch = 64
        for mod_id, num in enumerate(structure):
            d = dilation[mod_id]
            for block_id in range(num):
                stride = 2 if d == 1 and block_id == 0 and mod_id > 0 else 1
                name = f"mod{mod_id + 2}_block{block_id + 1}"
                self.add_module(name, ResidualBlock(
                    in_ch, channels, stride=stride, dilation=d, dtype=dtype,
                    param_dtype=param_dtype))
                self.block_names.append(name)
                in_ch = channels[-1]
            channels = tuple(c * 2 for c in channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mod1_bn1(self.mod1_conv1(x))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for name in self.block_names:
            y = getattr(self, name)(y)
        return y
