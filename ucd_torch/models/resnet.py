"""Dilated ResNet backbone (NCHW, channels_last memory).

Counterpart of ucd_tpu/models/resnet.py: mod1 stem (7x7 s2 + ABN + 3x3 s2
max-pool) followed by four groups of residual blocks, with dilation
replacing stride in the late groups for output stride 8/16. Submodules are
named after the flax scopes (`mod2_block1.conv1`, `mod1_bn1`, ...) so the
weight bridge (models/convert.py) is a pure name mapping.

The JAX package's execution options are the constructor's: `stem_s2d`
(the stem conv space-to-depth packed, `S2DStemConv`), `remat` (every
residual block rematerialized in the backward) and `remat_early` (the
mod2 group only), `norm_dtype` and `norm_dtype_early` (the dtype the ABNs
round their normalized output to; the early one for the stem and mod2).

On the 2-D mesh (`mesh`, set by models/layers.py `use_mesh`) a block
takes its input whole or as a channel shard and returns its output as
its last conv's output is held: a shard where that conv is sharded. Each
conv takes its input through `conv_input` (one gather of a shard for all
the block's convs); the residual sum adds shards of one channel split:
the last conv and the shortcut have as many output channels, so
`channel_sharding` shards both or neither. Off the mesh every model-axis
helper is the identity, and the forward is the plain one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import copy_to_model
from .layers import (ABN, Conv2d, conv, conv_input, is_sharded,
                     remat_contexts, whole, wide_dtype)

STRUCTURES = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
    "resnet152": ([3, 8, 36, 3], True),
}


class S2DStemConv(Conv2d):
    """The stem's 7x7/stride-2 conv computed space-to-depth packed, over the
    same (64, 3, 7, 7) parameter as the plain conv.

    Packing 2x2 pixel blocks into channels turns the conv into an exactly
    equivalent 4x4 stride-1 conv on (4C, H/2, W/2):

        y[p,q] = sum_{u,v} W[u,v] x[2p+u-3, 2q+v-3]
               = sum_{i,j,a,b} W[2i+a-1, 2j+b-1] X[(c,a,b), p+i-2, q+j-2]

    with the kernel zero where 2i+a-1 or 2j+b-1 falls outside [0, 6] and
    padding (2, 1) on each spatial axis (ucd_tpu/models/resnet.py
    `S2DStemConv`). `pixel_unshuffle` packs channels as (c, a, b), where the
    JAX code packs (a, b, c); the kernel's reorder follows the packing. An
    odd H or W computes the plain conv, as the JAX module does."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 7, stride=2, padding=3,
                         bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.weight.dtype == x.dtype \
            else self.weight.to(x.dtype)
        if x.shape[2] % 2 or x.shape[3] % 2:
            return self._conv_forward(x, w, None)
        o, c = w.shape[:2]
        # (o, c, 9, 9) -> rows/cols 2i+a of the padded kernel
        k = F.pad(w, (1, 1, 1, 1))[:, :, :8, :8].reshape(o, c, 4, 2, 4, 2)
        k = k.permute(0, 1, 3, 5, 2, 4).reshape(o, 4 * c, 4, 4)
        xp = F.pad(F.pixel_unshuffle(x, 2), (2, 1, 2, 1))
        return F.conv2d(xp, k)


class ResidualBlock(nn.Module):
    """Bottleneck (1x1 -> 3x3 -> 1x1) or basic (3x3 -> 3x3) residual block.
    The last norm of the main path and the projection shortcut have no
    activation; leaky_relu follows the residual add."""

    mesh = None

    def __init__(self, in_channels: int, channels: Sequence[int],
                 stride: int = 1, dilation: int = 1,
                 activation_param: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 norm_dtype: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or wide_dtype(dtype)
        ch = tuple(channels)
        self.is_bottleneck = len(ch) == 3
        self.in_channels = in_channels
        self.activation_param = activation_param
        out_ch = ch[-1]
        self.need_proj = stride != 1 or in_channels != out_ch
        act = dict(activation_param=activation_param, dtype=dtype,
                   norm_dtype=norm_dtype)
        ident = dict(activation="identity", dtype=dtype,
                     norm_dtype=norm_dtype)
        if self.need_proj:
            self.proj_conv = conv(in_channels, out_ch, 1, stride,
                                  dtype=param_dtype)
            self.proj_bn = ABN(out_ch, **ident)
        if self.is_bottleneck:
            self.conv1 = conv(in_channels, ch[0], 1, dtype=param_dtype)
            self.bn1 = ABN(ch[0], **act)
            self.conv2 = conv(ch[0], ch[1], 3, stride, dilation,
                              dtype=param_dtype)
            self.bn2 = ABN(ch[1], **act)
            self.conv3 = conv(ch[1], ch[2], 1, dtype=param_dtype)
            self.bn3 = ABN(ch[2], **ident)
        else:
            self.conv1 = conv(in_channels, ch[0], 3, stride, dilation,
                              dtype=param_dtype)
            self.bn1 = ABN(ch[0], **act)
            self.conv2 = conv(ch[0], ch[1], 3, 1, dilation,
                              dtype=param_dtype)
            self.bn2 = ABN(ch[1], **ident)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.mesh.model_group if self.mesh is not None else None
        xw = whole(x, self.in_channels, group)
        heads = [self.conv1] + ([self.proj_conv] if self.need_proj else [])
        # one gradient sum for the block's sharded convs on its input
        xs = copy_to_model(xw, group) \
            if any(is_sharded(c) for c in heads) else xw

        def first(c):
            return c(xs if is_sharded(c) else xw)

        residual = self.proj_bn(first(self.proj_conv)) if self.need_proj \
            else x
        y = self.bn1(first(self.conv1))
        y = self.bn2(self.conv2(conv_input(y, self.conv2, group)))
        if self.is_bottleneck:
            y = self.bn3(self.conv3(conv_input(y, self.conv3, group)))
        return F.leaky_relu(y + residual, self.activation_param)


class ResNet(nn.Module):
    """Four-group dilated ResNet; output stride 8 or 16.

    output_stride 16 -> dilation [1,1,1,2]; 8 -> [1,1,2,4]. Stride 2 goes on
    the first block of every group after the first, while that group's
    dilation is 1.

    `dtype` is the compute dtype; `param_dtype` the dtype of the stored conv
    weights (default f32 masters, f64 for the f64 test dtype). `remat` /
    `remat_early` rematerialize every block / the mod2 blocks when
    gradients are on (`torch.utils.checkpoint`, non-reentrant, with the
    BatchNorm statistics moved once: models/layers.py).

    On the 2-D mesh (`mesh`) the output is a channel shard where the last
    block's last conv is sharded."""

    mesh = None

    def __init__(self, structure: Sequence[int] = (3, 4, 23, 3),
                 bottleneck: bool = True, output_stride: int = 16,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 stem_s2d: bool = False, remat: bool = False,
                 remat_early: bool = False,
                 norm_dtype: Optional[torch.dtype] = None,
                 norm_dtype_early: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or wide_dtype(dtype)
        early = norm_dtype_early if norm_dtype_early is not None \
            else norm_dtype
        if output_stride == 16:
            dilation = [1, 1, 1, 2]
        elif output_stride == 8:
            dilation = [1, 1, 2, 4]
        else:
            raise ValueError("output stride must be 8 or 16")
        self.out_channels = (256 if bottleneck else 64) * 8

        self.stem_s2d = stem_s2d
        self.mod1_conv1 = S2DStemConv(3, 64, dtype=param_dtype) if stem_s2d \
            else conv(3, 64, 7, 2, dtype=param_dtype)
        self.mod1_bn1 = ABN(64, dtype=dtype, norm_dtype=early)
        self.block_names = []
        self.remat_blocks = set()
        channels = (64, 64, 256) if bottleneck else (64, 64)
        in_ch = 64
        for mod_id, num in enumerate(structure):
            d = dilation[mod_id]
            for block_id in range(num):
                stride = 2 if d == 1 and block_id == 0 and mod_id > 0 else 1
                name = f"mod{mod_id + 2}_block{block_id + 1}"
                self.add_module(name, ResidualBlock(
                    in_ch, channels, stride=stride, dilation=d, dtype=dtype,
                    param_dtype=param_dtype,
                    norm_dtype=early if mod_id == 0 else norm_dtype))
                self.block_names.append(name)
                if remat or (remat_early and mod_id == 0):
                    self.remat_blocks.add(name)
                in_ch = channels[-1]
            channels = tuple(c * 2 for c in channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.mesh.model_group if self.mesh is not None else None
        y = self.mod1_bn1(self.mod1_conv1(
            conv_input(x, self.mod1_conv1, group)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        remat = torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if remat and name in self.remat_blocks:
                # the model has no randomness: no RNG state to carry over
                y = checkpoint(block, y, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=remat_contexts)
            else:
                y = block(y)
        return y
