"""DeepLab-v3 ASPP head (NCHW, channels_last memory).

Counterpart of ucd_tpu/models/deeplab.py: four parallel map convolutions
(1x1 + three 3x3 dilated 6/12/18 at output stride 16, 12/24/32 at os 8),
channel concat -> ABN -> 1x1 reduction, plus a pooling branch. In training,
or without a `pooling_size`, the pooling branch is a true global average
pool broadcast over space; in eval mode with a `pooling_size` it is a VALID
sliding average pool replicate-padded back to the map size. "Training" is
the module's own mode: a model trained under `fix_bn` runs its forward in
eval mode (running statistics, no statistics update, sliding pool) with
gradients still flowing, as the JAX model does with `train and not fix_bn`.

On the 2-D mesh (`mesh`, models/layers.py `use_mesh`) each sharded map
conv gives this rank a slice of its branch, so the rank's concatenation
holds the four branches' slices: `map_bn`'s shard is those channels
(`MAP_BN_GROUPS` groups of the unsharded concatenation, a slice of each;
engine/state.py `shard_rows`), and the gathered concatenation, in rank
order, meets `red_conv`'s weight with its input channels permuted to
match (a GroupNorm `map_bn` is told that its shard holds MAP_BN_GROUPS
runs). Where only `map_bn` is sharded, the whole concatenation is split.
The head takes the body's features whole (models/segmentation.py gathers
them once for the head and the attention maps).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_model, scatter_to_model
from .layers import (ABN, conv, conv_input, global_avg_pool, is_sharded,
                     whole, wide_dtype)

# the branches concatenated in front of `map_bn`
MAP_BN_GROUPS = 4


def gathered_order(channels: int, n_model: int, device=None) -> torch.Tensor:
    """The unsharded concatenation's channel at each place of the
    concatenation gathered from `n_model` ranks that each hold a slice of
    every one of the MAP_BN_GROUPS branches (rank-major: rank, branch,
    slice)."""
    idx = torch.arange(channels, device=device)
    return idx.view(MAP_BN_GROUPS, n_model, -1).transpose(0, 1).reshape(-1)


class DeeplabV3(nn.Module):
    mesh = None

    def __init__(self, in_channels: int, out_channels: int = 256,
                 hidden_channels: int = 256, out_stride: int = 16,
                 pooling_size: Optional[int] = None,
                 activation_param: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 norm_dtype: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or wide_dtype(dtype)
        self.pooling_size = pooling_size
        dilations = [6, 12, 18] if out_stride == 16 else [12, 24, 32]
        hc = hidden_channels
        abn = dict(activation_param=activation_param, dtype=dtype,
                   norm_dtype=norm_dtype)
        self.map_conv0 = conv(in_channels, hc, 1, dtype=param_dtype)
        self.map_conv1 = conv(in_channels, hc, 3, dilation=dilations[0],
                              dtype=param_dtype)
        self.map_conv2 = conv(in_channels, hc, 3, dilation=dilations[1],
                              dtype=param_dtype)
        self.map_conv3 = conv(in_channels, hc, 3, dilation=dilations[2],
                              dtype=param_dtype)
        self.map_bn = ABN(4 * hc, **abn)
        self.red_conv = conv(4 * hc, out_channels, 1, dtype=param_dtype)
        self.global_pooling_conv = conv(in_channels, hc, 1,
                                        dtype=param_dtype)
        self.global_pooling_bn = ABN(hc, **abn)
        self.pool_red_conv = conv(hc, out_channels, 1, dtype=param_dtype)
        self.red_bn = ABN(out_channels, **abn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """`x` whole; on the mesh the output is a channel shard where
        `red_conv` is sharded."""
        group = self.mesh.model_group if self.mesh is not None else None
        branches_sharded = is_sharded(self.map_conv0)
        xs = copy_to_model(x, group) if branches_sharded else x
        out = torch.cat([self.map_conv0(xs), self.map_conv1(xs),
                         self.map_conv2(xs), self.map_conv3(xs)], dim=1)
        channels = self.map_bn.channels
        if self.map_bn.norm.weight.shape[0] < out.shape[1]:
            out = scatter_to_model(out, group)
        out = self.map_bn(out, MAP_BN_GROUPS if branches_sharded else 1)
        if branches_sharded:
            # rank-major gathered channels meet the matching weight columns
            out = whole(out, channels, group)
            w = self.red_conv.weight.index_select(
                1, gathered_order(channels, self.mesh.n_model, out.device))
            if is_sharded(self.red_conv):
                out = copy_to_model(out, group)
            out = self.red_conv._conv_forward(out, w.to(out.dtype), None)
        else:
            out = self.red_conv(conv_input(out, self.red_conv, group))
        pool = self.global_pooling_conv(conv_input(
            self._global_pooling(x), self.global_pooling_conv, group))
        pool = self.pool_red_conv(conv_input(
            self.global_pooling_bn(pool), self.pool_red_conv, group))
        # a (B, C, 1, 1) global pool broadcasts over the map in the add
        return self.red_bn(out + pool)

    def _global_pooling(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or self.pooling_size is None:
            return global_avg_pool(x)
        h, w = x.shape[2], x.shape[3]
        ph = min(self.pooling_size, h)
        pw = min(self.pooling_size, w)
        pool = F.avg_pool2d(x, (ph, pw), stride=1)
        # replicate-pad back to (h, w); an even window puts the extra row
        # and column after the map
        pl = (pw - 1) // 2
        pr = pl if pw % 2 == 1 else pl + 1
        pt = (ph - 1) // 2
        pb = pt if ph % 2 == 1 else pt + 1
        return F.pad(pool, (pl, pr, pt, pb), mode="replicate")
