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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ABN, conv, global_avg_pool, wide_dtype


class DeeplabV3(nn.Module):
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
        out = torch.cat([self.map_conv0(x), self.map_conv1(x),
                         self.map_conv2(x), self.map_conv3(x)], dim=1)
        out = self.red_conv(self.map_bn(out))
        pool = self.global_pooling_conv(self._global_pooling(x))
        pool = self.pool_red_conv(self.global_pooling_bn(pool))
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
