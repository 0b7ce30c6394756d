"""Embedded-gaussian non-local attention block (NCHW).

Counterpart of ucd_tpu/models/nonlocal_block.py (no model of either package
instantiates it): y = softmax(theta(x) phi(x)^T) g(x), then W(y) + x, with
optional 2x2 max-pool sub-sampling of phi and g and a BatchNorm after W
whose scale starts at zero, so the block starts as the identity.

As in flax: the 1x1 convs have biases, f32 parameters cast to the compute
`dtype` at each call, lecun-normal kernels (W: he-normal, or zeros without
the BatchNorm) and zero biases; `W_bn` is flax's default BatchNorm
(momentum 0.99, eps 1e-5) computed in f32 whatever the compute dtype, its
running variance the biased batch variance (models/layers.py
`BatchNorm2d`). Plain torch ops in true f32 (the entry points turn TF32
off). Submodules are named after the flax scopes (`g`, `theta`, `phi`,
`W`, `W_bn`), so models/convert.py carries the weights across.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, he_normal_, lecun_normal_


class _Conv1x1(nn.Conv2d):
    """1x1 conv with a bias, its f32 parameters cast to the input's
    dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class NonLocalBlock2D(nn.Module):
    def __init__(self, in_channels: int,
                 inter_channels: Optional[int] = None,
                 sub_sample: bool = True, bn_layer: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.inter = inter_channels or max(in_channels // 2, 1)
        self.sub_sample = sub_sample
        self.bn_layer = bn_layer
        self.dtype = dtype
        self.g = _Conv1x1(in_channels, self.inter)
        self.theta = _Conv1x1(in_channels, self.inter)
        self.phi = _Conv1x1(in_channels, self.inter)
        self.W = _Conv1x1(self.inter, in_channels)
        if bn_layer:
            self.W_bn = BatchNorm2d(in_channels, eps=1e-5, momentum=0.01)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's init, drawn from `generator`."""
        for conv in (self.g, self.theta, self.phi):
            lecun_normal_(conv.weight, generator)
            conv.bias.zero_()
        if self.bn_layer:
            he_normal_(self.W.weight, generator)
            self.W_bn.reset_parameters()
            self.W_bn.weight.zero_()
        else:
            self.W.weight.zero_()
        self.W.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        xd = x.to(self.dtype)
        g, theta, phi = self.g(xd), self.theta(xd), self.phi(xd)
        if self.sub_sample:
            g = F.max_pool2d(g, 2, 2)
            phi = F.max_pool2d(phi, 2, 2)
        q = theta.flatten(2).transpose(1, 2)           # (B, HW, inter)
        k = phi.flatten(2)                             # (B, inter, HW')
        v = g.flatten(2).transpose(1, 2)               # (B, HW', inter)
        attn = torch.softmax(torch.bmm(q, k), dim=-1)
        y = torch.bmm(attn, v).transpose(1, 2).reshape(b, self.inter, h, w)
        out = self.W(y)
        if self.bn_layer:
            out = self.W_bn(out.float())
        return (out + x).to(x.dtype)
