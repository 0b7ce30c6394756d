"""Core layers: fused norm+activation (ABN), conv and initializers.

Counterpart of ucd_tpu/models/layers.py. Modules are NCHW (the port keeps
activations in `channels_last` memory, so NCHW tensors are NHWC in memory).

Dtype policy, as in the JAX package: convolutions take and return the
model's compute dtype (bf16 or f32; cuDNN accumulates in f32), while every
ABN normalizes in f32 from f32 running statistics and casts back to the
compute dtype after the activation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu_gain(negative_slope: float) -> float:
    """torch.nn.init.calculate_gain('leaky_relu', slope)."""
    return math.sqrt(2.0 / (1.0 + negative_slope ** 2))


def _trunc_normal_fan_in_(w: torch.Tensor, scale: float,
                          generator: torch.Generator) -> torch.Tensor:
    """flax variance_scaling(scale, 'fan_in', 'truncated_normal'): a normal
    truncated at two standard deviations, with the std corrected so the
    truncated draw has variance scale/fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def he_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax `nn.initializers.he_normal()` (the body's conv init)."""
    return _trunc_normal_fan_in_(w, 2.0, generator)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv kernel init (the `cls_i` classifiers)."""
    return _trunc_normal_fan_in_(w, 1.0, generator)


@torch.no_grad()
def xavier_normal_gain_(w: torch.Tensor, gain: float,
                        generator: torch.Generator) -> torch.Tensor:
    """Xavier/Glorot normal with an explicit gain (the ASPP head's init)."""
    return nn.init.xavier_normal_(w, gain=gain, generator=generator)


class ABN(nn.Module):
    """BatchNorm + activation (`inplace_abn.ABN` semantics).

    `activation='identity'` is the last norm of each residual block and of
    the projection shortcuts. Normalization and activation run in f32; the
    output is cast to `dtype`. Flax momentum 0.9 is torch momentum 0.1."""

    def __init__(self, channels: int, activation: str = "leaky_relu",
                 activation_param: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation not in ("leaky_relu", "elu", "identity"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.activation_param = activation_param
        self.dtype = dtype
        self.bn = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(x.float())
        if self.activation == "leaky_relu":
            y = F.leaky_relu(y, self.activation_param)
        elif self.activation == "elu":
            y = F.elu(y, self.activation_param)
        return y.to(self.dtype)


def conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
         dilation: int = 1, dtype: torch.dtype = torch.float32) -> nn.Conv2d:
    """Bias-free conv with torch-style symmetric padding dilation*(k-1)//2,
    its weight held in the compute dtype."""
    return nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False, dtype=dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims, keepdims."""
    return x.mean(dim=(2, 3), keepdim=True)
