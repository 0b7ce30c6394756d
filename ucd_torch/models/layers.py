"""Core layers: fused norm+activation (ABN), conv and initializers.

Counterpart of ucd_tpu/models/layers.py. Modules are NCHW (the port keeps
activations in `channels_last` memory, so NCHW tensors are NHWC in memory).

Dtype policy, as in the JAX package: convolutions take and return the
model's compute dtype (bf16 or f32; cuDNN accumulates in f32) while their
master weights stay f32 and are cast at each call, so the optimizer, weight
decay and momentum act on f32 and the gradients arrive in f32. Every ABN
normalizes in f32 from f32 statistics and casts back to the compute dtype
after the activation. float64 is a test-only compute dtype: weights,
statistics and normalization are then all f64.

Train-mode BatchNorm follows flax: the batch is normalized with its biased
variance and the running variance takes the *biased* batch variance too
(torch's own update takes the unbiased one). The variance is always the
cancellation-free one (`stable_norm=True` on the JAX side); flax's default
one-pass E[x^2]-E[x]^2 is not reproduced.
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


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype that norms, classifiers and losses compute in under the
    compute dtype `dtype`: f32, or f64 for the test-only f64 model."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance takes the biased
    batch variance, as flax's BatchNorm does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        self.num_batches_tracked.add_(1)
        factor = self.momentum if self.momentum is not None \
            else 1.0 / float(self.num_batches_tracked)
        # the batch's mean and unbiased variance land in scratch buffers
        # (momentum 1); the running statistics then take the mean and the
        # *biased* variance, as flax's do
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, factor)
            self.running_var.lerp_(var * ((n - 1) / n), factor)
        return y


class ABN(nn.Module):
    """BatchNorm + activation (`inplace_abn.ABN` semantics).

    `activation='identity'` is the last norm of each residual block and of
    the projection shortcuts. Normalization and activation run in f32 (f64
    under the f64 test dtype); the output is cast to `dtype`. Flax momentum
    0.9 is torch momentum 0.1."""

    def __init__(self, channels: int, activation: str = "leaky_relu",
                 activation_param: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation not in ("leaky_relu", "elu", "identity"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.activation_param = activation_param
        self.dtype = dtype
        self.norm_dtype = wide_dtype(dtype)
        self.bn = BatchNorm2d(channels, eps=1e-5, momentum=0.1,
                              dtype=self.norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(x.to(self.norm_dtype))
        # in place: the norm's backward needs its input, not its output
        if self.activation == "leaky_relu":
            y = F.leaky_relu(y, self.activation_param, inplace=True)
        elif self.activation == "elu":
            y = F.elu(y, self.activation_param, inplace=True)
        return y.to(self.dtype)


class Conv2d(nn.Conv2d):
    """Bias-free conv whose weight is cast to the input's dtype at each call
    (f32 masters under the bf16 policy; a weight already in the compute
    dtype, as in a bf16 serving model, is used as it is)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        return self._conv_forward(x, w, None)


def conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
         dilation: int = 1, dtype: torch.dtype = torch.float32) -> Conv2d:
    """Bias-free conv with torch-style symmetric padding dilation*(k-1)//2.
    `dtype` is the dtype of the stored weight."""
    return Conv2d(in_channels, out_channels, kernel, stride=stride,
                  padding=dilation * (kernel - 1) // 2, dilation=dilation,
                  bias=False, dtype=dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims, keepdims."""
    return x.mean(dim=(2, 3), keepdim=True)
