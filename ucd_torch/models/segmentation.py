"""Incremental segmentation model: ResNet body -> DeepLab-v3 head ->
per-step classifiers `cls_i`.

Counterpart of ucd_tpu/models/segmentation.py (the classifier-growth and
freezing helpers come with the train slice). Tensors are NCHW; the model's
parameters and activations live in `channels_last` memory, so `sem`
permutes to the NHWC layout of the JAX package without a copy.

Eager PyTorch does no dead-code elimination, so the serving path calls
`forward_sem`, which stops at the low-res logits: the full-res upsample and
the attention maps of `forward` are never computed there (under jit, XLA
drops them from the JAX serving path the same way).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from .deeplab import DeeplabV3
from .layers import (he_normal_, leaky_relu_gain, lecun_normal_,
                     xavier_normal_gain_)
from .resnet import STRUCTURES, ResNet


def att_map(x: torch.Tensor) -> torch.Tensor:
    """Detached spatial attention: a = sum_c x^2 / ||sum_c x^2||_F,
    x <- a*x (NCHW), computed in f32 and cast back to x's dtype."""
    xf = x.float()
    a = (xf ** 2).sum(dim=1, keepdim=True)
    norm = (a ** 2).sum(dim=(2, 3), keepdim=True).sqrt()
    a = (a / norm.clamp_min(1e-12)).detach()
    return (a * xf).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _imagenet_consts(device: torch.device):
    """(mean, std) as (1, 3, 1, 1) f32 tensors, uploaded once per device:
    a per-call upload from host memory would synchronize the stream."""
    return tuple(torch.as_tensor(a, device=device).view(1, 3, 1, 1)
                 for a in (IMAGENET_MEAN, IMAGENET_STD))


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 NCHW RGB -> ImageNet-normalized f32, on the tensor's device."""
    mean, std = _imagenet_consts(x.device)
    return (x.float() / 255.0 - mean) / std


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """f32 bilinear resize of NCHW `x` with half-pixel centers
    (align_corners=False). `antialias=True` reproduces
    jax.image.resize(method='linear'), which antialiases when it
    downsamples (the 0.75 TTA scale); upsampling is plain bilinear either
    way."""
    return F.interpolate(x.float(), size=(int(size[0]), int(size[1])),
                         mode="bilinear", align_corners=False,
                         antialias=True)


class IncrementalSegmentationModel(nn.Module):
    """`forward(x)` returns (sem logits upsampled to the input size,
    {"body", "pre_logits", "sem"}), all NCHW. `x` is NCHW uint8 RGB
    (normalized here) or already-normalized float.

    `dtype` is the compute dtype of the body and the head (bf16 or f32);
    the classifiers always run in f32 on the f32-cast head output, so `sem`
    is f32 under either policy."""

    def __init__(self, classes: Sequence[int], backbone: str = "resnet101",
                 output_stride: int = 16, head_channels: int = 256,
                 pooling_size: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.classes = tuple(int(c) for c in classes)
        self.backbone = backbone
        self.output_stride = output_stride
        self.head_channels = head_channels
        self.pooling_size = pooling_size
        self.dtype = dtype
        structure, bottleneck = STRUCTURES[backbone]
        self.body = ResNet(structure, bottleneck, output_stride, dtype=dtype)
        self.head = DeeplabV3(self.body.out_channels, head_channels,
                              hidden_channels=256, out_stride=output_stride,
                              pooling_size=pooling_size, dtype=dtype)
        for i, c in enumerate(self.classes):
            self.add_module(f"cls_{i}",
                            nn.Conv2d(head_channels, c, 1, bias=True))

    def classifiers(self):
        return [getattr(self, f"cls_{i}") for i in range(len(self.classes))]

    def _features(self, x: torch.Tensor):
        if x.dtype == torch.uint8:
            x = normalize_uint8(x)
        x_b = self.body(x.to(self.dtype))
        x_pl = self.head(x_b)
        x_pl32 = x_pl.float()
        sem = torch.cat([cls(x_pl32) for cls in self.classifiers()], dim=1)
        return x_b, x_pl, sem

    def forward_sem(self, x: torch.Tensor) -> torch.Tensor:
        """Low-res f32 logits (B, C, h, w) only: the serving path."""
        return self._features(x)[2]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        x_b, x_pl, sem = self._features(x)
        outputs = resize_bilinear(sem, x.shape[2:])
        return outputs, {"body": att_map(x_b), "pre_logits": att_map(x_pl),
                         "sem": sem}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's init scheme, drawn from `generator`: He-normal
        body convs, Xavier-normal head convs with the leaky_relu(0.01)
        gain, lecun-normal classifiers with zero bias, and BatchNorm at
        scale 1, bias 0, running mean 0, running var 1."""
        for m in self.body.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
        gain = leaky_relu_gain(0.01)
        for m in self.head.modules():
            if isinstance(m, nn.Conv2d):
                xavier_normal_gain_(m.weight, gain, generator)
        for cls in self.classifiers():
            lecun_normal_(cls.weight, generator)
            cls.bias.zero_()
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self
