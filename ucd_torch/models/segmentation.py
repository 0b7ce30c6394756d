"""Incremental segmentation model: ResNet body -> DeepLab-v3 head ->
per-step classifiers `cls_i`, plus the MiB balanced-initialization rule,
the cross-step merge and the freezing mask.

Counterpart of ucd_tpu/models/segmentation.py. Tensors are NCHW; the model's
parameters and activations live in `channels_last` memory, so `sem`
permutes to the NHWC layout of the JAX package without a copy.

Eager PyTorch does no dead-code elimination, so the serving path calls
`forward_sem` and the train and validate steps `forward_feats`, which stop
at the low-res logits: the full-res upsample of `forward` is never computed
there, and the attention maps only when a loss asks for them (under jit,
XLA drops them from the JAX paths the same way).

`init_new_classifier`, `merge_old_params` and `trainable_mask` work on
`state_dict`-style flat mappings (name -> tensor) as pure functions, the
counterpart of the JAX functions on parameter trees.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from .deeplab import DeeplabV3
from .layers import (BatchNorm2d, he_normal_, leaky_relu_gain,
                     lecun_normal_, whole, wide_dtype, xavier_normal_gain_)
from .resnet import STRUCTURES, ResNet


def att_map(x: torch.Tensor) -> torch.Tensor:
    """Detached spatial attention: a = sum_c x^2 / ||sum_c x^2||_F,
    x <- a*x (NCHW), computed in f32 (f64 for an f64 input) and cast back
    to x's dtype."""
    xf = x.to(wide_dtype(x.dtype))
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


def normalize_uint8(x: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NCHW RGB -> ImageNet-normalized `dtype` (f32, or f64 for the
    f64 test model), on the tensor's device."""
    mean, std = _imagenet_consts(x.device)
    return (x.to(dtype) / 255.0 - mean.to(dtype)) / std.to(dtype)


def resize_bilinear(x: torch.Tensor, size,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bilinear resize of NCHW `x` with half-pixel centers
    (align_corners=False), computed in `dtype` (default f32, f64 for an f64
    input). `antialias=True` reproduces jax.image.resize(method='linear'),
    which antialiases when it downsamples (the 0.75 TTA scale); upsampling
    is plain bilinear either way, so an upsample takes the plain kernel
    (the CPU has no bf16 antialiased one)."""
    dtype = dtype or wide_dtype(x.dtype)
    h, w = int(size[0]), int(size[1])
    return F.interpolate(x.to(dtype), size=(h, w), mode="bilinear",
                         align_corners=False,
                         antialias=h < x.shape[-2] or w < x.shape[-1])


class IncrementalSegmentationModel(nn.Module):
    """`forward(x)` returns (sem logits upsampled to the input size,
    {"body", "pre_logits", "sem"}), all NCHW. `x` is NCHW uint8 RGB
    (normalized here) or already-normalized float.

    `dtype` is the compute dtype of the body and the head (bf16 or f32);
    the classifiers always run in f32 on the f32-cast head output, so `sem`
    is f32 under either policy. `param_dtype` is the dtype of the stored
    conv weights of the body and the head: f32 masters by default (what
    training needs); a bf16 serving model keeps bf16 weights. float64 is a
    test-only `dtype` under which everything is f64.

    The JAX model's execution options: `stem_s2d`, `remat`, `remat_early`
    (models/resnet.py), `norm_dtype` (every ABN rounds its normalized
    output to it; the JAX package's `bf16_norm`) and `norm_dtype_early`
    (the stem and mod2 only; `bf16_norm_early`). None is the wide dtype.

    The JAX model's `fix_bn` is this module's eval mode with gradients on:
    `model.train(train and not fix_bn)`.

    On the 2-D mesh (`mesh`, models/layers.py `use_mesh`) the body's and
    the head's outputs may be channel shards: each is gathered whole once,
    the body's for the head and the attention maps, the head's for the
    classifiers (replicated at any `min_size`: 16 and 1 outputs) and the
    attention maps."""

    mesh = None

    def __init__(self, classes: Sequence[int], backbone: str = "resnet101",
                 output_stride: int = 16, head_channels: int = 256,
                 pooling_size: int = 32, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 stem_s2d: bool = False, remat: bool = False,
                 remat_early: bool = False,
                 norm_dtype: Optional[torch.dtype] = None,
                 norm_dtype_early: Optional[torch.dtype] = None):
        super().__init__()
        self.classes = tuple(int(c) for c in classes)
        self.backbone = backbone
        self.output_stride = output_stride
        self.head_channels = head_channels
        self.pooling_size = pooling_size
        self.dtype = dtype
        self.stem_s2d = stem_s2d
        self.cls_dtype = wide_dtype(dtype)
        structure, bottleneck = STRUCTURES[backbone]
        self.body = ResNet(structure, bottleneck, output_stride, dtype=dtype,
                           param_dtype=param_dtype, stem_s2d=stem_s2d,
                           remat=remat, remat_early=remat_early,
                           norm_dtype=norm_dtype,
                           norm_dtype_early=norm_dtype_early)
        self.head = DeeplabV3(self.body.out_channels, head_channels,
                              hidden_channels=256, out_stride=output_stride,
                              pooling_size=pooling_size, dtype=dtype,
                              param_dtype=param_dtype, norm_dtype=norm_dtype)
        for i, c in enumerate(self.classes):
            self.add_module(f"cls_{i}",
                            nn.Conv2d(head_channels, c, 1, bias=True,
                                      dtype=self.cls_dtype))

    def classifiers(self):
        return [getattr(self, f"cls_{i}") for i in range(len(self.classes))]

    def _features(self, x: torch.Tensor):
        if x.dtype == torch.uint8:
            x = normalize_uint8(x, self.cls_dtype)
        group = self.mesh.model_group if self.mesh is not None else None
        # the head and the attention maps take the body's features whole
        x_b = whole(self.body(x.to(self.dtype)), self.body.out_channels,
                    group)
        x_pl = whole(self.head(x_b), self.head_channels, group)
        x_plw = x_pl.to(self.cls_dtype)
        sem = torch.cat([cls(x_plw) for cls in self.classifiers()], dim=1)
        return x_b, x_pl, sem

    def forward_sem(self, x: torch.Tensor) -> torch.Tensor:
        """Low-res f32 logits (B, C, h, w) only: the serving path."""
        return self._features(x)[2]

    def forward_feats(self, x: torch.Tensor,
                      attention: bool = False) -> Dict[str, torch.Tensor]:
        """{"sem"} (low-res logits, NCHW), plus the attention-weighted
        {"body", "pre_logits"} when `attention`: what the train and
        validate steps need, without the full-res upsample."""
        return self.forward(x, upsample=False, attention=attention)[1]

    def forward(self, x: torch.Tensor, upsample: bool = True,
                attention: bool = True) -> Tuple[torch.Tensor, dict]:
        """(outputs, feats). `upsample=False` skips the full-res logits
        (outputs is None) and `attention=False` the two attention maps."""
        x_b, x_pl, sem = self._features(x)
        feats = {"sem": sem}
        if attention:
            feats["body"] = att_map(x_b)
            feats["pre_logits"] = att_map(x_pl)
        outputs = resize_bilinear(sem, x.shape[2:]) if upsample else None
        return outputs, feats

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
            if isinstance(m, BatchNorm2d):
                m.reset_parameters()
        return self


TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64}


def make_model(cfg, classes: Optional[Sequence[int]] = None
               ) -> IncrementalSegmentationModel:
    """The model of a Config (on the CPU, uninitialized beyond torch's
    defaults: `engine.state.build_train_state` draws the seeded init).
    `classes` defaults to the config's per-step classifier widths; the
    donor of step t is `make_model(cfg, cfg.classes_per_step[:-1])`.

    The execution options are read as the JAX `make_model` reads them:
    `bf16_norm` rounds every ABN's output to bf16 under any compute dtype,
    `bf16_norm_early` the stem's and mod2's under the bf16 policy only."""
    dtype = TORCH_DTYPES[cfg.dtype]
    return IncrementalSegmentationModel(
        tuple(classes if classes is not None else cfg.classes_per_step),
        backbone=cfg.backbone, output_stride=cfg.output_stride,
        head_channels=cfg.head_channels, pooling_size=cfg.pooling,
        dtype=dtype, stem_s2d=cfg.stem_s2d, remat=cfg.remat,
        remat_early=cfg.remat_early,
        norm_dtype=torch.bfloat16 if cfg.bf16_norm else None,
        norm_dtype_early=(torch.bfloat16 if cfg.bf16_norm_early
                          and dtype == torch.bfloat16 else None))


# ---------------------------------------------------------------------------
# state_dict surgery: incremental growth, imprinting, freezing
# ---------------------------------------------------------------------------

def _n_classifiers(names: Iterable[str]) -> int:
    return len({n.split(".")[0] for n in names if n.startswith("cls_")})


def init_new_classifier(sd: Mapping[str, torch.Tensor],
                        new_classes: int) -> Dict[str, torch.Tensor]:
    """MiB background imprinting, as a pure function on a state_dict:

    new cls weight <- background row of cls_0's weight (broadcast);
    new cls bias   <- bkg_bias - log(new_classes + 1);
    cls_0 bias[0]  <- the same adjusted value."""
    out = dict(sd)
    last = f"cls_{_n_classifiers(sd) - 1}"
    w0, b0 = sd["cls_0.weight"], sd["cls_0.bias"]
    new_bias = b0[0] - math.log(new_classes + 1)
    w_last = sd[f"{last}.weight"]
    out[f"{last}.weight"] = w0[0:1].expand_as(w_last).to(w_last.dtype).clone()
    out[f"{last}.bias"] = torch.full_like(sd[f"{last}.bias"],
                                          float(new_bias))
    b0_new = b0.clone()
    b0_new[0] = new_bias
    out["cls_0.bias"] = b0_new
    return out


def merge_old_params(new_sd: Mapping[str, torch.Tensor],
                     old_sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Cross-step restore: every entry of `old_sd` that exists in `new_sd`
    (body, head, cls_0..cls_{k-1}) replaces it; newly added classifier
    entries keep their fresh init (load_state_dict(strict=False))."""
    return {k: old_sd.get(k, v) for k, v in new_sd.items()}


def trainable_mask(names: Iterable[str], step: int, freeze_body: bool = False,
                   fix_bn: bool = False,
                   freeze_cls0_always: bool = False) -> Dict[str, bool]:
    """name -> True where the parameter is trainable.

    - cls_0 frozen for step > 0 (or always, bug-compatible mode);
    - body frozen under `freeze_body`;
    - BN affine parameters frozen under `fix_bn`."""
    freeze_cls0 = freeze_cls0_always or step > 0

    def trainable(name: str) -> bool:
        path = name.split(".")
        top = path[0]
        if freeze_cls0 and top == "cls_0":
            return False
        if freeze_body and not (top == "head" or top.startswith("cls_")):
            return False
        if fix_bn and "bn" in path:
            return False
        return True

    return {n: trainable(n) for n in names}
