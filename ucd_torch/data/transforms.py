"""Paired image/label transforms (host-side, numpy/PIL).

The port's own copy of ucd_tpu/data/transforms.py: every transform takes an
(image, label) pair; geometric ops use NEAREST for labels. The train
pipeline is RandomResizedCrop(crop, scale=(0.5, 2.0)) -> horizontal flip ->
ToTensorNormalize; the val pipeline Resize -> CenterCrop ->
ToTensorNormalize.

Images stay NHWC numpy (the model views them as NCHW channels_last on the
device without a copy), and randomness flows through an explicit
`np.random.Generator`, drawn in the same order as the JAX package's
transforms: one seed gives the same bits in both packages.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_pil(img: np.ndarray, mode=None):
    return Image.fromarray(img, mode=mode)


def _resize_pair(img: np.ndarray, lbl: np.ndarray, size: tuple[int, int],
                 crop=None, flip: bool = False):
    """size = (h, w); bilinear for the image, nearest for the label; an
    optional (top, left, ch, cw) crop window and an output horizontal flip
    folded into the resize."""
    h, w = size
    if img.dtype == np.uint8 and lbl.dtype == np.uint8 and img.ndim == 3:
        from .native import pil_resize_pair
        return pil_resize_pair(img, lbl, h, w, crop=crop, flip=flip)
    if crop is not None:
        top, left, ch, cw = crop
        img = img[top:top + ch, left:left + cw]
        lbl = lbl[top:top + ch, left:left + cw]
    im = _to_pil(img).resize((w, h), Image.BILINEAR)
    lb = _to_pil(lbl).resize((w, h), Image.NEAREST)
    io, lo = np.asarray(im), np.asarray(lb)
    if flip:
        io, lo = io[:, ::-1].copy(), lo[:, ::-1].copy()
    return io, lo


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, lbl, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            img, lbl = t(img, lbl, rng)
        return img, lbl


class Resize:
    """Resize the shorter side to `size`, keeping the aspect ratio."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, lbl, rng=None):
        h, w = img.shape[:2]
        if h <= w:
            nh, nw = self.size, max(1, int(round(w * self.size / h)))
        else:
            nh, nw = max(1, int(round(h * self.size / w))), self.size
        return _resize_pair(img, lbl, (nh, nw))


def _pad_to(img, lbl, size: int, fill_lbl: int = 255):
    h, w = img.shape[:2]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return img, lbl
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="constant")
    lbl = np.pad(lbl, ((0, ph), (0, pw)), mode="constant",
                 constant_values=fill_lbl)
    return img, lbl


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, lbl, rng=None):
        s = self.size
        h, w = img.shape[:2]
        if h < s or w < s:
            img, lbl = _pad_to(img, lbl, s)
            h, w = img.shape[:2]
        top, left = (h - s) // 2, (w - s) // 2
        return (img[top:top + s, left:left + s],
                lbl[top:top + s, left:left + s])


class Pad:
    """Constant-pad both sides; the label is padded with `label_fill` (255
    keeps the padding ignored)."""

    def __init__(self, padding: int, fill: int = 0, label_fill: int = 255):
        self.padding = padding
        self.fill = fill
        self.label_fill = label_fill

    def __call__(self, img, lbl, rng=None):
        p = self.padding
        img = np.pad(img, ((p, p), (p, p), (0, 0)), constant_values=self.fill)
        lbl = np.pad(lbl, ((p, p), (p, p)), constant_values=self.label_fill)
        return img, lbl


class Lambda:
    """Apply a user callable to the pair."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, img, lbl, rng=None):
        return self.fn(img, lbl)


class RandomRotation:
    """Rotate both by a uniform angle in [-degrees, degrees]; bilinear for
    the image, NEAREST for the label."""

    def __init__(self, degrees: float, label_fill: int = 255):
        self.degrees = degrees
        self.label_fill = label_fill

    def __call__(self, img, lbl, rng):
        angle = float(rng.uniform(-self.degrees, self.degrees))
        im = _to_pil(img).rotate(angle, Image.BILINEAR, fillcolor=0)
        lb = _to_pil(lbl).rotate(angle, Image.NEAREST,
                                 fillcolor=self.label_fill)
        return np.asarray(im), np.asarray(lb)


class ColorJitter:
    """Brightness/contrast/saturation jitter on the image only."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _factor(rng, amount):
        return float(rng.uniform(max(0.0, 1 - amount), 1 + amount))

    def __call__(self, img, lbl, rng):
        x = img.astype(np.float32)
        if self.brightness > 0:
            x = x * self._factor(rng, self.brightness)
        if self.contrast > 0:
            mean = x.mean()
            x = (x - mean) * self._factor(rng, self.contrast) + mean
        if self.saturation > 0:
            gray = x.mean(axis=-1, keepdims=True)
            x = (x - gray) * self._factor(rng, self.saturation) + gray
        return np.clip(x, 0, 255).astype(img.dtype), lbl


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng):
        if rng.random() < self.p:
            return img[:, ::-1].copy(), lbl[:, ::-1].copy()
        return img, lbl


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng):
        if rng.random() < self.p:
            return img[::-1].copy(), lbl[::-1].copy()
        return img, lbl


class RandomCrop:
    def __init__(self, size: int, pad_if_needed: bool = True):
        self.size = size
        self.pad_if_needed = pad_if_needed

    def __call__(self, img, lbl, rng):
        s = self.size
        if self.pad_if_needed:
            img, lbl = _pad_to(img, lbl, s)
        h, w = img.shape[:2]
        top = int(rng.integers(0, h - s + 1))
        left = int(rng.integers(0, w - s + 1))
        return (img[top:top + s, left:left + s],
                lbl[top:top + s, left:left + s])


class RandomResizedCrop:
    """torchvision RandomResizedCrop semantics (ratio (3/4, 4/3)).
    `flip_p > 0` folds a horizontal flip into the crop+resize, drawing one
    `rng.random()` after the crop, as Compose([crop, flip]) would."""

    def __init__(self, size: int, scale=(0.5, 2.0), ratio=(3 / 4, 4 / 3),
                 flip_p: float = 0.0):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.flip_p = flip_p

    def _flip(self, rng) -> bool:
        return self.flip_p > 0 and rng.random() < self.flip_p

    def __call__(self, img, lbl, rng):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                return _resize_pair(img, lbl, (self.size, self.size),
                                    crop=(top, left, ch, cw),
                                    flip=self._flip(rng))
        # fallback: center crop of the shorter side
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        top, left = (h - ch) // 2, (w - cw) // 2
        return _resize_pair(img, lbl, (self.size, self.size),
                            crop=(top, left, ch, cw),
                            flip=self._flip(rng))


class ToTensorNormalize:
    """uint8 HWC -> ImageNet-normalized float32 HWC; labels stay uint8, any
    wider label becomes int32. With `to_float=False` the image stays uint8
    and the model normalizes it on the device."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 to_float: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_float = to_float

    def __call__(self, img, lbl, rng=None):
        lbl = lbl if lbl.dtype == np.uint8 else lbl.astype(np.int32)
        if not self.to_float:
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 255).astype(np.uint8)
            return img, lbl
        if img.dtype == np.uint8:
            from .native import normalize_image
            img = normalize_image(img, self.mean, self.std)
        else:
            img = (img.astype(np.float32) / 255.0 - self.mean) / self.std
        return img, lbl


def train_transform(crop_size: int, device_normalize: bool = False) -> Compose:
    """Random resized crop with the flip folded in, then normalization."""
    return Compose([
        RandomResizedCrop(crop_size, (0.5, 2.0), flip_p=0.5),
        ToTensorNormalize(to_float=not device_normalize),
    ])


def val_transform(crop_size: Optional[int],
                  device_normalize: bool = False) -> Compose:
    """Resize + center crop when `crop_size` is given, then normalization."""
    ts = []
    if crop_size is not None:
        ts += [Resize(crop_size), CenterCrop(crop_size)]
    ts.append(ToTensorNormalize(to_float=not device_normalize))
    return Compose(ts)


class Denormalize:
    """Undo the ImageNet normalization (for visualization)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img):
        return np.clip(img * self.std + self.mean, 0, 1)
