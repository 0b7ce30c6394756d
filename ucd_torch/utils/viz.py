"""Dataset palettes, palettized PNG output and the visualization helpers.

Copies of the palettes and helpers of ucd_tpu/utils/viz.py: the serving
path's palettized PNGs, and the panels, label colouring and attention maps
that `Experiment.validate` and `Experiment.visualize` write. The color tables are public dataset palettes (the VOC
dev-kit bit-twiddle generation, the standard ADE20K palette, the standard
Cityscapes palette).
"""

from __future__ import annotations

import numpy as np

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

ADE_COLORS = [
    (0,0,0), (120,120,120), (180,120,120), (6,230,230), (80,50,50), (4,200,3),
    (120,120,80), (140,140,140), (204,5,255), (230,230,230), (4,250,7), (224,5,255),
    (235,255,7), (150,5,61), (120,120,70), (8,255,51), (255,6,82), (143,255,140),
    (204,255,4), (255,51,7), (204,70,3), (0,102,200), (61,230,250), (255,6,51),
    (11,102,255), (255,7,71), (255,9,224), (9,7,230), (220,220,220), (255,9,92),
    (112,9,255), (8,255,214), (7,255,224), (255,184,6), (10,255,71), (255,41,10),
    (7,255,255), (224,255,8), (102,8,255), (255,61,6), (255,194,7), (255,122,8),
    (0,255,20), (255,8,41), (255,5,153), (6,51,255), (235,12,255), (160,150,20),
    (0,163,255), (140,140,140), (250,10,15), (20,255,0), (31,255,0), (255,31,0),
    (255,224,0), (153,255,0), (0,0,255), (255,71,0), (0,235,255), (0,173,255),
    (31,0,255), (11,200,200), (255,82,0), (0,255,245), (0,61,255), (0,255,112),
    (0,255,133), (255,0,0), (255,163,0), (255,102,0), (194,255,0), (0,143,255),
    (51,255,0), (0,82,255), (0,255,41), (0,255,173), (10,0,255), (173,255,0),
    (0,255,153), (255,92,0), (255,0,255), (255,0,245), (255,0,102), (255,173,0),
    (255,0,20), (255,184,184), (0,31,255), (0,255,61), (0,71,255), (255,0,204),
    (0,255,194), (0,255,82), (0,10,255), (0,112,255), (51,0,255), (0,194,255),
    (0,122,255), (0,255,163), (255,153,0), (0,255,10), (255,112,0), (143,255,0),
    (82,0,255), (163,255,0), (255,235,0), (8,184,170), (133,0,255), (0,255,92),
    (184,0,255), (255,0,31), (0,184,255), (0,214,255), (255,0,112), (92,255,0),
    (0,224,255), (112,224,255), (70,184,160), (163,0,255), (153,0,255), (71,255,0),
    (255,0,163), (255,204,0), (255,0,143), (0,255,235), (133,255,0), (255,0,235),
    (245,0,255), (255,0,122), (255,245,0), (10,190,212), (214,255,0), (0,204,255),
    (20,0,255), (255,255,0), (0,153,255), (0,41,255), (0,255,204), (41,0,255),
    (41,255,0), (173,0,255), (0,245,255), (71,0,255), (122,0,255), (0,255,184),
    (0,92,255), (184,255,0), (0,133,255), (255,214,0), (25,194,194), (102,255,0),
    (92,0,255),
]

CITYSCAPES_COLORS = [
    (0, 0, 0), (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32),
]


def voc_cmap() -> np.ndarray:
    """VOC dev-kit colormap: bit-twiddled label -> RGB."""
    cmap = np.zeros((256, 3), dtype=np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def ade_cmap() -> np.ndarray:
    cmap = np.zeros((256, 3), dtype=np.uint8)
    cmap[:len(ADE_COLORS)] = np.array(ADE_COLORS, dtype=np.uint8)
    return cmap


def cityscapes_cmap() -> np.ndarray:
    cmap = np.zeros((256, 3), dtype=np.uint8)
    cmap[:len(CITYSCAPES_COLORS)] = np.array(CITYSCAPES_COLORS, np.uint8)
    return cmap


def cityscapes_train_id_cmap() -> np.ndarray:
    """Palette for the 19 Cityscapes TRAIN ids (the domain-incremental
    label space): train-id i = the full palette's entry i+1, since entry 0
    is the background/void entry of the 20-class incremental space.
    Void/255 stays black."""
    cmap = np.zeros((256, 3), dtype=np.uint8)
    cmap[:19] = np.array(CITYSCAPES_COLORS[1:20], np.uint8)
    return cmap


def color_map(dataset: str) -> np.ndarray:
    if dataset == "voc":
        return voc_cmap()
    if dataset == "ade":
        return ade_cmap()
    if dataset == "city":
        return cityscapes_cmap()
    if dataset == "city_domain":
        return cityscapes_train_id_cmap()
    raise NotImplementedError(dataset)


def palette_png(ids_u8: np.ndarray, cmap: np.ndarray):
    """(h, w) uint8 class-id map -> palettized PIL image whose decoded RGB
    equals ``cmap[ids]``, at 1/3 the pixel bytes to encode (every palette
    here is exactly (256, 3) uint8, so P mode is lossless)."""
    from PIL import Image

    assert cmap.shape == (256, 3) and cmap.dtype == np.uint8, cmap.shape
    ids = np.ascontiguousarray(ids_u8, np.uint8)
    im = Image.frombytes("P", (ids.shape[1], ids.shape[0]), ids.tobytes())
    im.putpalette(cmap.reshape(-1).tobytes())
    return im


class Label2Color:
    """Label map -> RGB image through a palette."""

    def __init__(self, cmap: np.ndarray):
        self.cmap = cmap

    def __call__(self, lbls: np.ndarray) -> np.ndarray:
        return self.cmap[np.clip(lbls, 0, len(self.cmap) - 1)]


class Denormalize:
    """Undo the ImageNet normalization for visualization (NHWC numpy)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return np.clip(img * self.std + self.mean, 0.0, 1.0)


def attention_map(body_features: np.ndarray, out_size) -> np.ndarray:
    """Per-image spatial attention a = norm(sum_c f_c^2) of NHWC features,
    upsampled to `out_size` (PIL bilinear on the f32 map)."""
    from PIL import Image

    a = np.sum(np.asarray(body_features, np.float32) ** 2, axis=-1)  # B,h,w
    norm = np.sqrt((a ** 2).sum(axis=(1, 2), keepdims=True))
    a = a / np.maximum(norm, 1e-12)
    return np.stack([
        np.asarray(Image.fromarray(ai).resize(
            (out_size[1], out_size[0]), Image.BILINEAR))
        for ai in a])


def compose_sample_png(image_norm: np.ndarray, target: np.ndarray,
                       pred: np.ndarray, dataset: str) -> np.ndarray:
    """Side-by-side (input | GT | prediction) uint8 panel."""
    l2c = Label2Color(color_map(dataset))
    if image_norm.dtype == np.uint8:
        # device-normalize pipeline: the host-side image is raw RGB already
        img = image_norm
    else:
        img = (Denormalize()(image_norm) * 255).astype(np.uint8)
    return np.concatenate([img, l2c(target), l2c(pred)], axis=1)
