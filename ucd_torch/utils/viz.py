"""Dataset palettes and palettized PNG output.

Copies of the palettes and helpers of ucd_tpu/utils/viz.py used by the
serving path. The color tables are public dataset palettes (the VOC
dev-kit bit-twiddle generation, the standard ADE20K palette, the standard
Cityscapes palette).
"""

from __future__ import annotations

import numpy as np

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
