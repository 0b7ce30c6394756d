"""Host-side data ops of the input pipeline, in numpy and PIL.

The port's copies of the numpy/PIL paths of ucd_tpu/data/native.py. The JAX
package binds a C++ build of these ops (native/data_ops.cc) when one is
present; the port binds none (ROADMAP lists its own binding as a later
item). These are host ops, not device kernels.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def remap_labels(lbl: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """256-entry LUT remap of a label array. A uint8 input whose LUT values
    all fit uint8 stays uint8 (the steps widen labels on the device);
    anything else comes back int32."""
    lut = np.ascontiguousarray(lut, np.int32)
    assert lut.size == 256
    if lbl.dtype == np.uint8 and lut.min() >= 0 and lut.max() <= 255:
        return lut.astype(np.uint8)[lbl]
    return lut[np.clip(lbl.astype(np.int64), 0, 255)]


def normalize_image(img_u8: np.ndarray, mean: np.ndarray,
                    std: np.ndarray) -> np.ndarray:
    """uint8 HWC -> ImageNet-normalized float32 HWC."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def pil_resize_pair(img: np.ndarray, lbl: np.ndarray, oh: int, ow: int,
                    crop=None, flip: bool = False):
    """Paired crop + resize (+ horizontal flip): PIL bilinear for the
    image, PIL nearest for the label. `crop` = (top, left, ch, cw); None is
    the whole image. The crop is taken before the resize (torchvision's
    resized_crop), so the filter window never crosses the crop's edges."""
    h, w = img.shape[:2]
    top, left, ch, cw = crop if crop is not None else (0, 0, h, w)
    im = Image.fromarray(img[top:top + ch, left:left + cw]).resize(
        (ow, oh), Image.BILINEAR)
    lb = Image.fromarray(lbl[top:top + ch, left:left + cw]).resize(
        (ow, oh), Image.NEAREST)
    io, lo = np.asarray(im), np.asarray(lb)
    if flip:
        io, lo = io[:, ::-1].copy(), lo[:, ::-1].copy()
    return io, lo


def confusion_update(hist: np.ndarray, lbl: np.ndarray,
                     pred: np.ndarray) -> np.ndarray:
    """Host-side confusion accumulation into the int64 `hist`, in place,
    over pixels whose label is in [0, n_classes)."""
    n_classes = hist.shape[0]
    mask = (lbl >= 0) & (lbl < n_classes)
    idx = n_classes * lbl[mask].astype(np.int64) + pred[mask]
    hist += np.bincount(idx, minlength=n_classes**2).reshape(n_classes,
                                                            n_classes)
    return hist
