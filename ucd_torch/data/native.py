"""Host-side data ops of the input pipeline: a C++ build, else numpy/PIL.

The port binds its own copy of the JAX package's C++ host ops
(`csrc/data_ops.cc`: LUT remap, fused normalize, PIL-exact paired crop +
resize (+ flip), host confusion) through ctypes. The library is compiled
at first use, never at import, by the C++ compiler in `$CXX` (else `g++`
on PATH) with the JAX package's flags, into `ucd_torch/_build/` under a
name that carries a hash of the source and the flags; it then gives the
JAX package's binding's bits. Without a compiler every op takes its
numpy/PIL path (the JAX package's rule for an unbuilt library) and
`has_native()` is False; a compiler that fails raises with its output.
These are host ops, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image

SOURCE = Path(__file__).resolve().parent / "csrc" / "data_ops.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's build flags (its scripts/build_native.sh); without
# -march=native the normalize is not FMA-contracted and rounds differently
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

# None: not tried yet; False: no compiler on this host; else the library
_LIB = None
_lock = threading.Lock()

_c = ctypes
_SIGNATURES = {
    "remap_labels_i32": [_c.POINTER(_c.c_int32), _c.c_int64,
                         _c.POINTER(_c.c_int32)],
    "remap_labels_u8_to_i32": [_c.POINTER(_c.c_uint8),
                               _c.POINTER(_c.c_int32), _c.c_int64,
                               _c.POINTER(_c.c_int32)],
    "normalize_u8_to_f32": [_c.POINTER(_c.c_uint8), _c.POINTER(_c.c_float),
                            _c.c_int64, _c.c_int, _c.POINTER(_c.c_float),
                            _c.POINTER(_c.c_float)],
    "confusion_update_i32": [_c.POINTER(_c.c_int32), _c.POINTER(_c.c_int32),
                             _c.c_int64, _c.c_int, _c.POINTER(_c.c_int64)],
    "pil_resize_pair_u8": [_c.POINTER(_c.c_uint8)] * 4 + [_c.c_int] * 9,
}


def compiler() -> Optional[str]:
    """The C++ compiler the library is built with: `$CXX`, else `g++`,
    resolved on PATH; None when there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def library_path() -> Path:
    """Where the library is built: the name carries a hash of the source
    and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libucd_data_ops-{h.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the library with `cxx` unless it is there. The compiler
    writes a file of this process and thread, renamed into place, so
    concurrent builds never load half a library. Raises with the
    compiler's output if it fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host ops ({SOURCE.name}) with "
                           f"{cxx} failed (exit {res.returncode}):\n"
                           f"{res.stdout}")
    os.replace(tmp, so)
    return so


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _lock:
        if _LIB is None:
            cxx = compiler()
            if cxx is None:
                _LIB = False
            else:
                lib = ctypes.CDLL(str(build(cxx)))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, None
                _LIB = lib
    return _LIB


def has_native() -> bool:
    """Whether the C++ build is in use (built now if it is not yet)."""
    return bool(_load())


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def remap_labels(lbl: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """256-entry LUT remap of a label array. A uint8 input whose LUT values
    all fit uint8 stays uint8 (the steps widen labels on the device) and is
    a numpy gather, which is memory-bound already; anything else comes back
    int32."""
    lut = np.ascontiguousarray(lut, np.int32)
    assert lut.size == 256
    if lbl.dtype == np.uint8 and lut.min() >= 0 and lut.max() <= 255:
        return lut.astype(np.uint8)[lbl]
    lib = _load()
    if lib and lbl.dtype == np.uint8:
        src = np.ascontiguousarray(lbl)
        out = np.empty(lbl.shape, np.int32)
        lib.remap_labels_u8_to_i32(_ptr(src, ctypes.c_uint8),
                                   _ptr(out, ctypes.c_int32),
                                   src.size, _ptr(lut, ctypes.c_int32))
        return out
    if lib and lbl.dtype == np.int32:
        out = np.ascontiguousarray(lbl).copy()
        lib.remap_labels_i32(_ptr(out, ctypes.c_int32), out.size,
                             _ptr(lut, ctypes.c_int32))
        return out
    return lut[np.clip(lbl.astype(np.int64), 0, 255)]


def normalize_image(img_u8: np.ndarray, mean: np.ndarray,
                    std: np.ndarray) -> np.ndarray:
    """uint8 HWC -> ImageNet-normalized float32 HWC. The C++ build computes
    x * (1 / (255 std)) - mean / std in one FMA a value; the numpy path
    (x / 255 - mean) / std, which rounds differently (up to ~5e-7)."""
    c = img_u8.shape[-1]
    lib = _load() if img_u8.dtype == np.uint8 and c <= 8 else False
    if lib:
        src = np.ascontiguousarray(img_u8)
        out = np.empty(src.shape, np.float32)
        mean32 = np.ascontiguousarray(mean, np.float32)
        std32 = np.ascontiguousarray(std, np.float32)
        lib.normalize_u8_to_f32(_ptr(src, ctypes.c_uint8),
                                _ptr(out, ctypes.c_float), src.size // c, c,
                                _ptr(mean32, ctypes.c_float),
                                _ptr(std32, ctypes.c_float))
        return out
    x = img_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def pil_resize_pair(img: np.ndarray, lbl: np.ndarray, oh: int, ow: int,
                    crop=None, flip: bool = False):
    """Paired crop + resize (+ horizontal flip): PIL bilinear for the
    image, PIL nearest for the label (the C++ build reimplements Pillow's
    fixed-point resampling, bit for bit). `crop` = (top, left, ch, cw);
    None is the whole image. The crop is taken before the resize
    (torchvision's resized_crop), so the filter window never crosses the
    crop's edges."""
    h, w = img.shape[:2]
    top, left, ch, cw = crop if crop is not None else (0, 0, h, w)
    lib = _load() if (img.dtype == np.uint8 and lbl.dtype == np.uint8
                      and img.ndim == 3) else False
    if lib:
        img = np.ascontiguousarray(img)
        lbl = np.ascontiguousarray(lbl)
        io = np.empty((oh, ow, img.shape[2]), np.uint8)
        lo = np.empty((oh, ow), np.uint8)
        lib.pil_resize_pair_u8(_ptr(img, ctypes.c_uint8),
                               _ptr(lbl, ctypes.c_uint8),
                               _ptr(io, ctypes.c_uint8),
                               _ptr(lo, ctypes.c_uint8),
                               w, img.shape[2], top, left, ch, cw, oh, ow,
                               int(flip))
        return io, lo
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
    lib = _load()
    if lib:
        l32 = np.ascontiguousarray(lbl.reshape(-1), np.int32)
        p32 = np.ascontiguousarray(pred.reshape(-1), np.int32)
        lib.confusion_update_i32(_ptr(l32, ctypes.c_int32),
                                 _ptr(p32, ctypes.c_int32), l32.size,
                                 n_classes, _ptr(hist, ctypes.c_int64))
        return hist
    mask = (lbl >= 0) & (lbl < n_classes)
    idx = n_classes * lbl[mask].astype(np.int64) + pred[mask]
    hist += np.bincount(idx, minlength=n_classes**2).reshape(n_classes,
                                                            n_classes)
    return hist
