"""Fused bilinear-upsample + argmax (eval / serving path).

Counterpart of ucd_tpu/ops/fused_eval.py. `fused_argmax` turns the model's
low-res logits (B, h, w, C) into (B, H, W) int32 class ids without ever
materializing the (B, H, W, C) upsampled logits. On a CUDA tensor it
launches the hand-written kernel `csrc/fused_argmax.cu` (or raises); on a
CPU tensor it runs `fused_argmax_plain`, the same function in plain
PyTorch.

Semantics: `argmax(F.interpolate(bilinear, align_corners=False))` over the
classes with first-occurrence tie-breaking, and the JAX kernel's NaN rule,
which keeps every id in range: an output pixel (b, y, x) gets class 0 when
any value of the source rows z[b, r, :, :] of its tile's 3-row window is
NaN (`nan_windows`), or when its own upsampled value is NaN. The JAX kernel
upsamples the width with a dense dot, so one NaN anywhere in those rows
reaches every pixel of the tile's rows through 0 * NaN. Near-exact ties
(top-2 gap at the rounding scale) may resolve differently between the
kernel and the plain version because their sums are rounded differently.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

KERNEL = "fused_argmax"
_count_lock = threading.Lock()


def supported(lowres_shape, out_hw) -> bool:
    """Upsampling only, as for the JAX kernel (`lowres_shape` is NHWC)."""
    _, h, w, _ = lowres_shape
    return int(out_hw[0]) >= h and int(out_hw[1]) >= w


@functools.lru_cache(maxsize=64)
def taps(n_in: int, n_out: int, identity: bool = False):
    """1-D bilinear taps (index0, index1, frac) for n_in -> n_out, from the
    f64 half-pixel formula of the JAX interpolation matrix
    (ucd_tpu/ops/fused_loss.py::interp_matrix): output o reads
    (1-frac)*in[index0] + frac*in[index1].

    The taps follow F.interpolate's structure, so NaN spreads to the same
    pixels in the kernel as in the plain version: the source coordinate is
    clamped at 0 and index1 = min(index0+1, n_in-1) even where frac is 0.
    F.interpolate copies when both dims keep their size (`identity`), so
    there index1 = index0."""
    o = np.arange(n_out, dtype=np.float64)
    src = np.maximum((o + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = i0 if identity else np.minimum(i0 + 1, n_in - 1)
    frac = (src - i0).astype(np.float32)
    return i0.astype(np.int32), i1.astype(np.int32), frac


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=64)
def nan_windows(h: int, H: int, W: int, C: int, bf16: bool) -> np.ndarray:
    """(H, 3) int32: for each output row y, the three source rows whose NaN
    turns the whole row to class 0 in the JAX kernel. They are the 3-row
    window of y's tile, slot j = clip(lo_min(t) + j, 0, h - 1) with
    t = y // To, where To is the JAX kernel's tile height for classes
    padded to Cp (16 for bf16 logits, else 8). Own copy of
    ucd_tpu/ops/fused_loss.py `_lo_min` / `_pick_to` (:84-129) as the JAX
    argmax calls them (ucd_tpu/ops/fused_eval.py:104-105)."""
    Cp = _round_up(C, 16 if bf16 else 8)
    Wp = _round_up(W, 128)
    to = max(1, min(8, H // h))
    while to > 1 and 2 * 4 * to * Wp * Cp > 12 * 1024 * 1024:
        to //= 2
    t = np.arange(H, dtype=np.int64) // to
    lo = (2 * t * to * h + h - H) // (2 * H)
    return np.clip(lo[:, None] + np.arange(3), 0, h - 1).astype(np.int32)


_device_taps: Dict[tuple, tuple] = {}


def taps_on(device, h: int, H: int, w: int, W: int):
    """The six tap tables (iy0, iy1, fy, ix0, ix1, fx) of (h, w) -> (H, W)
    as tensors on `device`, uploaded once per device and shape."""
    key = (str(device), h, H, w, W)
    if key not in _device_taps:
        identity = h == H and w == W
        _device_taps[key] = tuple(
            torch.from_numpy(a).to(device)
            for a in (*taps(h, H, identity), *taps(w, W, identity)))
    return _device_taps[key]


_device_windows: Dict[tuple, torch.Tensor] = {}


def _windows_on(device, h: int, H: int, W: int, C: int, bf16: bool):
    key = (str(device), h, H, W, C, bf16)
    if key not in _device_windows:
        _device_windows[key] = torch.from_numpy(
            nan_windows(h, H, W, C, bf16)).to(device)
    return _device_windows[key]


def nan_rows(logits_lr: torch.Tensor, out_hw: Tuple[int, int]
             ) -> torch.Tensor:
    """(B, H) bool: the output rows that the NaN rule sets to class 0 whole
    (a NaN in their tile's source window)."""
    B, h, w, C = logits_lr.shape
    bad = logits_lr.isnan().reshape(B, h, w * C).any(dim=2)
    win = _windows_on(logits_lr.device, h, int(out_hw[0]), int(out_hw[1]),
                      C, logits_lr.dtype == torch.bfloat16)
    return bad[:, win.long()].any(dim=2)


def fused_argmax_plain(logits_lr: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: f32 bilinear upsample, argmax, NaN rule."""
    H, W = int(out_hw[0]), int(out_hw[1])
    up = F.interpolate(logits_lr.permute(0, 3, 1, 2).float(), size=(H, W),
                       mode="bilinear", align_corners=False)
    preds = up.argmax(dim=1).to(torch.int32)
    zero = up.isnan().any(dim=1) | nan_rows(logits_lr, (H, W))[:, :, None]
    return torch.where(zero, 0, preds)


@functools.lru_cache(maxsize=None)
def _kernel_fns() -> Dict[torch.dtype, object]:
    """The library's entry points by input dtype, with their C signatures:
    (z, iy0, iy1, fy, ix0, ix1, fx, win, row_nan, out, B, h, w, C, H, W,
    stream) -> err."""
    lib = build.load(KERNEL)
    fns = {torch.float32: lib.ucd_fused_argmax_f32,
           torch.bfloat16: lib.ucd_fused_argmax_bf16}
    for fn in fns.values():
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
    return fns


def _launch(logits_lr: torch.Tensor, H: int, W: int) -> torch.Tensor:
    B, h, w, C = logits_lr.shape
    if logits_lr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_argmax takes float32 or bfloat16 logits, "
                        f"got {logits_lr.dtype}")
    if not logits_lr.is_contiguous():
        raise ValueError("fused_argmax needs contiguous NHWC logits")
    if not supported(logits_lr.shape, (H, W)):
        raise ValueError(f"fused_argmax upsamples only: {(h, w)} -> "
                         f"{(H, W)}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid limit: batch {B} or height {H} > 65535")
    fn = _kernel_fns()[logits_lr.dtype]
    device = logits_lr.device
    tables = (*taps_on(device, h, H, w, W),
              _windows_on(device, h, H, W, C,
                          logits_lr.dtype == torch.bfloat16))
    row_nan = torch.empty(B * h, dtype=torch.uint8, device=device)
    out = torch.empty((B, H, W), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(logits_lr.data_ptr(), *(t.data_ptr() for t in tables),
                 row_nan.data_ptr(), out.data_ptr(), B, h, w, C, H, W,
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_argmax kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        fused_argmax.launches += 1
    return out


def fused_argmax(logits_lr: torch.Tensor,
                 out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) int32 argmax of the bilinearly upsampled NHWC logits
    (B, h, w, C), fused. A CUDA tensor launches the kernel (counted in
    `fused_argmax.launches`) or raises; a CPU tensor takes the plain
    version."""
    H, W = int(out_hw[0]), int(out_hw[1])
    if logits_lr.ndim != 4:
        raise ValueError(f"expected (B, h, w, C) logits, got "
                         f"{tuple(logits_lr.shape)}")
    if logits_lr.device.type == "cpu":
        return fused_argmax_plain(logits_lr, (H, W))
    if logits_lr.device.type != "cuda":
        raise ValueError(f"fused_argmax runs on CUDA or CPU tensors, got "
                         f"{logits_lr.device}")
    return _launch(logits_lr, H, W)


fused_argmax.launches = 0
