"""Fused bilinear-upsample + argmax (eval / serving path).

Counterpart of ucd_tpu/ops/fused_eval.py. `fused_argmax` turns the model's
low-res logits (B, h, w, C) into (B, H, W) int32 class ids without ever
materializing the (B, H, W, C) upsampled logits. On a CUDA tensor it
launches the hand-written kernel `csrc/fused_argmax.cu` (or raises); on a
CPU tensor it runs `fused_argmax_plain`, the same function in plain
PyTorch.

Semantics: `argmax(F.interpolate(bilinear, align_corners=False))` over the
classes with first-occurrence tie-breaking; a pixel with any NaN class
value gets class 0 (the JAX kernel's all-NaN rule, which keeps every id in
range). Near-exact ties (top-2 gap at the rounding scale) may resolve
differently between the kernel and the plain version because their sums
are rounded differently.
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


def fused_argmax_plain(logits_lr: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: f32 bilinear upsample, NaN rule, argmax."""
    H, W = int(out_hw[0]), int(out_hw[1])
    up = F.interpolate(logits_lr.permute(0, 3, 1, 2).float(), size=(H, W),
                       mode="bilinear", align_corners=False)
    preds = up.argmax(dim=1).to(torch.int32)
    return torch.where(up.isnan().any(dim=1), 0, preds)


@functools.lru_cache(maxsize=None)
def _kernel_fns() -> Dict[torch.dtype, object]:
    """The library's entry points by input dtype, with their C signatures:
    (z, iy0, iy1, fy, ix0, ix1, fx, out, B, h, w, C, H, W, stream) -> err."""
    lib = build.load(KERNEL)
    fns = {torch.float32: lib.ucd_fused_argmax_f32,
           torch.bfloat16: lib.ucd_fused_argmax_bf16}
    for fn in fns.values():
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
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
    iy0, iy1, fy, ix0, ix1, fx = taps_on(device, h, H, w, W)
    out = torch.empty((B, H, W), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(logits_lr.data_ptr(), iy0.data_ptr(), iy1.data_ptr(),
                 fy.data_ptr(), ix0.data_ptr(), ix1.data_ptr(),
                 fx.data_ptr(), out.data_ptr(), B, h, w, C, H, W, stream)
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
