"""Fused bilinear-upsample + CE/KD loss (train and validate steps).

Counterpart of ucd_tpu/ops/fused_loss.py. `fused_ce_kd` computes the
criterion (plain or MiB-unbiased cross-entropy) and the distillation term
(plain or unbiased KD) on the bilinearly upsampled logits straight from the
LOW-RES logits (B, h, w, C): neither the (B, H, W, C) upsampled tensors nor
their gradient ever exist in device memory. Equivalent to
`F.interpolate(bilinear, align_corners=False)` followed by
ops.losses.{cross_entropy | unbiased_cross_entropy} and
ops.losses.{knowledge_distillation | unbiased_knowledge_distillation}
(reduction='mean').

On CUDA tensors the forward launches `fused_loss_fwd_kernel` and the
backward `fused_loss_bwd_cells_kernel` + `fused_loss_fold_kernel` of
`csrc/fused_loss.cu` (or raises); on CPU
tensors `fused_ce_kd` is `fused_ce_kd_plain`, the same function in plain
PyTorch, differentiated by autograd.

Kernel notes (details in the source):
  * forward: replaces ucd_tpu/ops/fused_loss.py::_loss_kernel. Bound by
    operations (exp/log and the 4-tap interpolation per pixel and class),
    not bytes: it reads ~3 MB at the train shape. One thread per output
    pixel, two passes over the classes (each masked log-sum-exp has its own
    max), block-reduced partial sums that this wrapper adds up.
  * backward: replaces ucd_tpu/ops/fused_loss.py::_grad_kernel. Bound by
    operations. The output is cut into cells (`cells`: maximal rectangles
    of pixels whose taps read the same 2x2 source pixels); one warp per
    cell computes each pixel's softmax terms and gradient once and folds
    the cell onto its 4 corners; a second kernel adds, per low-res pixel,
    the corners that land on it in a fixed order. No atomics, the same bits
    every run.

Gradient flows to the new logits only (the donor is frozen); both
cotangents are honoured separately.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import wide_dtype
from . import build
from . import losses as L
from .fused_eval import taps, taps_on

KERNEL = "fused_loss"
CE_MODES = {"ce": 0, "unce": 1}
KD_MODES = {"none": 0, "kd": 1, "unkd": 2}
_count_lock = threading.Lock()


def supported(lowres_shape, label_shape, ce_mode: str, kd_mode: str) -> bool:
    """Whether the fused path covers this configuration: upsampling only,
    and the plain/unbiased CE/KD modes (bce/icarl/focal take the dense
    path). `lowres_shape` is NHWC."""
    _, h, w, _ = lowres_shape
    H, W = label_shape[-2], label_shape[-1]
    return (H >= h and W >= w and ce_mode in CE_MODES
            and kd_mode in KD_MODES)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_ce_kd_plain(logits_lr: torch.Tensor, labels: torch.Tensor,
                      old_logits_lr: Optional[torch.Tensor] = None, *,
                      old_cl: int = 0, ce_mode: str = "ce",
                      kd_mode: str = "none", alpha: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 bilinear upsample + the ops.losses terms
    (f64 logits stay f64). Differentiable by autograd w.r.t. `logits_lr`."""
    _check_modes(logits_lr.shape[-1], None if old_logits_lr is None
                 else old_logits_lr.shape[-1], old_cl, ce_mode, kd_mode)
    H, W = int(labels.shape[1]), int(labels.shape[2])
    dtype = wide_dtype(logits_lr.dtype)

    def upsample(x):
        return F.interpolate(x.permute(0, 3, 1, 2).to(dtype), size=(H, W),
                             mode="bilinear", align_corners=False
                             ).permute(0, 2, 3, 1)

    up = upsample(logits_lr)
    labels = labels.long()
    if ce_mode == "unce":
        loss_ce = L.unbiased_cross_entropy(up, labels, old_cl)
    else:
        loss_ce = L.cross_entropy(up, labels)
    loss_kd = torch.zeros((), dtype=dtype, device=logits_lr.device)
    if kd_mode != "none":
        up_old = upsample(old_logits_lr.detach())
        kd_fn = (L.unbiased_knowledge_distillation if kd_mode == "unkd"
                 else L.knowledge_distillation)
        loss_kd = kd_fn(up, up_old, alpha=alpha)
    return loss_ce, loss_kd


def fused_ce_kd_grad_plain(logits_lr, labels, old_logits_lr=None, *,
                           ct_ce: float = 1.0, ct_kd: float = 1.0,
                           **kw) -> torch.Tensor:
    """d(ct_ce * loss_ce + ct_kd * loss_kd) / d logits_lr by autograd
    through the plain forward."""
    z = logits_lr.detach().requires_grad_(True)
    loss_ce, loss_kd = fused_ce_kd_plain(z, labels, old_logits_lr, **kw)
    total = ct_ce * loss_ce
    if kw.get("kd_mode", "none") != "none":
        total = total + ct_kd * loss_kd
    return torch.autograd.grad(total, z)[0]


def _check_modes(C, Co, old_cl, ce_mode, kd_mode):
    if ce_mode not in CE_MODES or kd_mode not in KD_MODES:
        raise ValueError(f"unknown mode ({ce_mode!r}, {kd_mode!r})")
    if ce_mode == "unce" and not 1 <= old_cl <= C:
        raise ValueError(f"unce needs 1 <= old_cl <= C, got old_cl={old_cl}, "
                         f"C={C}")
    if kd_mode != "none":
        if Co is None:
            raise ValueError(f"kd_mode {kd_mode!r} needs old_logits_lr")
        if not 1 <= Co <= C:
            raise ValueError(f"the old logits' class count must be in "
                             f"[1, C]: Co={Co}, C={C}")


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------

MAX_FEEDS = 3  # (cell, tap) pairs that can land on one source index
# the cell kernel's block in fused_loss.cu: CELL_WARPS cells, BATCH_PX
# pixels' terms of NSTAT floats each, and sm_90's opt-in shared memory
CELL_WARPS, BATCH_PX, NSTAT = 4, 32, 16
MAX_SHARED = 227 * 1024


def bwd_shared_bytes(C: int, Co: int) -> int:
    """Shared memory of one block of the backward's cell kernel: per warp
    its cell's 2x2 corners of z and tz, the corner sums of its C classes
    and one batch of pixel terms. The only limit on the class count: the
    forward keeps nothing per class."""
    return CELL_WARPS * (8 * C + 4 * Co + BATCH_PX * NSTAT) * 4


@functools.lru_cache(maxsize=64)
def cells(n_in: int, n_out: int, identity: bool = False):
    """The backward kernel's 1-D cells of `taps(n_in, n_out, identity)`:
    maximal runs of consecutive outputs whose two taps read the same two
    source indices (at scale 16, 16 outputs; the clamped edges make
    longer and shorter runs). The 2-D cells are their products.

    Returns (table, feeds). table (n_cells, 4) int32: first output, end,
    source index of tap 0, of tap 1. feeds (n_in, MAX_FEEDS) int32: the
    (cell, tap) pairs that land on each source index, as 2 * cell + tap, in
    increasing order, -1 where there are fewer: the order in which the fold
    adds a source's partial sums (both taps of a clamped edge land on one
    source and add)."""
    i0, i1, _ = taps(n_in, n_out, identity)
    first = np.flatnonzero(np.r_[True, (i0[1:] != i0[:-1])
                                 | (i1[1:] != i1[:-1])])
    end = np.r_[first[1:], n_out]
    table = np.stack([first, end, i0[first], i1[first]], 1).astype(np.int32)
    feeds = np.full((n_in, MAX_FEEDS), -1, np.int32)
    n_feeds = np.zeros(n_in, np.int64)
    for k, (_, _, src0, src1) in enumerate(table):
        for tap, i in enumerate((src0, src1)):
            assert n_feeds[i] < MAX_FEEDS, (n_in, n_out, i)
            feeds[i, n_feeds[i]] = 2 * k + tap
            n_feeds[i] += 1
    return table, feeds


_device_cells: Dict[tuple, tuple] = {}


def _cells_on(device, h: int, H: int, w: int, W: int):
    """(y table, y feeds, x table, x feeds) of `cells` on `device`,
    uploaded once per device and shape."""
    key = (str(device), h, H, w, W)
    if key not in _device_cells:
        identity = h == H and w == W
        _device_cells[key] = tuple(
            torch.from_numpy(a).to(device)
            for a in (*cells(h, H, identity), *cells(w, W, identity)))
    return _device_cells[key]


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """(forward, backward) entry points with their C signatures:
    fwd(z, tz, labels, label_bytes, 6 tap tables, ce_part, kd_part,
        B, h, w, C, Co, H, W, old_cl, ce_mode, kd_mode, alpha, stream)
    bwd(z, tz, labels, label_bytes, 6 tap tables, 4 cell tables, coefs,
        part, dz, B, h, w, C, Co, H, W, old_cl, ce_mode, kd_mode, ncy, ncx,
        alpha, stream)."""
    lib = build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ucd_fused_loss_fwd, lib.ucd_fused_loss_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = [p, p, p, i] + [p] * 6 + [p, p] + [i] * 10 + [f, p]
    bwd.argtypes = [p, p, p, i] + [p] * 6 + [p] * 4 + [p, p, p] \
        + [i] * 12 + [f, p]
    return fwd, bwd


def _kernel_labels(labels: torch.Tensor) -> torch.Tensor:
    """Labels as the kernels take them: contiguous uint8 or int32."""
    if labels.dtype == torch.int64:
        labels = labels.to(torch.int32)
    if labels.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"fused_ce_kd takes uint8, int32 or int64 labels, "
                        f"got {labels.dtype}")
    return labels.contiguous()


def _check_cuda_inputs(z, tz, labels, kd_mode):
    if z.dtype != torch.float32:
        raise TypeError(f"fused_ce_kd kernels take float32 logits, got "
                        f"{z.dtype}")
    if not z.is_contiguous():
        raise ValueError("fused_ce_kd needs contiguous NHWC logits")
    B, h, w, C = z.shape
    if labels.ndim != 3 or labels.shape[0] != B or labels.device != z.device:
        raise ValueError(f"labels must be (B, H, W) on {z.device}, got "
                         f"{tuple(labels.shape)} on {labels.device}")
    if max(B, h, labels.shape[1]) > 65535:
        raise ValueError("grid limit: batch or height > 65535")
    if kd_mode != "none":
        if tz.dtype != torch.float32 or not tz.is_contiguous() \
                or tz.shape[:3] != z.shape[:3] or tz.device != z.device:
            raise ValueError(
                f"old logits must be contiguous float32 (B, h, w, Co) on "
                f"{z.device}, got {tz.dtype} {tuple(tz.shape)} on "
                f"{tz.device}")


def _call(fn, z, tz, labels, H, W, extra_ptrs, old_cl, ce_mode, kd_mode,
          alpha, extra_ints=()):
    B, h, w, C = z.shape
    Co = tz.shape[-1] if tz is not None else 1
    device = z.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(z.data_ptr(), tz.data_ptr() if tz is not None else None,
                 labels.data_ptr(), labels.element_size(),
                 *(t.data_ptr() for t in taps_on(device, h, H, w, W)),
                 *(t.data_ptr() for t in extra_ptrs),
                 B, h, w, C, Co, H, W, int(old_cl), CE_MODES[ce_mode],
                 KD_MODES[kd_mode], *extra_ints, float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")


def launch_fwd(z, tz, labels, *, old_cl, ce_mode, kd_mode, alpha):
    """Launch the forward kernel on checked CUDA inputs. Returns the (2,
    n_blocks) per-block partial sums of the CE and the KD term."""
    B, h, w, C = z.shape
    H, W = int(labels.shape[1]), int(labels.shape[2])
    fwd, _ = _kernel_fns()
    n_blocks = B * H * (-(-W // 128))
    parts = torch.empty((2, n_blocks), dtype=torch.float32, device=z.device)
    _call(fwd, z, tz, labels, H, W, (parts[0], parts[1]), old_cl, ce_mode,
          kd_mode, alpha)
    with _count_lock:
        fused_ce_kd.launches_fwd += 1
    return parts


def launch_bwd(z, tz, labels, coefs, *, old_cl, ce_mode, kd_mode, alpha):
    """Launch the backward (its cell kernel, then its fold kernel) on
    checked CUDA inputs. `coefs` holds the per-pixel scales of the two
    terms' gradients, (ct_ce / n_pix, -ct_kd / (Co * n_pix)), as a float32
    tensor of 2 on the device. Returns dz, shaped like z."""
    B, h, w, C = z.shape
    H, W = int(labels.shape[1]), int(labels.shape[2])
    Co = tz.shape[-1] if tz is not None else 1
    if bwd_shared_bytes(C, Co) > MAX_SHARED:
        raise ValueError(f"the fused_ce_kd backward holds {C} + {Co} classes "
                         f"in {bwd_shared_bytes(C, Co)} bytes of shared "
                         f"memory a block, over the card's {MAX_SHARED}")
    _, bwd = _kernel_fns()
    tables = _cells_on(z.device, h, H, w, W)
    ncy, ncx = tables[0].shape[0], tables[2].shape[0]
    # each cell's gradient folded onto its 2 x 2 corners
    part = torch.empty(B * ncy * ncx * 4 * C, dtype=torch.float32,
                       device=z.device)
    dz = torch.empty_like(z)
    _call(bwd, z, tz, labels, H, W, (*tables, coefs, part, dz), old_cl,
          ce_mode, kd_mode, alpha, (ncy, ncx))
    with _count_lock:
        fused_ce_kd.launches_bwd += 1
    return dz


class _FusedCeKd(torch.autograd.Function):
    """forward -> fused_loss_fwd_kernel, backward -> the cell and fold
    kernels (`launch_bwd`). `tz` is None when kd_mode is "none" (the kernels
    never read it)."""

    @staticmethod
    def forward(ctx, z, tz, labels, old_cl, ce_mode, kd_mode, alpha):
        kw = dict(old_cl=old_cl, ce_mode=ce_mode, kd_mode=kd_mode,
                  alpha=alpha)
        parts = launch_fwd(z, tz, labels, **kw)
        sums = parts.sum(dim=1, dtype=torch.float64)
        n_pix = labels.numel()
        Co = tz.shape[-1] if tz is not None else 1
        ctx.save_for_backward(z, tz, labels)
        ctx.kw = kw
        return ((sums[0] / n_pix).float(),
                (-sums[1] / (Co * n_pix)).float())

    @staticmethod
    def backward(ctx, ct_ce, ct_kd):
        z, tz, labels = ctx.saved_tensors
        n_pix = labels.numel()
        Co = tz.shape[-1] if tz is not None else 1
        coefs = torch.stack([ct_ce.float() / n_pix,
                             -ct_kd.float() / (Co * n_pix)]).contiguous()
        dz = launch_bwd(z, tz, labels, coefs, **ctx.kw)
        return dz, None, None, None, None, None, None


def fused_ce_kd(logits_lr: torch.Tensor, labels: torch.Tensor,
                old_logits_lr: Optional[torch.Tensor] = None, *,
                old_cl: int = 0, ce_mode: str = "ce", kd_mode: str = "none",
                alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_ce, loss_kd) on bilinearly upsampled logits, fused.

    `logits_lr` (B, h, w, C) and `old_logits_lr` (B, h, w, Co) are NHWC,
    `labels` (B, H, W) uint8 / int32 / int64 with ignore value 255. CUDA
    tensors launch the kernels (counted in `fused_ce_kd.launches_fwd` /
    `.launches_bwd`) or raise; CPU tensors take `fused_ce_kd_plain`.
    Gradient flows to `logits_lr` only."""
    if logits_lr.ndim != 4:
        raise ValueError(f"expected (B, h, w, C) logits, got "
                         f"{tuple(logits_lr.shape)}")
    if logits_lr.device.type == "cpu":
        return fused_ce_kd_plain(logits_lr, labels, old_logits_lr,
                                 old_cl=old_cl, ce_mode=ce_mode,
                                 kd_mode=kd_mode, alpha=alpha)
    if logits_lr.device.type != "cuda":
        raise ValueError(f"fused_ce_kd runs on CUDA or CPU tensors, got "
                         f"{logits_lr.device}")
    tz = None if kd_mode == "none" else old_logits_lr
    _check_modes(logits_lr.shape[-1], None if tz is None else tz.shape[-1],
                 old_cl, ce_mode, kd_mode)
    if not supported(logits_lr.shape, labels.shape, ce_mode, kd_mode):
        raise ValueError(f"fused_ce_kd upsamples only: "
                         f"{tuple(logits_lr.shape[1:3])} -> "
                         f"{tuple(labels.shape[1:3])}")
    labels = _kernel_labels(labels)
    _check_cuda_inputs(logits_lr, tz, labels, kd_mode)
    if tz is not None:
        tz = tz.detach()
    return _FusedCeKd.apply(logits_lr, tz, labels, int(old_cl), ce_mode,
                            kd_mode, float(alpha))


fused_ce_kd.launches_fwd = 0
fused_ce_kd.launches_bwd = 0
