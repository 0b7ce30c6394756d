"""Fused bilinear-upsample + argmax (eval / serving path).

Counterpart of ucd_tpu/ops/fused_eval.py. `fused_argmax` turns the model's
low-res logits (B, h, w, C) into (B, H, W) int32 class ids without ever
materializing the (B, H, W, C) upsampled logits. On a CUDA tensor it
launches the hand-written kernel `csrc/fused_argmax.cu` (or raises); on a
CPU tensor it runs `fused_argmax_plain`, the same function in plain
PyTorch.

Semantics: `argmax(F.interpolate(bilinear, align_corners=False))` over the
classes with first-occurrence tie-breaking, and the JAX kernel's rule for
NaN and ±inf (`jax_pattern`). The JAX kernel upsamples the width with a
dense dot against its interpolation matrix and blends the 3 source rows of
its tile's window with per-row slot weights, so a non-finite value of a
class in those rows reaches every pixel of the tile's rows: NaN through 0
* NaN, and an inf as NaN wherever a zero weight meets it (inf * 0), as
±inf where only positive weights do, as NaN where +inf meets -inf. A pixel
with a NaN class gets class 0 (which keeps every id in range), else the
first +inf class wins; -inf never wins over a finite value, and all -inf
gives class 0. Finite classes keep F.interpolate's values. Near-exact ties
(top-2 gap at the rounding scale) may resolve differently between the
kernel and the plain version because their sums are rounded differently.
"""

from __future__ import annotations

import contextlib
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


MAX_FEEDS = 3  # (cell, tap) pairs that can land on one source index


@functools.lru_cache(maxsize=64)
def cells(n_in: int, n_out: int, identity: bool = False):
    """1-D cells of `taps(n_in, n_out, identity)`: maximal runs of
    consecutive outputs whose two taps read the same two source indices (at
    scale 16, 16 outputs; the clamped edges make longer and shorter runs).
    The 2-D cells are their products. B6 takes a block per row cell, B1 and
    B2 a warp per 2-D cell.

    Returns (table, feeds). table (n_cells, 4) int32: first output, end,
    source index of tap 0, of tap 1. feeds (n_in, MAX_FEEDS) int32: the
    (cell, tap) pairs that land on each source index, as 2 * cell + tap, in
    increasing order, -1 where there are fewer: the order in which B2's
    fold adds a source's partial sums (both taps of a clamped edge land on
    one source and add)."""
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


# ---------------------------------------------------------------------------
# the JAX kernel's non-finite rule
# ---------------------------------------------------------------------------

def jax_taps(n_in: int, n_out: int):
    """The two taps of each output of the JAX interpolation matrix
    (own copy of ucd_tpu/ops/fused_loss.py `interp_matrix`, :69-81): source
    indices clip(lo), clip(lo + 1) with weights 1 - frac, frac, lo =
    floor of the unclamped half-pixel coordinate. f64."""
    o = np.arange(n_out, dtype=np.float64)
    src = (o + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    return (np.clip(lo, 0, n_in - 1), np.clip(lo + 1, 0, n_in - 1),
            1.0 - frac, frac)


def positive_columns(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, 2) int32: the distinct source columns that each output's row
    of the JAX interpolation matrix weights positively, -1 for none (the
    first tap's weight 1 - frac is always positive). Its width dot
    multiplies every other column by 0, so an inf there is NaN."""
    c0, c1, _, w1 = jax_taps(n_in, n_out)
    second = np.where((w1 > 0) & (c1 != c0), c1, -1)
    return np.stack([c0, second], 1).astype(np.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=64)
def row_windows(h: int, H: int, W: int, C: int, bf16: bool):
    """The JAX kernel's 3-row source window of each output row and which
    of its slots weigh it positively. Own copy of ucd_tpu/ops/fused_loss.py
    `_pick_to` / `_lo_min` / `_row_plan` (:84-129) as the JAX argmax calls
    them (ucd_tpu/ops/fused_eval.py:104-106): tile height To for classes
    padded to Cp (16 for bf16 logits, else 8), tile t = y // To, slot j =
    clip(lo_min(t) + j, 0, h - 1), and each of y's two taps adds its weight
    to the first slot that holds its clamped row.

    Returns (slots (H, 3) int32, positive (H, 3) bool). A non-finite value
    of class c in a slot row makes class c non-finite on the whole output
    row: the width dot spreads it, and a slot of weight 0 turns it to
    0 * inf = NaN."""
    Cp = _round_up(C, 16 if bf16 else 8)
    Wp = _round_up(W, 128)
    to = max(1, min(8, H // h))
    while to > 1 and 2 * 4 * to * Wp * Cp > 12 * 1024 * 1024:
        to //= 2
    t = np.arange(H, dtype=np.int64) // to
    lo = (2 * t * to * h + h - H) // (2 * H)
    slots = np.clip(lo[:, None] + np.arange(3), 0, h - 1)
    r0, r1, w0, w1 = jax_taps(h, H)
    weight = np.zeros((H, 3))
    for r, wt in ((r0, w0), (r1, w1)):
        j = np.argmax(slots == r[:, None], axis=1)
        assert (slots[np.arange(H), j] == r).all(), "a tap outside the window"
        weight[np.arange(H), j] += wt
    return slots.astype(np.int32), weight > 0


def jax_pattern(logits_lr: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
    """(B, H, W, C) float32: 0 where the JAX kernel's upsampled class value
    is finite, else the NaN or ±inf it holds there. Finite values become 0
    and the two dots of the JAX upsample (width: the positive pattern of
    its interpolation matrix; height: of the window's slot weights) are
    taken elementwise, so 1 * inf = inf, 0 * inf = NaN, inf - inf = NaN,
    exactly, in any order of the sums."""
    B, h, w, C = logits_lr.shape
    H, W = int(out_hw[0]), int(out_hw[1])
    z = logits_lr.float()
    nf = torch.where(torch.isfinite(z), torch.zeros((), device=z.device), z)
    cols = torch.from_numpy(positive_columns(w, W)).to(z.device).long()
    wide = torch.zeros(B, h, W, C, device=z.device)
    for col in range(w):
        on = ((cols == col).any(dim=1)).float()[None, None, :, None]
        wide = wide + on * nf[:, :, col:col + 1, :]
    slots, positive = row_windows(h, H, W, C,
                                  logits_lr.dtype == torch.bfloat16)
    out = torch.zeros(B, H, W, C, device=z.device)
    for j in range(3):
        rows = torch.from_numpy(slots[:, j]).to(z.device).long()
        on = torch.from_numpy(positive[:, j].astype(np.float32)).to(
            z.device)[None, :, None, None]
        out = out + on * wide[:, rows]
    return out


def fused_argmax_plain(logits_lr: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: f32 bilinear upsample, argmax, and where the
    logits hold a NaN or an inf, the JAX kernel's values there
    (`jax_pattern`); a pixel with a NaN class gets class 0."""
    H, W = int(out_hw[0]), int(out_hw[1])
    up = F.interpolate(logits_lr.permute(0, 3, 1, 2).float(), size=(H, W),
                       mode="bilinear", align_corners=False)
    if not bool(torch.isfinite(logits_lr).all()):
        pattern = jax_pattern(logits_lr, (H, W)).permute(0, 3, 1, 2)
        up = torch.where(torch.isfinite(pattern), up, pattern)
    preds = up.argmax(dim=1).to(torch.int32)
    return torch.where(up.isnan().any(dim=1), 0, preds)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

MAX_SHARED = 227 * 1024


@functools.lru_cache(maxsize=64)
def argmax_plan(h: int, H: int, w: int, W: int, C: int, bf16: bool):
    """The kernel's host tables for (h, w) -> (H, W):
    cells (ncy, 8) int32 per block row: first output row, end, the two
    F.interpolate source rows, and the first and last source row of the
    JAX windows of its rows (they are consecutive), 3 zeros;
    yplan (H, 4) int32 per output row: its 3 window slots and a bit per
    slot of positive weight; fy (H,) float32 its F.interpolate row weight;
    xplan (W, 4) int32 per output column: the two F.interpolate source
    columns and the JAX matrix's positive columns (-1 for none); fx (W,)
    float32. Also the most window rows of one block (its shared memory)."""
    identity = h == H and w == W
    table, _ = cells(h, H, identity)
    slots, positive = row_windows(h, H, W, C, bf16)
    rows = np.zeros((len(table), 8), np.int32)
    rows[:, :4] = table
    for k, (a, b, src0, src1) in enumerate(table):
        # the kernel's finite test covers its taps: both lie in every
        # window of the cell's rows
        assert (slots[a:b] == src0).any(1).all() and \
            (slots[a:b] == src1).any(1).all(), (h, H, k)
        rows[k, 4], rows[k, 5] = slots[a:b].min(), slots[a:b].max()
    bits = (positive * np.array([1, 2, 4])).sum(1)
    yplan = np.concatenate([slots, bits[:, None]], 1).astype(np.int32)
    ix0, ix1, fx = taps(w, W, identity)
    xplan = np.concatenate([np.stack([ix0, ix1], 1),
                            positive_columns(w, W)], 1).astype(np.int32)
    fy = taps(h, H, identity)[2]
    max_rows = int((rows[:, 5] - rows[:, 4]).max()) + 1
    return rows, yplan, fy, xplan, fx, max_rows


_launch_plans: Dict[tuple, tuple] = {}


def _launch_plan(device, dtype, h, H, w, W, C):
    """(entry point, table pointers, shared bytes) of one launch shape on
    `device`: the tables are uploaded once and held here, so a call does
    one lookup."""
    key = (device.index, dtype, h, H, w, W, C)
    plan = _launch_plans.get(key)
    if plan is None:
        rows, yplan, fy, xplan, fx, max_rows = argmax_plan(
            h, H, w, W, C, dtype == torch.bfloat16)
        smem = max_rows * C * 4
        if smem > MAX_SHARED or w >= 1 << 15:
            raise ValueError(f"fused_argmax: {max_rows} window rows of {C} "
                             f"classes ({smem} bytes of shared memory) or "
                             f"{w} source columns is beyond the kernel")
        tables = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in (rows, yplan, fy, xplan, fx))
        plan = (_kernel_fns()[dtype], tables,
                tuple(t.data_ptr() for t in tables), len(rows), smem)
        _launch_plans[key] = plan
    return plan


@functools.lru_cache(maxsize=None)
def _kernel_fns() -> Dict[torch.dtype, object]:
    """The library's entry points by input dtype, with their C signatures:
    (z, cells, yplan, fy, xplan, fx, out, B, h, w, C, H, W, n_cells,
    shared bytes, stream) -> err."""
    lib = build.load(KERNEL)
    fns = {torch.float32: lib.ucd_fused_argmax_f32,
           torch.bfloat16: lib.ucd_fused_argmax_bf16}
    for fn in fns.values():
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
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
    device = logits_lr.device
    fn, _, ptrs, n_cells, smem = _launch_plan(device, logits_lr.dtype, h, H,
                                              w, W, C)
    out = torch.empty((B, H, W), dtype=torch.int32, device=device)
    # the launch goes to the thread's current device: switch only if needed
    with (contextlib.nullcontext()
          if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = fn(logits_lr.data_ptr(), *ptrs, out.data_ptr(), B, h, w, C, H,
                 W, n_cells, smem, build.stream(device))
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
