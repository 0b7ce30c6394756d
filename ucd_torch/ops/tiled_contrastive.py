"""Streaming (tiled) UCD pixel-contrastive loss: the wrapper of the CUDA
kernels of `csrc/tiled_contrastive.cu` (f32-FMA variant) and
`csrc/tiled_contrastive_mma.cuh` (tensor-core variant), their plain PyTorch
versions and their launch counts.

Counterpart of ucd_tpu/ops/pallas_contrastive.py:

  pixel_contrastive_loss_tiled   <- pixel_contrastive_loss_pallas (with its
                                    custom_vjp: _pallas_fwd / _pallas_bwd)
  launch_pass1 / pass1_plain     <- _pass1_kernel: neg_i, num_i per anchor
  launch_pass2 / pass2_plain     <- _pass2_kernel: S_i, G_i per anchor
  launch_bwd / bwd_plain         <- _bwd_kernel: dA, the gradient to the
                                    anchor features (closed form)
  prepare, bf16_layout           <- _prep (checks, casts, padding)
  finish_loss, backward_coef     <- the reductions around the kernels in
                                    _pallas_fwd_impl and _pallas_bwd

Same function as ops.contrastive.pixel_contrastive_loss (stabilized form)
without ever holding an anchors x contrast matrix: pass 1 streams the
contrast set once for the negative partition sum, pass 2 a second time for
the weighted positive terms, the backward a third time for dA. Gradient
flows to `anchor_feat` only; the contrast set, the probabilities and every
mask are constants.

`compute_dtype` float32 multiplies in true f32; bfloat16 rounds features and
probabilities to bf16 once (products still accumulate in f32) and rounds
dL/dadc to bf16 before the backward's second product, as the JAX kernel's
bf16 mode does. The plain versions round at the same points.

Two kernel variants, chosen from the mode alone (`kernel_variant`), with no
fallback from one to the other:

  "fma"  f32 mode: pass 1, pass 2 and the backward as f32 FMAs on float32
         operands (no padding: the kernels mask the ragged edges). Bound by
         operations at the f32 rate; one block per 64 anchors walks all
         contrast tiles, every sum stays in registers.
  "mma"  bf16 mode: pass 1, pass 2 and the backward on the tensor cores
         (`mma.sync` m16n8k16, bf16 x bf16 -> f32, exact products). They
         read 2-byte operands that `bf16_layout` casts once and zero-pads to
         the `mma.sync` tile shapes (rows of P to 256, rows of M to 64, D
         and C to 16; padded slots are invalid, so they change no sum).
         Bound by operations at the bf16 tensor-core rate: the anchor tile
         is resident in shared memory, contrast tiles arrive through a
         `cp.async` ring, dL/dadc goes from the first product's accumulators
         to the second product's operand in registers, and the walk over M
         is split into parts (`m_parts`) whose partial neg, num, S, G and dA
         the wrapper adds in a fixed order (`sum_parts`), so that two runs
         give the same bits.

On a CUDA batch the loss launches the kernels (or raises); on a CPU batch
it runs the plain versions (float64 stays float64 there, a test-only
dtype). The plain versions hold P x M matrices: they are for tests and for
the on-card comparison, not for the train path.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build
from .contrastive import ContrastiveBatch, pair_masks

KERNEL = "tiled_contrastive"
_count_lock = threading.Lock()


def _check_dtype(compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype}")


def _rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x as the kernels' products see it: rounded to bf16 in bf16 mode."""
    if compute_dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pair_terms(batch: ContrastiveBatch, temperature: float, compute_dtype):
    """(adc, e = exp(adc), mask_p, mask_n, m_gt), each (P, M)."""
    A = _rounded(batch.anchor_feat.detach(), compute_dtype)
    C = _rounded(batch.contrast_feat.detach(), compute_dtype)
    adc = (A @ C.T) / temperature
    return (adc, adc.exp()) + pair_masks(batch)


def _weights(batch, mask_p, m_gt, compute_dtype):
    """w = JM on the positive pairs (1 where both slots are GT-new), else
    0."""
    jm = _rounded(batch.anchor_prob.detach(), compute_dtype) \
        @ _rounded(batch.contrast_prob.detach(), compute_dtype).T
    jm = torch.where(m_gt, torch.ones_like(jm), jm)
    return torch.where(mask_p, jm, torch.zeros_like(jm))


def pass1_plain(batch: ContrastiveBatch, temperature: float = 0.07,
                compute_dtype=torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, num): neg_i = sum_j mask_n exp(adc_ij), num_i = sum_j mask_p,
    each (P,)."""
    _check_dtype(compute_dtype)
    _, e, mask_p, mask_n, _ = _pair_terms(batch, temperature, compute_dtype)
    neg = torch.where(mask_n, e, torch.zeros_like(e)).sum(dim=1)
    return neg, mask_p.sum(dim=1).to(e.dtype)


def pass2_plain(batch: ContrastiveBatch, neg: torch.Tensor,
                temperature: float = 0.07, compute_dtype=torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, G): S_i = sum_j w_ij (adc_ij - log(e_ij + neg_i)),
    G_i = sum_j w_ij / (e_ij + neg_i), each (P,)."""
    _check_dtype(compute_dtype)
    adc, e, mask_p, _, m_gt = _pair_terms(batch, temperature, compute_dtype)
    w = _weights(batch, mask_p, m_gt, compute_dtype)
    denom = e + neg[:, None]
    return ((w * (adc - denom.log())).sum(dim=1), (w / denom).sum(dim=1))


def bwd_plain(batch: ContrastiveBatch, neg: torch.Tensor, g: torch.Tensor,
              coef: torch.Tensor, temperature: float = 0.07,
              compute_dtype=torch.float32) -> torch.Tensor:
    """dA (P, D) in closed form: dA_i = sum_j dadc_ij c_j / tau with
    dadc_ij = coef_i [w_ij (1 - e_ij / (e_ij + neg_i)) - mask_n e_ij G_i]."""
    _check_dtype(compute_dtype)
    _, e, mask_p, mask_n, m_gt = _pair_terms(batch, temperature,
                                             compute_dtype)
    w = _weights(batch, mask_p, m_gt, compute_dtype)
    denom = e + neg[:, None]
    dadc = coef[:, None] * (
        w * (1.0 - e / denom)
        - torch.where(mask_n, e, torch.zeros_like(e)) * g[:, None])
    dadc = _rounded(dadc, compute_dtype)
    C = _rounded(batch.contrast_feat.detach(), compute_dtype)
    return (dadc @ C) / temperature


def finish_loss(s: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """Mean of -S_i / num_i over the anchors that have a positive (0 when
    none has)."""
    has_pos = num > 0
    n_active = has_pos.sum().clamp_min(1)
    per_anchor = -s / num.clamp_min(1.0)
    return torch.where(has_pos, per_anchor,
                       torch.zeros_like(per_anchor)).sum() / n_active


def backward_coef(num: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """coef_i = d loss / d S_i times the incoming cotangent `ct` (a 0-d
    tensor on the device): -ct / (num_i n_active) where num_i > 0, else 0."""
    has_pos = num > 0
    n_active = has_pos.sum().clamp_min(1).to(num.dtype)
    return torch.where(has_pos, -ct.to(num.dtype)
                       / (num.clamp_min(1.0) * n_active),
                       torch.zeros_like(num))


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------

# The tensor-core kernels' tiles (csrc/tiled_contrastive_mma.cuh): contrast
# slots per ring stage, anchors per block of each kernel, the depth of one
# `mma.sync` step, and the dynamic shared memory a block may use.
MMA_TILE_C = 64
MMA_TILE_A = {"pass1": (256, 128), "pass2": (256, 128),
              "bwd": (128,)}  # preferred first
MMA_K = 16
MMA_SMEM_LIMIT = 232448
MMA_MAX_STAGES = 4
MMA_MAX_PARTS = 16


def kernel_variant(compute_dtype) -> str:
    """Which kernels pass 1, pass 2 and the backward launch on a CUDA batch:
    "fma" (f32 FMAs) in float32 mode, "mma" (tensor cores) in bfloat16
    mode. Nothing else decides it, and neither gives way to the other."""
    _check_dtype(compute_dtype)
    return "mma" if compute_dtype == torch.bfloat16 else "fma"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Bf16Operands(NamedTuple):
    """A batch as the tensor-core kernels take it: contiguous bfloat16
    features (P', D'), (M', D') and probabilities (P', C'), (M', C'),
    zero-padded; int32 labels and one byte per validity / is-new bit, padded
    to P' / M' with invalid slots; `dims` the true (P, M, D, C)."""
    af: torch.Tensor
    ap: torch.Tensor
    cf: torch.Tensor
    cp: torch.Tensor
    slots: tuple            # la, av, an, lc, cv, cn
    dims: tuple


def bf16_layout(anchor_feat, anchor_prob, contrast_feat, contrast_prob,
                slots: Sequence[torch.Tensor],
                tile_a: int = max(max(MMA_TILE_A.values())),
                tile_c: int = MMA_TILE_C) -> Bf16Operands:
    """Cast features and probabilities to bfloat16 once (round to nearest
    even: the values `_rounded` gives, in 2 bytes) and zero-pad them to what
    `mma.sync` takes: D and C to a multiple of 16, the rows
    of P to `tile_a`, the rows of M to `tile_c`. The slot arrays (la, av, an,
    lc, cv, cn: int32 labels, uint8 flags) are padded with invalid slots,
    which enter no sum. Works on CPU and CUDA tensors. Where a shape is
    already aligned nothing is copied beyond the cast: the train shape
    (P 8192, M 16384, D 256, C 16) pays nothing for padding."""
    P, D = anchor_feat.shape
    M, C = contrast_feat.shape[0], anchor_prob.shape[1]
    Pp, Mp = _round_up(P, tile_a), _round_up(M, tile_c)
    Dp, Cp = _round_up(D, MMA_K), _round_up(C, MMA_K)

    def pad(x, rows, cols=None):
        if cols is None:
            return (x if x.shape[0] == rows
                    else F.pad(x, (0, rows - x.shape[0]))).contiguous()
        x = x.detach().to(torch.bfloat16)
        if x.shape != (rows, cols):
            x = F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))
        return x.contiguous()

    la, av, an, lc, cv, cn = slots
    return Bf16Operands(
        pad(anchor_feat, Pp, Dp), pad(anchor_prob, Pp, Cp),
        pad(contrast_feat, Mp, Dp), pad(contrast_prob, Mp, Cp),
        (pad(la, Pp), pad(av, Pp), pad(an, Pp),
         pad(lc, Mp), pad(cv, Mp), pad(cn, Mp)), (P, M, D, C))


def ring_stages(D: int, C: int, tile_a: int,
                max_stages: int = MMA_MAX_STAGES) -> int:
    """Stages of the contrast-tile ring that fit beside the resident anchor
    tile in a block's shared memory, for padded widths D and C (the byte
    layout of `mma::geometry`; C = 0 for pass 1, whose rows keep their 16
    padding bytes); at most `max_stages`. Raises if not even two fit."""
    pitch = (D * 2 + 16) + (C * 2 + 16)
    anchors = tile_a * pitch
    stage = MMA_TILE_C * pitch + MMA_TILE_C * 6
    stages = min(max_stages, (MMA_SMEM_LIMIT - anchors) // stage)
    if stages < 2:
        raise ValueError(
            f"the tensor-core contrastive kernels need {anchors} + 2 x "
            f"{stage} bytes of shared memory at D={D}, C={C}; a block has "
            f"{MMA_SMEM_LIMIT}")
    return stages


def m_parts(n_row_blocks: int, n_tiles: int, n_sm: int,
            parts: Optional[int] = None) -> int:
    """Into how many parts the walk over the `n_tiles` contrast tiles is
    split (the grid's second axis): enough for `n_row_blocks` x parts blocks
    to fill `n_sm` multiprocessors once, at most MMA_MAX_PARTS, and no part
    without a tile. A function of the shapes and the card alone, so the
    order of every sum is fixed. `parts` overrides the choice (it is
    normalized the same way)."""
    if parts is None:
        parts = max(1, min(MMA_MAX_PARTS, n_sm // max(n_row_blocks, 1)))
    parts = max(1, min(parts, n_tiles))
    per_part = -(-n_tiles // parts)
    return -(-n_tiles // per_part)


def sum_parts(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis (the parts of the walk over M) from the
    first part to the last: a fixed order, so the same bits every run."""
    out = parts[0]
    for k in range(1, parts.shape[0]):
        out = out + parts[k]
    return out


class MmaTune(NamedTuple):
    """Launch parameters of a tensor-core kernel that a measurement may
    override; None keeps the wrapper's choice."""
    tile_a: Optional[int] = None      # anchors per block
    parts: Optional[int] = None       # parts of the walk over M
    max_stages: Optional[int] = None  # cap of the ring depth
    known_depth: Optional[int] = None  # backward; 0: general code at D 256


def anchor_tile(kernel: str, D: int, C: int) -> int:
    """Anchors per block of a tensor-core kernel ("pass1" | "pass2" |
    "bwd") at padded widths D, C (0 for pass 1): the first of its tiles
    whose resident anchors leave room for a ring (passes 1 and 2 take 256
    anchors = 16 warps where they fit, pass 2 128 with ADE's 151
    probabilities). Raises if none does."""
    for tile_a in MMA_TILE_A[kernel]:
        try:
            ring_stages(D, C, tile_a)
            return tile_a
        except ValueError as e:
            err = e
    raise err


class Prepared(NamedTuple):
    """A batch as the kernels take it. f32 mode: `af`, `ap`, `cf`, `cp`
    contiguous float32 for the FMA kernels, `mma` None. bf16 mode: those
    four are None and `mma` holds the padded 2-byte operands of the
    tensor-core kernels. `slots`: int32 labels, one byte per validity /
    is-new bit. `variant`: what the three kernels launch."""
    af: Optional[torch.Tensor]
    ap: Optional[torch.Tensor]
    cf: Optional[torch.Tensor]
    cp: Optional[torch.Tensor]
    slots: tuple            # la, av, an, lc, cv, cn
    variant: str            # "fma" | "mma"
    mma: Optional[Bf16Operands]
    dims: tuple             # P, M, D, C

    @property
    def device(self) -> torch.device:
        return self.slots[0].device


def prepare(batch: ContrastiveBatch, compute_dtype=torch.float32) -> Prepared:
    """Check a CUDA batch and lay it out for the kernels of its mode
    (`layout_batch`)."""
    if batch.anchor_feat.device.type != "cuda":
        raise ValueError(f"the tiled contrastive kernels run on CUDA "
                         f"tensors, got {batch.anchor_feat.device}")
    return layout_batch(batch, compute_dtype)


def layout_batch(batch: ContrastiveBatch,
                 compute_dtype=torch.float32) -> Prepared:
    """Check a batch and lay it out for the kernels of its mode, on the
    batch's device: float32 operands as they are for the FMA variant (no
    padding: those kernels mask the ragged edges themselves), `bf16_layout`
    alone for the tensor-core variant (no float32 copy of any operand)."""
    variant = kernel_variant(compute_dtype)
    A, C = batch.anchor_feat, batch.contrast_feat
    if A.dtype != torch.float32 or C.dtype != torch.float32 \
            or batch.anchor_prob.dtype != torch.float32 \
            or batch.contrast_prob.dtype != torch.float32:
        raise TypeError(
            f"the tiled contrastive kernels take float32 features and "
            f"probabilities, got {A.dtype}, {C.dtype}, "
            f"{batch.anchor_prob.dtype}, {batch.contrast_prob.dtype}")
    if A.ndim != 2 or C.ndim != 2 or A.shape[1] != C.shape[1]:
        raise ValueError(f"features must be (P, D) and (M, D), got "
                         f"{tuple(A.shape)} and {tuple(C.shape)}")
    P, M = A.shape[0], C.shape[0]
    if batch.anchor_prob.shape[0] != P or batch.contrast_prob.shape[0] != M \
            or batch.anchor_prob.shape[1] != batch.contrast_prob.shape[1]:
        raise ValueError(
            f"probabilities must be (P, C) and (M, C), got "
            f"{tuple(batch.anchor_prob.shape)} and "
            f"{tuple(batch.contrast_prob.shape)}")
    dims = (P, M, A.shape[1], batch.anchor_prob.shape[1])
    if min(dims) < 1:
        raise ValueError("empty contrastive batch")
    slots = []
    for n, label, valid, is_new in (
            (P, batch.anchor_label, batch.anchor_valid, batch.anchor_is_new),
            (M, batch.contrast_label, batch.contrast_valid,
             batch.contrast_is_new)):
        for t, dt in ((label, torch.int32), (valid, torch.bool),
                      (is_new, torch.bool)):
            if t.shape != (n,) or t.dtype != dt or t.device != A.device:
                raise ValueError(
                    f"expected a ({n},) {dt} slot tensor on {A.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
        slots += [label.contiguous(), valid.contiguous().view(torch.uint8),
                  is_new.contiguous().view(torch.uint8)]
    slots = tuple(slots)
    if variant == "fma":
        def cast(x):
            return x.detach().contiguous()

        return Prepared(cast(A), cast(batch.anchor_prob), cast(C),
                        cast(batch.contrast_prob), slots, variant, None, dims)
    ops = bf16_layout(A, batch.anchor_prob, C, batch.contrast_prob, slots)
    # cp.async copies 16 bytes at a time from 16-byte aligned addresses
    ops = ops._replace(slots=tuple(
        t if t.data_ptr() % 16 == 0 else t.clone() for t in ops.slots))
    return Prepared(None, None, None, None, slots, variant, ops, dims)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The C entry points with their signatures:
    pass1(af, cf, 6 slot arrays, neg, num, P, M, D, tau, stream)
    pass2(af, ap, cf, cp, 6 slot arrays, neg, s, g, P, M, D, C, tau, stream)
    bwd(af, ap, cf, cp, 6 slot arrays, neg, g, coef, da, P, M, D, C, tau,
        stream)
    pass1_mma / pass2_mma / bwd_mma: the same pointers (bf16 operands,
        padded), then the same sizes, tau, parts, stages, tile_a,
        (bwd_mma: known_depth,) stream."""
    lib = build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {"pass1": (lib.ucd_contrastive_pass1, 10, 3),
           "pass2": (lib.ucd_contrastive_pass2, 13, 4),
           "bwd": (lib.ucd_contrastive_bwd, 14, 4),
           "pass1_mma": (lib.ucd_contrastive_pass1_mma, 10, 3),
           "pass2_mma": (lib.ucd_contrastive_pass2_mma, 13, 4),
           "bwd_mma": (lib.ucd_contrastive_bwd_mma, 14, 4)}
    for name, (fn, n_ptr, n_int) in fns.items():
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [f] \
            + [i] * {"pass1_mma": 3, "pass2_mma": 3,
                     "bwd_mma": 4}.get(name, 0) + [p]
    return {name: fn for name, (fn, _, _) in fns.items()}


def _call(name: str, device, ptrs, ints, temperature: float, *flags):
    fn = _kernel_fns()[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in ptrs), *ints, float(temperature),
                 *flags, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel {name} failed to launch: CUDA "
                           f"error {err}")


def _row(prep: Prepared) -> torch.Tensor:
    return torch.empty(prep.dims[0], dtype=torch.float32,
                       device=prep.device)


def _check_rows(prep: Prepared, *rows: torch.Tensor):
    """Per-anchor kernel inputs: contiguous f32 (P,) on the batch's
    device."""
    P = prep.dims[0]
    for x in rows:
        if x.shape != (P,) or x.dtype != torch.float32 \
                or x.device != prep.device or not x.is_contiguous():
            raise ValueError(
                f"expected a contiguous float32 ({P},) tensor on "
                f"{prep.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _call_mma(kernel: str, prep: Prepared, rows, out_cols, temperature,
              tune: Optional[MmaTune]):
    """Launch a tensor-core kernel over the padded operands: `rows` are its
    per-anchor inputs (padded here with zeros), the outputs are allocated as
    (parts, P', *out_cols) each and returned. Pass 1 takes no
    probabilities (C = 0)."""
    ops, tune = prep.mma, tune or MmaTune()
    (Pp, Dp), Mp = ops.af.shape, ops.cf.shape[0]
    if kernel == "pass1":
        Cp, feats, sizes = 0, (ops.af, ops.cf), (Pp, Mp, Dp)
    else:
        Cp = ops.ap.shape[1]
        feats, sizes = (ops.af, ops.ap, ops.cf, ops.cp), (Pp, Mp, Dp, Cp)
    tile_a = tune.tile_a or anchor_tile(kernel, Dp, Cp)
    if Pp % tile_a:
        raise ValueError(f"anchor tile {tile_a} does not divide the padded "
                         f"P = {Pp}")
    device = ops.af.device
    stages = ring_stages(Dp, Cp, tile_a, tune.max_stages or MMA_MAX_STAGES)
    parts = m_parts(Pp // tile_a, Mp // MMA_TILE_C, _n_sm(device.index),
                    tune.parts)
    P = prep.dims[0]
    rows = [x if Pp == P else F.pad(x, (0, Pp - P)) for x in rows]
    out = [torch.empty((parts, Pp, *cols), dtype=torch.float32,
                       device=device) for cols in out_cols]
    _call(f"{kernel}_mma", device, (*feats, *ops.slots, *rows, *out),
          sizes, temperature, parts, stages, tile_a,
          *((1 if tune.known_depth is None else tune.known_depth,)
            if kernel == "bwd" else ()))
    return out


def launch_pass1(prep: Prepared, temperature: float, *,
                 tune: Optional[MmaTune] = None):
    """Launch contrastive_pass1_kernel (FMA variant) or
    contrastive_pass1_mma_kernel (tensor-core variant; `tune` overrides its
    launch parameters, for measurements). Returns (neg, num), f32 (P,)."""
    mma = prep.variant == "mma"
    P, M, D, _ = prep.dims
    if mma:
        neg, num = (sum_parts(x)[:P] for x in _call_mma(
            "pass1", prep, (), ((), ()), temperature, tune))
    else:
        neg, num = _row(prep), _row(prep)
        _call("pass1", prep.device,
              (prep.af, prep.cf, *prep.slots, neg, num), (P, M, D),
              temperature)
    with _count_lock:
        pixel_contrastive_loss_tiled.launches_pass1 += 1
        pixel_contrastive_loss_tiled.launches_pass1_mma += mma
    return neg, num


def launch_pass2(prep: Prepared, neg: torch.Tensor, temperature: float, *,
                 tune: Optional[MmaTune] = None):
    """Launch contrastive_pass2_kernel (FMA variant) or
    contrastive_pass2_mma_kernel (tensor-core variant; `tune` overrides its
    launch parameters, for measurements). Returns (S, G), f32 (P,)."""
    _check_rows(prep, neg)
    mma = prep.variant == "mma"
    if mma:
        P = prep.dims[0]
        s, g = (sum_parts(x)[:P] for x in _call_mma(
            "pass2", prep, (neg,), ((), ()), temperature, tune))
    else:
        s, g = _row(prep), _row(prep)
        _call("pass2", prep.device,
              (prep.af, prep.ap, prep.cf, prep.cp, *prep.slots, neg, s, g),
              prep.dims, temperature)
    with _count_lock:
        pixel_contrastive_loss_tiled.launches_pass2 += 1
        pixel_contrastive_loss_tiled.launches_pass2_mma += mma
    return s, g


def launch_bwd(prep: Prepared, neg, g, coef, temperature: float, *,
               tune: Optional[MmaTune] = None):
    """Launch contrastive_bwd_kernel (FMA variant) or
    contrastive_bwd_mma_kernel (tensor-core variant; `tune` as in
    launch_pass2). Returns dA, f32 (P, D)."""
    _check_rows(prep, neg, g, coef)
    mma = prep.variant == "mma"
    if mma:
        P, _, D, _ = prep.dims
        Dp = prep.mma.af.shape[1]
        (da,) = _call_mma("bwd", prep, (neg, g, coef), ((Dp,),), temperature,
                          tune)
        da = sum_parts(da)
        if da.shape != (P, D):
            da = da[:P, :D].contiguous()
    else:
        da = torch.empty(prep.af.shape, dtype=torch.float32,
                         device=prep.device)
        _call("bwd", prep.device,
              (prep.af, prep.ap, prep.cf, prep.cp, *prep.slots, neg, g, coef,
               da), prep.dims, temperature)
    with _count_lock:
        pixel_contrastive_loss_tiled.launches_bwd += 1
        pixel_contrastive_loss_tiled.launches_bwd_mma += mma
    return da


class _TiledLoss(torch.autograd.Function):
    """forward -> pass 1 + pass 2, backward -> the backward stage, through
    the kernels or (`plain`) through the plain versions. Only `anchor_feat`
    is differentiable; the stages see it detached."""

    @staticmethod
    def forward(ctx, anchor_feat, batch, temperature, compute_dtype, plain):
        batch = batch._replace(anchor_feat=anchor_feat.detach())
        if plain:
            p1, p2, bw = pass1_plain, pass2_plain, bwd_plain

            def run(fn, *rows):
                return fn(batch, *rows, temperature, compute_dtype)
        else:
            p1, p2, bw = launch_pass1, launch_pass2, launch_bwd
            prep = prepare(batch, compute_dtype)

            def run(fn, *rows):
                return fn(prep, *rows, temperature)
        neg, num = run(p1)
        s, g = run(p2, neg)
        ctx.bwd = functools.partial(run, bw)
        ctx.save_for_backward(neg, num, g)
        return finish_loss(s, num).to(anchor_feat.dtype)

    @staticmethod
    def backward(ctx, ct):
        neg, num, g = ctx.saved_tensors
        da = ctx.bwd(neg, g, backward_coef(num, ct))
        return da.to(ct.dtype), None, None, None, None


def pixel_contrastive_loss_tiled_plain(batch: ContrastiveBatch,
                                       temperature: float = 0.07,
                                       compute_dtype=torch.float32
                                       ) -> torch.Tensor:
    """The tiled loss composed of the plain stages (pass1_plain, pass2_plain
    and, as its gradient, bwd_plain), on the batch's own device."""
    _check_dtype(compute_dtype)
    return _TiledLoss.apply(batch.anchor_feat, batch, float(temperature),
                            compute_dtype, True)


def pixel_contrastive_loss_tiled(batch: ContrastiveBatch,
                                 temperature: float = 0.07,
                                 compute_dtype=torch.float32) -> torch.Tensor:
    """Drop-in replacement for ops.contrastive.pixel_contrastive_loss
    (stabilized form) that streams the contrast set. A CUDA batch launches
    the kernels (counted in `.launches_pass1`, `.launches_pass2`,
    `.launches_bwd`; `.launches_pass1_mma`, `.launches_pass2_mma` and
    `.launches_bwd_mma` count those of them that were the tensor-core
    variant) or raises; a CPU batch takes the plain stages. Gradient
    flows to `batch.anchor_feat` only, through the closed-form backward."""
    _check_dtype(compute_dtype)
    device = batch.anchor_feat.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"pixel_contrastive_loss_tiled runs on CUDA or CPU "
                         f"tensors, got {device}")
    return _TiledLoss.apply(batch.anchor_feat, batch, float(temperature),
                            compute_dtype, device.type == "cpu")


pixel_contrastive_loss_tiled.launches_pass1 = 0
pixel_contrastive_loss_tiled.launches_pass2 = 0
pixel_contrastive_loss_tiled.launches_bwd = 0
pixel_contrastive_loss_tiled.launches_pass1_mma = 0
pixel_contrastive_loss_tiled.launches_pass2_mma = 0
pixel_contrastive_loss_tiled.launches_bwd_mma = 0
