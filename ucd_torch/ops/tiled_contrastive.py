"""Streaming (tiled) UCD pixel-contrastive loss: the wrapper of the three
CUDA kernels of `csrc/tiled_contrastive.cu`, their plain PyTorch versions
and their launch counts.

Counterpart of ucd_tpu/ops/pallas_contrastive.py:

  pixel_contrastive_loss_tiled   <- pixel_contrastive_loss_pallas (with its
                                    custom_vjp: _pallas_fwd / _pallas_bwd)
  launch_pass1 / pass1_plain     <- _pass1_kernel: neg_i, num_i per anchor
  launch_pass2 / pass2_plain     <- _pass2_kernel: S_i, G_i per anchor
  launch_bwd / bwd_plain         <- _bwd_kernel: dA, the gradient to the
                                    anchor features (closed form)
  prepare                        <- _prep (checks and casts; no padding)
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
bf16 mode does. The plain versions round at the same points. The kernels
read float32 in both modes: the wrapper widens the rounded values again,
which changes no product (bf16 x bf16 is exact in f32).

On a CUDA batch the loss launches the kernels (or raises); on a CPU batch
it runs the plain versions (float64 stays float64 there, a test-only
dtype). The plain versions hold P x M matrices: they are for tests and for
the on-card comparison, not for the train path.

Kernel notes (details in the source): bound by operations (three to five
P x M x D products per step against 25 MB of inputs); one block per 64
anchors walks all contrast tiles, so every per-anchor sum and the dA tile
stay in registers, nothing is reduced across blocks and two runs give the
same bits.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import torch

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

class Prepared(NamedTuple):
    """A batch as the kernels take it: contiguous float32 features /
    probabilities (rounded to bf16 and widened again in bf16 mode), int32
    labels, one byte per validity / is-new bit."""
    af: torch.Tensor
    ap: torch.Tensor
    cf: torch.Tensor
    cp: torch.Tensor
    slots: tuple            # la, av, an, lc, cv, cn
    round_dadc: int         # 1 in bf16 mode

    @property
    def dims(self):
        (P, D), M, C = self.af.shape, self.cf.shape[0], self.ap.shape[1]
        return P, M, D, C


def prepare(batch: ContrastiveBatch, compute_dtype=torch.float32) -> Prepared:
    """Check a CUDA batch and lay it out for the kernels (no padding: the
    kernels mask the ragged edges themselves)."""
    _check_dtype(compute_dtype)
    A, C = batch.anchor_feat, batch.contrast_feat
    if A.device.type != "cuda":
        raise ValueError(f"the tiled contrastive kernels run on CUDA "
                         f"tensors, got {A.device}")
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
    if min(P, M, A.shape[1], batch.anchor_prob.shape[1]) < 1:
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

    def cast(x):
        return _rounded(x.detach(), compute_dtype).contiguous()

    return Prepared(cast(A), cast(batch.anchor_prob), cast(C),
                    cast(batch.contrast_prob), tuple(slots),
                    int(compute_dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """(pass1, pass2, bwd) entry points with their C signatures:
    pass1(af, cf, 6 slot arrays, neg, num, P, M, D, tau, stream)
    pass2(af, ap, cf, cp, 6 slot arrays, neg, s, g, P, M, D, C, tau, stream)
    bwd(af, ap, cf, cp, 6 slot arrays, neg, g, coef, da, P, M, D, C, tau,
        round_dadc, stream)."""
    lib = build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = (lib.ucd_contrastive_pass1, lib.ucd_contrastive_pass2,
           lib.ucd_contrastive_bwd)
    for fn, n_ptr, n_int, flags in zip(fns, (10, 13, 14), (3, 4, 4),
                                       ([], [], [i])):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [f] + flags + [p]
    return fns


def _call(fn, prep: Prepared, ptrs, ints, temperature: float, *flags):
    device = prep.af.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in ptrs), *ints, float(temperature),
                 *flags, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")


def _row(prep: Prepared) -> torch.Tensor:
    return torch.empty(prep.af.shape[0], dtype=torch.float32,
                       device=prep.af.device)


def _check_rows(prep: Prepared, *rows: torch.Tensor):
    """Per-anchor kernel inputs: contiguous f32 (P,) on the batch's
    device."""
    for x in rows:
        if x.shape != (prep.af.shape[0],) or x.dtype != torch.float32 \
                or x.device != prep.af.device or not x.is_contiguous():
            raise ValueError(
                f"expected a contiguous float32 ({prep.af.shape[0]},) "
                f"tensor on {prep.af.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def launch_pass1(prep: Prepared, temperature: float):
    """Launch contrastive_pass1_kernel. Returns (neg, num), f32 (P,)."""
    P, M, D, _ = prep.dims
    neg, num = _row(prep), _row(prep)
    _call(_kernel_fns()[0], prep, (prep.af, prep.cf, *prep.slots, neg, num),
          (P, M, D), temperature)
    with _count_lock:
        pixel_contrastive_loss_tiled.launches_pass1 += 1
    return neg, num


def launch_pass2(prep: Prepared, neg: torch.Tensor, temperature: float):
    """Launch contrastive_pass2_kernel. Returns (S, G), f32 (P,)."""
    _check_rows(prep, neg)
    s, g = _row(prep), _row(prep)
    _call(_kernel_fns()[1], prep,
          (prep.af, prep.ap, prep.cf, prep.cp, *prep.slots, neg, s, g),
          prep.dims, temperature)
    with _count_lock:
        pixel_contrastive_loss_tiled.launches_pass2 += 1
    return s, g


def launch_bwd(prep: Prepared, neg, g, coef, temperature: float):
    """Launch contrastive_bwd_kernel. Returns dA, f32 (P, D)."""
    _check_rows(prep, neg, g, coef)
    da = torch.empty(prep.af.shape, dtype=torch.float32,
                     device=prep.af.device)
    _call(_kernel_fns()[2], prep,
          (prep.af, prep.ap, prep.cf, prep.cp, *prep.slots, neg, g, coef, da),
          prep.dims, temperature, prep.round_dadc)
    with _count_lock:
        pixel_contrastive_loss_tiled.launches_bwd += 1
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
    `.launches_bwd`) or raises; a CPU batch takes the plain stages. Gradient
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
