"""UCD pixel-contrastive distillation: batch construction + supervised
contrastive loss with the joint-probability uncertainty weighting.

Counterpart of ucd_tpu/ops/contrastive.py, same names, plain functions on
tensors, NHWC at the public functions. Every pixel of the low-res map is a
potential anchor slot; invalid slots carry a false validity bit and drop out
of every reduction. The contrast set is laid out as

    slot j in [0, P)   -> new-model (anchor) features of pixel j
    slot P + j         -> old-model features of pixel j (valid iff the pixel
                          is pseudo-labeled and not a GT new-class pixel)

so anchor i's self-pair is exactly contrast column i.

`ucd_contrastive_loss(use_pallas=True)` takes the streaming kernels of
ops/tiled_contrastive.py (the argument keeps the JAX package's name: in the
port it means "the hand-written tiled kernels", which never form an
anchors x contrast matrix in device memory); `use_pallas=False` takes the
dense `pixel_contrastive_loss` below, O(P * 2P) memory.

Differences from the JAX functions, all by design:
  * float64 features stay float64 (a test-only dtype); the JAX functions
    cast to float32. Labels are always interpolated in float32;
  * there is no `precision` argument: matrix products run in true float32
    (the entry points switch TF32 off);
  * the pseudo-label argmax takes the first maximum explicitly, on every
    device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.layers import wide_dtype
from ..parallel.collectives import gather_rows, is_distributed

INT32_MAX = 2 ** 31 - 1


class ContrastiveBatch(NamedTuple):
    """Static-shape contrastive batch. P = B*h*w pixel slots."""
    anchor_feat: torch.Tensor      # (P, N) L2-normalized new-model features
    contrast_feat: torch.Tensor    # (2P, N) detached; [:P]=anchor, [P:]=old
    anchor_label: torch.Tensor     # (P,) int32; mixed GT/pseudo label
    contrast_label: torch.Tensor   # (2P,) int32
    anchor_valid: torch.Tensor     # (P,) bool
    contrast_valid: torch.Tensor   # (2P,) bool
    anchor_prob: torch.Tensor      # (P, C) softmax(old logits) for JM_p
    contrast_prob: torch.Tensor    # (2P, C)
    anchor_is_new: torch.Tensor    # (P,) bool: GT new-class pixel
    contrast_is_new: torch.Tensor  # (2P,) bool


def _axis_weights(in_size: int, out_size: int, device):
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * (in_size / out_size) - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = src.floor().to(torch.int64)
    hi = (lo + 1).clamp_max(in_size - 1)
    w_hi = src - lo.to(torch.float32)
    return lo, hi, w_hi


def interpolate_bilinear(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Point-sampled separable bilinear interpolation with half-pixel
    centers (no anti-aliasing on downsample), rows first, then columns,
    each as lo * (1 - w) + hi * w: the operation order of the JAX function,
    so that `downsample_labels`'s truncation sees the same float32 bits.
    x: (B, H, W) float."""
    h_lo, h_hi, h_w = _axis_weights(x.shape[1], out_h, x.device)
    w_lo, w_hi, w_w = _axis_weights(x.shape[2], out_w, x.device)
    h_w, w_w = h_w.to(x.dtype), w_w.to(x.dtype)
    rows = x[:, h_lo, :] * (1 - h_w)[None, :, None] \
        + x[:, h_hi, :] * h_w[None, :, None]
    return rows[:, :, w_lo] * (1 - w_w)[None, None, :] \
        + rows[:, :, w_hi] * w_w[None, None, :]


def downsample_labels(labels: torch.Tensor, size: Tuple[int, int],
                      max_label: int) -> torch.Tensor:
    """Bilinear-interpolate integer labels (255 included, as a value) to
    feature resolution in float32, truncate toward zero, zero what falls
    outside [0, max_label]. Returns int32."""
    out = interpolate_bilinear(labels.to(torch.float32), size[0], size[1])
    lab = out.to(torch.int32)
    return torch.where((lab < 0) | (lab > max_label),
                       torch.zeros_like(lab), lab)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(eps)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis that takes the first maximum, as
    `jnp.argmax` does, on every device. int32."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    first = torch.where(x == x.amax(dim=-1, keepdim=True), idx, n).amin(-1)
    return first.to(torch.int32)


def build_contrastive_batch(f_n, labels, l_po, f_o,
                            max_label: int) -> ContrastiveBatch:
    """Args:
      f_n: (B,h,w,N) new-model pre_logits features (attended).
      labels: (B,H,W) integer ground truth at input resolution.
      l_po: (B,h,w,C) old-model `sem` logits.
      f_o: (B,h,w,N) old-model pre_logits features.
      max_label: dataset max valid class id (VOC: 20).
    Gradient flows through `anchor_feat` only."""
    B, h, w, N = f_n.shape
    P = B * h * w
    dtype = wide_dtype(f_n.dtype)

    label_n_flat = downsample_labels(labels, (h, w), max_label).reshape(P)
    mask_new = label_n_flat > 0                                # GT new pixels

    # min over GT new-class ids; int32 max for a batch without new pixels
    big = torch.full_like(label_n_flat, INT32_MAX)
    min_new = torch.where(mask_new, label_n_flat, big).min()

    # mixed label: GT where new, old-model argmax pseudo-label elsewhere
    l_po = l_po.detach()
    label_po = first_argmax(l_po).reshape(P)
    label_mix = torch.where(mask_new, label_n_flat, label_po)
    valid = label_mix > 0

    anchor_feat = l2_normalize(f_n.reshape(P, N).to(dtype))
    old_valid = valid & (~mask_new)
    contrast_feat = torch.cat(
        [anchor_feat.detach(),
         l2_normalize(f_o.detach().reshape(P, N).to(dtype))], dim=0)

    prob = torch.softmax(l_po.to(dtype), dim=-1).reshape(P, -1)

    # "GT new" is marked purely by label value >= min_new; pseudo labels are
    # always < min_new under dataset masking, so this equals the GT-new mask
    anchor_is_new = label_mix >= min_new
    return ContrastiveBatch(
        anchor_feat=anchor_feat,
        contrast_feat=contrast_feat,
        anchor_label=label_mix,
        contrast_label=torch.cat([label_mix, label_mix]),
        anchor_valid=valid,
        contrast_valid=torch.cat([valid, old_valid]),
        anchor_prob=prob,
        contrast_prob=torch.cat([prob, prob], dim=0),
        anchor_is_new=anchor_is_new,
        contrast_is_new=torch.cat([anchor_is_new, anchor_is_new]),
    )


def compact_batch(batch: ContrastiveBatch, capacity: int) -> ContrastiveBatch:
    """Optionally compact the pixel slots to a fixed `capacity`: the first
    `capacity` valid anchors in order, padded with masked-out rows whose
    features and labels are 0. Reduces the quadratic cost when few pixels
    are labeled; capacity=0 keeps all slots. A stable sort stands for
    `jnp.nonzero(size=capacity)`: static shapes, no host synchronization."""
    P = batch.anchor_feat.shape[0]
    if capacity <= 0 or capacity >= P:
        return batch
    idx = torch.argsort((~batch.anchor_valid).to(torch.uint8),
                        stable=True)[:capacity]
    in_range = batch.anchor_valid[idx]      # false on the padding rows

    def take(x, index, keep):
        keep = keep.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(keep, x[index], torch.zeros_like(x[:1]))

    c_idx = torch.cat([idx, idx + P])
    c_in = torch.cat([in_range, in_range])
    return ContrastiveBatch(
        anchor_feat=take(batch.anchor_feat, idx, in_range),
        contrast_feat=take(batch.contrast_feat, c_idx, c_in),
        anchor_label=take(batch.anchor_label, idx, in_range),
        contrast_label=take(batch.contrast_label, c_idx, c_in),
        anchor_valid=take(batch.anchor_valid, idx, in_range),
        contrast_valid=take(batch.contrast_valid, c_idx, c_in),
        anchor_prob=take(batch.anchor_prob, idx, in_range),
        contrast_prob=take(batch.contrast_prob, c_idx, c_in),
        anchor_is_new=take(batch.anchor_is_new, idx, in_range),
        contrast_is_new=take(batch.contrast_is_new, c_idx, c_in),
    )


def pair_masks(batch: ContrastiveBatch):
    """(mask_p, mask_n, m_gt) over anchors x contrast slots: positives (same
    label, both valid, not the self-pair), negatives (different label, both
    valid) and the pairs whose JM weight is forced to 1 (both GT-new)."""
    P, M = batch.anchor_feat.shape[0], batch.contrast_feat.shape[0]
    device = batch.anchor_feat.device
    pair_valid = batch.anchor_valid[:, None] & batch.contrast_valid[None, :]
    R = (batch.anchor_label[:, None] == batch.contrast_label[None, :]) \
        & pair_valid
    eye = torch.arange(P, device=device)[:, None] \
        == torch.arange(M, device=device)[None, :]       # self-pair: col i
    m_gt = batch.anchor_is_new[:, None] & batch.contrast_is_new[None, :]
    return R & (~eye), (~R) & pair_valid, m_gt


def pixel_contrastive_loss(batch: ContrastiveBatch, temperature: float = 0.07,
                           bug_compatible: bool = False) -> torch.Tensor:
    """Supervised pixel-contrastive loss with the uncertainty weighting
    JM_p[i,j] = p_i . p_j of the old-model softmax probabilities, forced to
    1 where both pixels carry GT new-class labels. Dense version: the
    reference for the tiled kernels and the correctness oracle, O(P * 2P)
    memory. `bug_compatible` keeps the negative row-sum in raw exp space
    while the positive term is shifted by the row max."""
    A, C = batch.anchor_feat, batch.contrast_feat
    pair_valid = batch.anchor_valid[:, None] & batch.contrast_valid[None, :]
    mask_p, mask_n, m_gt = pair_masks(batch)

    JM = batch.anchor_prob @ batch.contrast_prob.T
    JM = torch.where(m_gt, torch.ones_like(JM), JM)

    adc = (A @ C.T) / temperature
    neg_big = -1e30
    adc_masked = torch.where(pair_valid, adc, torch.full_like(adc, neg_big))
    # a row with NO valid pair has row_max = -1e30: shifted = adc + 1e30,
    # exp = inf, and the inf reaches the gradient as inf/inf through the
    # log although mask_p zeroes the forward. Clamp those rows' max to 0.
    row_max = adc_masked.detach().amax(dim=1, keepdim=True)
    row_max = torch.where(row_max <= neg_big * 0.5,
                          torch.zeros_like(row_max), row_max)

    zero = torch.zeros_like(adc)
    shifted = adc - row_max
    if bug_compatible:
        neg = torch.where(mask_n, adc.exp(), zero).sum(dim=1, keepdim=True)
    else:
        neg = torch.where(mask_n, shifted.exp(), zero).sum(dim=1,
                                                           keepdim=True)
    pos = shifted - torch.log(shifted.exp() + neg)
    pos = pos * mask_p.to(pos.dtype) * JM

    num = mask_p.sum(dim=1)                        # positives per anchor
    has_pos = num > 0
    per_anchor = -pos.sum(dim=1) / num.clamp_min(1)
    n_active = has_pos.sum().clamp_min(1)
    return torch.where(has_pos, per_anchor,
                       torch.zeros_like(per_anchor)).sum() / n_active


def ucd_contrastive_loss(f_n, labels, l_po, f_o, max_label: int,
                         temperature: float = 0.07, capacity: int = 0,
                         use_pallas: bool = False,
                         bug_compatible: bool = False,
                         kernel_dtype: Optional[torch.dtype] = None,
                         group=None) -> torch.Tensor:
    """End-to-end UCD contrastive term: build batch -> (compact) -> loss,
    over the global batch inside a process group (every process computes
    the same term; the gradient of `f_n` is this process's rows).
    `use_pallas` selects the streaming tiled kernels
    (ops/tiled_contrastive.py; `kernel_dtype` float32 or bfloat16 is their
    compute mode), else the dense loss. `bug_compatible` reproduces the
    unstabilized negative sum (dense path only: the tiled kernels compute
    the stabilized form, so the combination is rejected rather than silently
    rerouted). `group` is the process group the batch is split over (None:
    the world; the data group on a 2-D mesh)."""
    if use_pallas and bug_compatible:
        raise ValueError(
            "use_pallas=True is incompatible with contrastive_bug_compatible:"
            " the streaming kernels cannot reproduce the reference's"
            " UNstabilized negative sum. Pass"
            " use_pallas_contrastive=False for bug-compatible runs.")
    if is_distributed():
        # the JAX term is one program over the global batch (a pallas_call
        # has no partitioning rule): min_new, the self-pair column and the
        # compaction order are the global batch's. Every process gathers
        # the four inputs in rank order and computes the same term.
        f_n = gather_rows(f_n, group)
        labels, l_po, f_o = (gather_rows(t.detach(), group)
                             for t in (labels, l_po, f_o))
    batch = build_contrastive_batch(f_n, labels, l_po, f_o, max_label)
    batch = compact_batch(batch, capacity)
    if use_pallas:
        from .tiled_contrastive import pixel_contrastive_loss_tiled
        return pixel_contrastive_loss_tiled(
            batch, temperature,
            compute_dtype=kernel_dtype or torch.float32)
    return pixel_contrastive_loss(batch, temperature,
                                  bug_compatible=bug_compatible)
