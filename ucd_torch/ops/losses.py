"""Segmentation and distillation losses in plain PyTorch.

Counterpart of ucd_tpu/ops/losses.py, every function of it. All functions
take NHWC logits `(B, H, W, C)` (class last, the JAX package's layout; a
permuted NCHW view is fine) and integer labels
`(B, H, W)` with ignore value 255. Logits are cast to f32 first (f64 inputs
stay f64, the test-only dtype).

Reduction: `reduction='mean'` divides by the count of ALL pixels; ignored
pixels add 0 to the numerator but still count in the denominator.

These are the dense path of the train and validate steps (the only path
of the iCaRL and BCE criteria) and the oracles of the fused upsample+loss
kernels (ops/fused_loss.py). `mask_cross_entropy` and
`mask_knowledge_distillation` are wired into no method, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.layers import wide_dtype

IGNORE = 255


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(wide_dtype(x.dtype))


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _gather_class(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] over the trailing class dim."""
    return x.gather(-1, idx.long().unsqueeze(-1)).squeeze(-1)


def cross_entropy(logits, labels, ignore_index: int = IGNORE,
                  reduction: str = "mean") -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=255, reduction='none') -> .mean():
    nll = logsumexp(logits) - logits[label], 0 at ignored pixels."""
    logits = _wide(logits)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    den = torch.logsumexp(logits, dim=-1)
    nll = den - _gather_class(logits, safe)
    return _reduce(torch.where(valid, nll, 0.0), reduction)


def focal_loss(logits, labels, alpha: float = 1.0, gamma: float = 2.0,
               ignore_index: int = IGNORE,
               size_average: bool = True) -> torch.Tensor:
    """(1 - pt)^gamma-weighted CE, pt = exp(-ce)."""
    ce = cross_entropy(logits, labels, ignore_index, reduction="none")
    fl = alpha * (1 - torch.exp(-ce)) ** gamma * ce
    return fl.mean() if size_average else fl.sum()


def _one_hot_ignore(labels, n_classes: int, ignore_index: int = IGNORE,
                    dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, C) one-hot of `labels`; an ignored pixel's row is all
    zero (ignore folded into an extra class, then sliced off)."""
    labels = torch.where(labels != ignore_index, labels.long(), n_classes)
    return torch.nn.functional.one_hot(labels, n_classes + 1)[
        ..., :n_classes].to(dtype)


def _bce_with_logits(logits, targets) -> torch.Tensor:
    """Elementwise binary cross entropy with logits, in the stable form
    max(x, 0) - x t + log1p(exp(-|x|))."""
    logits = _wide(logits)
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def bce_with_logits_ignore(logits, labels, ignore_index: int = IGNORE,
                           reduction: str = "mean") -> torch.Tensor:
    """BCE-with-logits summed over classes per pixel, 0 at ignored pixels.
    'mean': over the non-ignored pixels; 'mean_all': over ALL pixels (the
    train step's criterion); 'sum'; otherwise the per-pixel map."""
    logits = _wide(logits)
    targets = _one_hot_ignore(labels, logits.shape[-1], ignore_index,
                              logits.dtype)
    loss = _bce_with_logits(logits, targets).sum(dim=-1)
    valid = targets.sum(dim=-1) != 0
    masked = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return masked.sum() / valid.sum().clamp_min(1)
    if reduction == "mean_all":
        return masked.mean()
    if reduction == "sum":
        return masked.sum()
    return loss * targets.sum(dim=-1)


def icarl_loss(logits, labels, outputs_old_sig, bkg: bool = False,
               ignore_index: int = IGNORE,
               reduction: str = "mean") -> torch.Tensor:
    """iCaRL's criterion: BCE where the old classes' columns of the one-hot
    target are sigmoid(old logits) (`outputs_old_sig`, already sigmoided
    by the caller); with `bkg`, the background column keeps the GT."""
    logits = _wide(logits)
    n_cl, n_old = logits.shape[-1], outputs_old_sig.shape[-1]
    targets = _one_hot_ignore(labels, n_cl, ignore_index, logits.dtype)
    old = outputs_old_sig.to(logits.dtype)
    if bkg:
        targets = torch.cat([targets[..., :1], old[..., 1:],
                             targets[..., n_old:]], dim=-1)
    else:
        targets = torch.cat([old, targets[..., n_old:]], dim=-1)
    return _reduce(_bce_with_logits(logits, targets).sum(dim=-1), reduction)


def icarl_combined_loss(logits, outputs_old,
                        importance: float) -> torch.Tensor:
    """iCaRL combined mode: the mean BCE between the new model's old-class
    logits and sigmoid(old logits), times importance * n_old (a sum over
    the old classes rather than a mean)."""
    n_old = outputs_old.shape[-1]
    bce = _bce_with_logits(logits[..., :n_old],
                           torch.sigmoid(_wide(outputs_old))).mean()
    return importance * n_old * bce


def unbiased_cross_entropy(logits, labels, old_cl: int,
                           ignore_index: int = IGNORE,
                           reduction: str = "mean") -> torch.Tensor:
    """MiB UnbiasedCrossEntropy: p(bkg) := logsumexp over {bkg + old
    classes} - logsumexp(all); new classes get the standard log-softmax;
    labels < old_cl are mapped to 0."""
    logits = _wide(logits)
    den = torch.logsumexp(logits, dim=-1)
    lse_old = torch.logsumexp(logits[..., :old_cl], dim=-1)
    labels = torch.where((labels < old_cl) & (labels != ignore_index), 0,
                         labels)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    sel = torch.where(safe == 0, lse_old, _gather_class(logits, safe))
    return _reduce(torch.where(valid, den - sel, 0.0), reduction)


def knowledge_distillation(inputs, targets, alpha: float = 1.0,
                           mask: Optional[torch.Tensor] = None,
                           reduction: str = "mean") -> torch.Tensor:
    """Soft cross-entropy between log_softmax(new logits narrowed to the
    old classes) and softmax(alpha * old logits), averaged over classes."""
    n_old = targets.shape[-1]
    outputs = torch.log_softmax(_wide(inputs[..., :n_old]), dim=-1)
    labels = torch.softmax(_wide(targets) * alpha, dim=-1)
    loss = (outputs * labels).mean(dim=-1)
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return -_reduce(loss, reduction)


def unbiased_knowledge_distillation(inputs, targets, alpha: float = 1.0,
                                    mask: Optional[torch.Tensor] = None,
                                    reduction: str = "mean") -> torch.Tensor:
    """MiB UnbiasedKnowledgeDistillationLoss: the old model's bkg
    probability is matched against logsumexp over {bkg + new classes} of the
    new model; old-class probabilities are matched directly."""
    inputs = _wide(inputs)
    targets = _wide(targets) * alpha
    n_old_tot = targets.shape[-1]

    den = torch.logsumexp(inputs, dim=-1)
    outputs_no_bkg = inputs[..., 1:n_old_tot] - den.unsqueeze(-1)
    bkg_new = torch.cat([inputs[..., :1], inputs[..., n_old_tot:]], dim=-1)
    outputs_bkg = torch.logsumexp(bkg_new, dim=-1) - den

    labels = torch.softmax(targets, dim=-1)
    loss = (labels[..., 0] * outputs_bkg
            + (labels[..., 1:] * outputs_no_bkg).sum(dim=-1)) / n_old_tot
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return -_reduce(loss, reduction)


def feature_distillation(feat_new, feat_old) -> torch.Tensor:
    """ILT 'lde' term: MSE between new and old features."""
    return ((_wide(feat_new) - _wide(feat_old)) ** 2).mean()


def mask_cross_entropy(logits, labels, old_cl: int,
                       outputs_old: Optional[torch.Tensor] = None,
                       ignore_index: int = IGNORE,
                       reduction: str = "mean") -> torch.Tensor:
    """Pseudo-label-masked unbiased CE: label 0 selects p(bkg) over {bkg +
    old classes}, labels 1..old_cl-1 give 0, new labels their log-softmax;
    with `outputs_old`, only pixels where the old model predicts background
    or the GT is a new class count. Returns the positive loss (the JAX
    package's choice over the reference's negated one)."""
    logits = _wide(logits)
    den = torch.logsumexp(logits, dim=-1)
    lse_old = torch.logsumexp(logits[..., :old_cl], dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    in_zero = (safe > 0) & (safe < old_cl)
    sel = torch.where(safe == 0, lse_old, _gather_class(logits, safe))
    nll = torch.where(in_zero, 0.0, den - sel)
    nll = torch.where(valid, nll, 0.0)
    if outputs_old is not None:
        pseudo = outputs_old.argmax(dim=-1)
        mask = (pseudo == 0) | (labels > old_cl)
        nll = nll * mask.to(nll.dtype)
    return _reduce(nll, reduction)


def mask_knowledge_distillation(inputs, targets, alpha: float = 1.0,
                                mask: Optional[torch.Tensor] = None,
                                reduction: str = "mean") -> torch.Tensor:
    """Unbiased KD restricted to the pixels where `mask` is 0."""
    inv_mask = None if mask is None else (mask == 0)
    return unbiased_knowledge_distillation(inputs, targets, alpha=alpha,
                                           mask=inv_mask, reduction=reduction)
