"""Segmentation and distillation losses in plain PyTorch.

Counterpart of ucd_tpu/ops/losses.py for the terms the ported train step
uses. All functions take NHWC logits `(B, H, W, C)` (class last, the JAX
package's layout; a permuted NCHW view is fine) and integer labels
`(B, H, W)` with ignore value 255. Logits are cast to f32 first (f64 inputs
stay f64, the test-only dtype).

Reduction: `reduction='mean'` divides by the count of ALL pixels; ignored
pixels add 0 to the numerator but still count in the denominator.

These are the dense path of the train and validate steps and the oracles of
the fused upsample+loss kernels (ops/fused_loss.py).
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
