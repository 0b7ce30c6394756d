"""The v1 contrastive losses: supervised contrastive (SupCon, with the
SimCLR mode) and the per-pixel v1 loss.

Counterpart of ucd_tpu/ops/contrastive_v1.py: earlier iterations of the
UCD contrastive term that no training path of either package calls (the
main path is ops/contrastive.py + ops/tiled_contrastive.py). Plain torch
ops, computed in f32 as the JAX functions compute them (f64 inputs are
cast too), with the v1 quirks kept:

  * `sup_con_loss`: row-max-stabilized softmax over the non-self contrast
    columns, the +1e-6 / +1e-8 epsilons, the loss scaled by
    temperature / base_temperature;
  * `pixel_con_loss_v1`: no uncertainty weighting; the negative sum added
    inside the log is the contrast column's, neg[j] at [i, j], not the
    anchor row's; anchors without a positive are left out of the mean.
"""

from __future__ import annotations

from typing import Optional

import torch


def sup_con_loss(features: torch.Tensor,
                 labels: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 temperature: float = 0.07, base_temperature: float = 0.07,
                 contrast_mode: str = "all") -> torch.Tensor:
    """features: (B, V, D...) L2-normalized views. labels: (B,) ints, or a
    (B, B) `mask`, or neither (SimCLR: each sample is its own class)."""
    assert features.ndim >= 3, "features must be (B, V, ...)"
    b, v = features.shape[0], features.shape[1]
    feats = features.reshape(b, v, -1).float()
    dev = feats.device
    if mask is None:
        if labels is None:
            mask = torch.eye(b, device=dev)
        else:
            lab = labels.reshape(-1, 1)
            mask = (lab == lab.T).float()
    else:
        mask = mask.float()

    # view-major stacking (V*B, D)
    contrast = torch.cat(torch.unbind(feats, dim=1), dim=0)
    if contrast_mode == "one":
        anchor, anchor_count = feats[:, 0], 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, v
    else:
        raise ValueError(f"unknown mode {contrast_mode!r}")

    adc = (anchor @ contrast.T) / temperature
    logits = adc - adc.max(dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, v)
    n_a = b * anchor_count
    # self-contrast exclusion: zero at column i of row i
    logits_mask = 1.0 - torch.eye(n_a, b * v, device=dev)
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True) + 1e-6)
    mean_log_prob_pos = (mask * log_prob).sum(1) / (mask.sum(1) + 1e-8)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, b).mean()


def pixel_con_loss_v1(features: torch.Tensor, labels: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """features: (B, 1, D...) pixel embeddings; labels: (B,) ints."""
    assert features.ndim >= 3
    b = features.shape[0]
    contrast = features.reshape(b, features.shape[1], -1).float()[:, 0]
    lab = labels.reshape(-1, 1)
    r = (lab == lab.T).float()
    eye = torch.eye(b, device=contrast.device)
    mask_p = r - eye
    mask_n = 1.0 - r

    adc = (contrast @ contrast.T) / temperature
    e = torch.exp(adc)
    neg = (e * mask_n).sum(1)                                  # (B,)
    # v1 quirk kept: the added negative sum is neg[j] (the column's)
    pos = adc * mask_p - torch.log(e + neg[None, :]) * mask_p
    num = mask_p.sum(1)
    has_pos = num > 0
    per_anchor = -pos.sum(1) / num.clamp_min(1.0)
    n_active = has_pos.sum().clamp_min(1)
    return torch.where(has_pos, per_anchor, 0.0).sum() / n_active
