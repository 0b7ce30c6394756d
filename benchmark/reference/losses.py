"""Plain PyTorch reference of the UCD step's loss terms: MiB's unbiased
cross entropy and unbiased knowledge distillation on the logits upsampled
to the labels' size, and the UCD pixel-contrastive term with its
joint-probability weighting.

Both losses are means over every pixel of the batch, ignored ones (label
255) adding 0 to the sum. They are computed a few images at a time under
activation checkpointing, so the full-size logits of one chunk live at a
time; the contrastive term a block of anchors at a time in the same way,
so no anchors x contrast matrix of the whole batch is ever held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import upsample

IGNORE = 255
INT32_MAX = 2 ** 31 - 1


def _unce_unkd_sums(sem, sem_old, labels, old_cl: int, alpha: float):
    """(sum of unbiased CE, sum of unbiased KD) over the pixels of a chunk;
    `sem`, `sem_old` low-res NCHW logits, `labels` (b, H, W) integers."""
    hw = labels.shape[1:]
    z = upsample(sem, hw)
    den = torch.logsumexp(z, dim=1)
    lab = labels.long()
    lab = torch.where((lab < old_cl) & (lab != IGNORE), 0, lab)
    valid = lab != IGNORE
    safe = torch.where(valid, lab, 0)
    picked = z.gather(1, safe.unsqueeze(1)).squeeze(1)
    sel = torch.where(safe == 0, torch.logsumexp(z[:, :old_cl], dim=1),
                      picked)
    ce = torch.where(valid, den - sel, 0.0).sum()

    n_old = sem_old.shape[1]
    t = torch.softmax(upsample(sem_old, hw) * alpha, dim=1)
    no_bkg = z[:, 1:n_old] - den.unsqueeze(1)
    bkg = torch.logsumexp(torch.cat([z[:, :1], z[:, n_old:]], dim=1),
                          dim=1) - den
    kd = -((t[:, 0] * bkg + (t[:, 1:] * no_bkg).sum(dim=1)) / n_old).sum()
    return ce, kd


def unce_unkd(sem, sem_old, labels, old_cl: int, alpha: float = 1.0,
              chunk: int = 4):
    """(unbiased CE, unbiased KD), each the mean over all B*H*W pixels."""
    ce = kd = 0.0
    for i in range(0, sem.shape[0], chunk):
        s = slice(i, i + chunk)
        a, b = checkpoint(_unce_unkd_sums, sem[s], sem_old[s], labels[s],
                          old_cl, alpha, use_reentrant=False)
        ce, kd = ce + a, kd + b
    n = labels.numel()
    return ce / n, kd / n


def _l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def _block_sum(a, c, ca_idx, la, lc, av, cv, an, cn, pa, pc, num,
               temperature):
    """Sum over a block of anchors of -mean over their positives of the
    JM-weighted log-probability; `ca_idx` the anchors' own contrast
    column (the self-pair)."""
    pair_valid = av[:, None] & cv[None, :]
    same = (la[:, None] == lc[None, :]) & pair_valid
    eye = ca_idx[:, None] == torch.arange(c.shape[0], device=c.device)[None]
    mask_p = same & ~eye
    mask_n = ~same & pair_valid
    jm = torch.where(an[:, None] & cn[None, :], 1.0, pa @ pc.T)
    adc = (a @ c.T) / temperature
    row_max = torch.where(pair_valid, adc, -1e30).detach().amax(
        dim=1, keepdim=True)
    row_max = torch.where(row_max <= -5e29, 0.0, row_max)
    shifted = adc - row_max
    e = shifted.exp()
    neg = torch.where(mask_n, e, 0.0).sum(dim=1, keepdim=True)
    pos = (shifted - torch.log(e + neg)) * mask_p * jm
    per = -pos.sum(dim=1) / num.clamp_min(1)
    return torch.where(num > 0, per, 0.0).sum()


def contrastive(f_n, labels, l_po, f_o, max_label: int,
                temperature: float = 0.07, block: int = 1024):
    """UCD pixel-contrastive term over every pixel slot of the batch.

    f_n, f_o: (B, N, h, w) attended head outputs of the model and the
    donor; l_po: (B, C, h, w) donor logits; labels (B, H, W). Anchors are
    the model's pixels whose label (the ground truth where it is a class
    > 0, else the donor's argmax) is > 0; the contrast set is the anchors
    (detached) and the donor's features of the same pixels that are not
    ground-truth classes. Positives share the label (the self-pair
    excluded), negatives differ; each positive's log-probability against
    the negatives is weighted by p_i . p_j of the donor's softmax, or 1
    where both pixels are ground-truth classes >= the smallest one in the
    batch. The gradient reaches `f_n` only."""
    B, N, h, w = f_n.shape
    P = B * h * w
    dtype = f_n.dtype
    small = F.interpolate(labels.to(torch.float32)[:, None], size=(h, w),
                          mode="bilinear", align_corners=False)[:, 0]
    lab = small.to(torch.int32).reshape(P)
    lab = torch.where((lab < 0) | (lab > max_label), 0, lab)
    gt_new = lab > 0
    min_new = torch.where(gt_new, lab, INT32_MAX).min()
    l_po = l_po.detach().permute(0, 2, 3, 1).reshape(P, -1)
    pseudo = l_po.argmax(dim=1).to(torch.int32)
    la = torch.where(gt_new, lab, pseudo)
    av = la > 0
    a = _l2n(f_n.permute(0, 2, 3, 1).reshape(P, N).to(dtype))
    c = torch.cat([a.detach(), _l2n(f_o.detach().permute(0, 2, 3, 1)
                                    .reshape(P, N).to(dtype))])
    lc = torch.cat([la, la])
    cv = torch.cat([av, av & ~gt_new])
    an = la >= min_new
    cn = torch.cat([an, an])
    pa = torch.softmax(l_po.to(dtype), dim=1)
    pc = torch.cat([pa, pa])
    # positives per anchor: the valid contrast slots of its label, less
    # its own column
    n_label = max(int(lc.max()) + 1, 1)
    count = torch.bincount(lc[cv].long(), minlength=n_label)
    num = torch.where(av, count[la.long()] - 1, 0)
    total = a.new_zeros(())
    for i in range(0, P, block):
        s = slice(i, i + block)
        idx = torch.arange(i, min(i + block, P), device=a.device)
        total = total + checkpoint(
            _block_sum, a[s], c, idx, la[s], lc, av[s], cv, an[s], cn,
            pa[s], pc, num[s], temperature, use_reentrant=False)
    return total / (num > 0).sum().clamp_min(1)
