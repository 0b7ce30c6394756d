"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM,
the model's FLOPs from its convolution shapes, and the operations and
bytes that each hand-written kernel of the train step must do and move at
least.

A roofline share is the least time the card could take, the larger of
operations over the peak rate and bytes over the memory bandwidth,
divided by the measured device time. Each input byte counts as read once
and each output byte as written once. These counts follow the kernels'
shapes, never their code, so they stay put when a kernel changes.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .reference.model import conv_specs

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
BF16_FLOP_PER_S = 989e12       # bf16 on the tensor cores
F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def _out(n: int, k: int, s: int, d: int) -> int:
    pad = d * (k - 1) // 2
    return (n + 2 * pad - d * (k - 1) - 1) // s + 1


def forward_flops(arch: dict, h: int, w: int, train: bool) -> int:
    """FLOPs (2 per multiply-add) of one image's forward at h x w: every
    convolution and classifier. In train mode the pooling branch's convs
    run on the 1 x 1 global mean, in eval mode on the map."""
    total = 0
    sh, sw = _out(h, 7, 2, 1), _out(w, 7, 2, 1)       # stem
    hh, ww = (sh - 1) // 2 + 1, (sw - 1) // 2 + 1     # 3x3/2 max-pool
    for _, cin, cout, k, s, d, where in conv_specs(arch):
        if where == "stem":
            total += 2 * cin * cout * k * k * sh * sw
            continue
        if where == "body" and s != 1:
            oh, ow = _out(hh, k, s, d), _out(ww, k, s, d)
        else:
            oh, ow = hh, ww
        if where == "pool" and train:
            oh = ow = 1
        total += 2 * cin * cout * k * k * oh * ow
        if where == "body" and k == 3:
            hh, ww = oh, ow
    return total


def train_step_flops(arch: dict, donor_arch: dict, batch: int, h: int,
                     w: int) -> int:
    """Model FLOPs of a train step: the donor's eval forward, the model's
    forward and its backward at twice the forward (no recomputation)."""
    return batch * (forward_flops(donor_arch, h, w, train=False)
                    + 3 * forward_flops(arch, h, w, train=True))


def fused_loss_work(B: int, h: int, w: int, C: int, Co: int, H: int, W: int,
                    old_cl: int, backward: bool) -> Tuple[int, int]:
    """(bytes, operations) of the fused upsample + unbiased CE / KD at the
    least, for B1 (forward) or B2 (backward). Bytes: the two logit tensors
    and the uint8 labels read once; the backward also writes the gradient
    once. Operations, per output pixel: the separable bilinear upsample of
    C + Co logits (3 a class for the height lerp, and the width lerp of the
    h source rows shared by H / h rows); per member of each stabilized
    log-sum-exp subset (all C, the old_cl old classes, {0} and the new, the
    Co donor classes) a compare, a subtract, an exp and an add; 2 per
    donor class for the KD products; 14 to combine. The backward adds 12
    a class for the gradient and its fold back to low resolution. exp and
    log count as one operation each at the f32 rate."""
    n_bytes = B * h * w * (C + Co) * 4 + B * H * W
    px = B * H * W
    interp = px * (C + Co) * 3 + B * h * W * (C + Co) * 3
    members = C + old_cl + (C - Co + 1) + Co
    n_ops = interp + px * (members * 4 + Co * 2 + 14)
    if backward:
        n_bytes += B * h * w * C * 4 + 8
        n_ops += px * C * 12
    return n_bytes, n_ops


def contrastive_work(P: int, M: int, D: int, C: int,
                     bf16: bool) -> Dict[str, Tuple[int, int]]:
    """kernel -> (bytes, operations) of B3 (pass 1), B4 (pass 2) and B5
    (the backward) at the least: the matrix products alone (pass 1 one
    P x M x D similarity product; pass 2 that and the P x M x C
    joint-probability product; the backward both and the product with the
    contrast features), 2 a multiply-add; features and probabilities read
    once at 2 bytes (bf16 mode) or 4, 6 bytes of slot record each, the
    per-anchor rows read and written once, dA written once."""
    wide = 2 if bf16 else 4
    feats, probs = (P + M) * D, (P + M) * C
    slots, row = (P + M) * 6, P * 4
    sim, jm = 2 * P * M * D, 2 * P * M * C
    return {"contrastive_pass1": (feats * wide + slots + 2 * row, sim),
            "contrastive_pass2": ((feats + probs) * wide + slots + 3 * row,
                                  sim + jm),
            "contrastive_bwd": ((feats + probs) * wide + slots + 3 * row
                                + P * D * 4, 2 * sim + jm)}


def bound_s(n_bytes: int, n_ops: int, flop_per_s: float) -> float:
    """The least seconds: bytes at the memory bandwidth or operations at
    `flop_per_s`, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / flop_per_s)
