"""Plain PyTorch reference of one UCD train step at an incremental step:
the frozen donor's eval-mode forward, the model's train-mode forward, the
unbiased CE, 10 x the unbiased KD and 0.01 x the pixel-contrastive term,
the backward, nesterov SGD with coupled weight decay over every trainable
parameter, and the running statistics moved by the batch's.

`Reference` holds the model's state (a flat dict of leaf tensors), the
momentum and the count; `step(images, labels)` takes one step and returns
its loss terms and keeps each parameter's gradient norm in `grad_norms`.
Nothing here imports the measured program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import losses as RL
from . import model as RM


class Reference:
    """`arch`: the model's architecture with the classes of every step;
    `donor_arch` that of the donor. `hyper`: lr, momentum, weight_decay,
    total_iters, lr_power, loss_kd, contrastive_weight, temperature, alpha,
    old_classes, max_label, step. `q` rounds where the control computes at
    a lower precision (model.py)."""

    def __init__(self, sd: Dict[str, torch.Tensor],
                 donor: Dict[str, torch.Tensor], arch: dict,
                 donor_arch: dict, hyper: dict, q: Optional[RM.Round] = None):
        self.sd = {k: v.detach().clone().requires_grad_(
            RM.trainable(k, hyper["step"]) and v.is_floating_point())
            for k, v in sd.items()}
        self.donor = donor
        self.arch, self.donor_arch, self.h, self.q = arch, donor_arch, hyper, q
        self.trace = {k: torch.zeros_like(v) for k, v in self.sd.items()
                      if v.requires_grad}
        self.count = 0

    def lr(self) -> float:
        h = self.h
        frac = max(1.0 - self.count / max(h["total_iters"], 1), 0.0)
        return h["lr"] * frac ** h["lr_power"]

    def step(self, images: torch.Tensor, labels: torch.Tensor) -> dict:
        """images (B, H, W, 3) uint8, labels (B, H, W) on the state's
        device. Updates the state in place; returns the step's terms as
        floats."""
        h, q = self.h, self.q
        x = images.permute(0, 3, 1, 2)
        with torch.no_grad():
            sem_old, f_old, _ = RM.forward(self.donor, x, self.donor_arch,
                                           train=False, attention=True, q=q)
        sem, feats, stats = RM.forward(self.sd, x, self.arch, train=True,
                                       attention=True, q=q)
        ce, kd = RL.unce_unkd(sem, sem_old, labels, h["old_classes"],
                              h["alpha"])
        con = RL.contrastive(feats["pre_logits"], labels, sem_old,
                             f_old["pre_logits"], h["max_label"],
                             h["temperature"])
        loss = ce + h["loss_kd"] * kd + h["contrastive_weight"] * con
        names = list(self.trace)
        grads = torch.autograd.grad(loss, [self.sd[k] for k in names],
                                    allow_unused=True)
        lr = self.lr()
        self.grad_norms = {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = self.sd[k]
                g = torch.zeros_like(p) if g is None else g
                self.grad_norms[k] = float(torch.linalg.vector_norm(g))
                g = g + h["weight_decay"] * p
                t = self.trace[k].mul_(h["momentum"]).add_(g)
                p.sub_(lr * (g + h["momentum"] * t))
            for prefix, (mean, var) in stats.items():
                self.sd[f"{prefix}.running_mean"].lerp_(mean, RM.MOMENTUM)
                self.sd[f"{prefix}.running_var"].lerp_(var, RM.MOMENTUM)
                self.sd[f"{prefix}.num_batches_tracked"].add_(1)
        self.count += 1
        return {"loss": float(ce.detach()),
                "lkd": float(h["loss_kd"] * kd.detach()),
                "l_con": float(h["contrastive_weight"] * con.detach()),
                "loss_tot": float(loss.detach())}
