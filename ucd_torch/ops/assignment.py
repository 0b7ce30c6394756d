"""Sinkhorn-Knopp optimal-transport assignment.

Counterpart of ucd_tpu/ops/assignment.py (no training path of either
package calls it): `shoot_infs` replaces infinities by the largest finite
entry, as one vectorized select, and `sinkhorn_knopp` balances rows and
columns in f32 for a fixed number of iterations, as the JAX functions do.
"""

from __future__ import annotations

import torch


def shoot_infs(x: torch.Tensor) -> torch.Tensor:
    """Replace infs by the max of the finite entries (0 where every finite
    entry is below 0, as in the JAX function)."""
    is_inf = torch.isinf(x)
    m = torch.where(is_inf, 0.0, x).max()
    return torch.where(is_inf, m, x)


def sinkhorn_knopp(logits: torch.Tensor, num_iters: int = 3,
                   epsilon: float = 0.05) -> torch.Tensor:
    """Balanced assignment: rows ~ samples, cols ~ prototypes. Returns the
    column-normalized transport plan transposed, (Q / Q.sum(0)).T."""
    q = logits.float() / epsilon
    q = q - q.max()
    Q = shoot_infs(torch.exp(q).T)          # K x B
    Q = Q / Q.sum()
    k, b = Q.shape
    r = torch.full((k,), 1.0 / k, device=Q.device)
    c = torch.full((b,), 1.0 / b, device=Q.device)
    for _ in range(num_iters):
        u = shoot_infs(r / Q.sum(1))
        Q = Q * u[:, None]
        Q = Q * (c / Q.sum(0))[None, :]
    return (Q / Q.sum(0, keepdim=True)).T
