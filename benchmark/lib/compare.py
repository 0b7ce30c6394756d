"""The comparisons that decide `correct`, each a number held to a limit of
the cell's limits file (benchmark/limits/<cell>.json).

Training (the first steps of the very train state the window then
drives, against the reference following the same steps from the same
weights and batches):

    loss_gap    the largest relative gap of a loss term (unbiased CE, the
                weighted KD and contrastive terms, their total) over the
                checked steps;
    grad_gap    the worst leaf's gap between the norms of the momentum
                buffer after the first call (the gradient as the optimizer
                took it, with its weight decay), relative to the
                reference's norm of that leaf or of the median leaf,
                whichever is larger;
    change_gap  the same for the change of every parameter and BatchNorm
                statistic over the checked steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone; they are left out of both leaf numbers.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Iterable, List

import torch

TERMS = ("loss", "lkd", "l_con", "loss_tot")


def loss_gap(prog: List[dict], ref: List[dict]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        for k in TERMS:
            gap = abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def kept_leaves(grad_norms: Dict[str, float]) -> set:
    floor = 1e-3 * median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= floor}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 keep: Iterable[str], n: int = 6) -> list:
    """The `n` leaves of the largest gaps: (leaf, gap, program's norm,
    reference's norm), for the log."""
    keep = [k for k in keep if k in ref]
    floor = median(ref[k] for k in keep)
    rows = sorted(((abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor),
                    k) for k in keep), reverse=True)[:n]
    return [(k, g, prog.get(k), ref[k]) for g, k in rows]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack(torch._foreach_norm(
        [tensors[k].detach().double() for k in names])).tolist()
    return dict(zip(names, vals))


def change_norms(after: Dict[str, torch.Tensor],
                 before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return norms({k: after[k].detach().double().cpu() - before[k].double()
                  for k in before})
