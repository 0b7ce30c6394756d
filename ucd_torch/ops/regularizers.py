"""EWC / PI (path integral) / RW (Riemannian walk) regularizers.

The port's copy of ucd_tpu/ops/regularizers.py. Every tree of the JAX
package is a dict here, parameter name (the model's `named_parameters`) to
tensor. The state lives on the parameters' device and every step updates
it in place, its iteration count included, so a step captured in a CUDA
graph (engine/train.py `make_train_bundle`) carries it: nothing of it is a
host value that a replay would freeze. The penalty's gradient is added
analytically,

    d/dθ [ w (θ - θ_old)^2 ] = 2 w (θ - θ_old),

so the regularizer costs elementwise passes and no second backward.

Cross-step flow: at the end of step k, `export_state` gives the raw
accumulators (fisher / score / delta) that the checkpoint keeps; at step
k+1 `init_reg_state` turns them into the (optionally min-max normalized)
penalty weights against the donor's parameters. `export_full` /
`restore_full` carry the in-flight accumulators across a same-step resume.

On the 2-D data x model mesh (ucd_torch/parallel/mesh.py) every tree holds
this rank's shards, cut as the parameters are (engine/state.py), and the
state names the sharded leaves (`sharded`) and the model group (`group`).
The accumulators and the penalty's gradient are elementwise, so they stay
shard-local; the penalty's value, which reads every whole leaf, sums the
sharded leaves' partial sums over the model group (one all-reduce; a
replicated leaf counts once). The penalty weights are normalized whole,
before the state is sharded.
"""

from __future__ import annotations

import dataclasses
from typing import AbstractSet, Any, Dict, Mapping, Optional

import torch

from ..parallel.collectives import all_reduce_sum_

EPS = 1e-8
MEMBER_FIELDS = ("fisher", "delta", "score", "prev_params", "saved_score")
# every tree of the state
TREE_FIELDS = MEMBER_FIELDS + ("penalty_w", "old_params")

Tree = Dict[str, torch.Tensor]


def normalize_tree(tree: Mapping[str, torch.Tensor]) -> Tree:
    """Per-tensor min-max normalization: (x - min) / (max - min + EPS)."""
    return {k: (x - x.min()) / (x.max() - x.min() + EPS)
            for k, x in tree.items()}


@dataclasses.dataclass
class RegState:
    """The regularizer's state. The dicts hold every parameter of the
    model; `count` is a 0-d int64 tensor beside them. `saved_mask` names the
    parameters present in the previous step's score (RW's export averages
    only those). On the 2-D mesh the dicts hold this rank's shards,
    `sharded` names the sharded leaves and `group` is the model group."""
    kind: str
    alpha: float = 0.9
    iterations: int = 10
    penalize: bool = False
    fisher: Optional[Tree] = None        # EWC / RW online fisher
    delta: Optional[Tree] = None         # PI path-integral accumulator
    score: Optional[Tree] = None         # RW score accumulator
    prev_params: Optional[Tree] = None   # parameters at the last update
    count: Optional[torch.Tensor] = None
    penalty_w: Optional[Tree] = None     # weights of the quadratic penalty
    old_params: Optional[Tree] = None    # θ_old, the penalty's anchor
    saved_score: Optional[Tree] = None   # previous step's score (PI / RW)
    saved_mask: Optional[Dict[str, bool]] = None
    sharded: AbstractSet[str] = frozenset()
    group: Any = None


def _clone(tree: Mapping[str, torch.Tensor]) -> Tree:
    return {k: v.detach().clone() for k, v in tree.items()}


def _grow(saved: Optional[Mapping], fill: Mapping[str, torch.Tensor]
          ) -> Optional[Tree]:
    """`saved` over the names of `fill`: a name missing from `saved` takes
    its `fill` tensor. Each tensor lands on its fill's device and dtype."""
    if saved is None:
        return None
    return {k: (torch.as_tensor(saved[k]).to(f.device, f.dtype).clone()
                if k in saved else f.clone()) for k, f in fill.items()}


def init_reg_state(kind: Optional[str], params: Mapping[str, torch.Tensor],
                   old_params: Optional[Mapping] = None,
                   saved: Optional[Mapping] = None, alpha: float = 0.9,
                   iterations: int = 10,
                   normalize: bool = True) -> Optional[RegState]:
    """The state for a new step.

    `params` are the model's parameters by name (copied: the state never
    aliases them). `saved` is the previous step's `export_state` (None for
    a fresh run: no penalty applies). New parameters (a new classifier)
    take a fill value in the accumulators (ones for the fisher, zeros
    elsewhere) and a ZERO penalty weight: the penalty skips parameters
    absent from the donor or from the saved importance."""
    if kind is None or kind == "none":
        return None
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    ones = {k: torch.ones_like(p) for k, p in params.items()}
    device = next(iter(params.values())).device
    count = torch.zeros((), dtype=torch.int64, device=device)
    penalize = saved is not None and old_params is not None
    # the penalty's anchor: the donor's parameters, a new parameter at its
    # current value (zero weight there); without a donor the start
    anchor = _grow(old_params, params) if old_params is not None \
        else _clone(params)

    def finalize_pw(saved_tree):
        """Grown, normalized, zero where saved or donor lacks the name."""
        pw = _grow(saved_tree, zeros)
        if normalize:
            pw = normalize_tree(pw)
        for k in pw:
            if k not in saved_tree or k not in old_params:
                pw[k] = torch.zeros_like(pw[k])
        return pw

    def get(key):
        return saved.get(key) if saved else None

    if kind == "ewc":
        fisher = _grow(get("fisher"), ones)
        pw = finalize_pw(get("fisher")) \
            if penalize and get("fisher") is not None else None
        return RegState(kind="ewc", alpha=alpha, penalize=pw is not None,
                        fisher=fisher if fisher is not None else ones,
                        count=count, penalty_w=pw, old_params=anchor)

    if kind == "pi":
        score_prev = get("score")
        pw = finalize_pw(score_prev) \
            if penalize and score_prev is not None else None
        return RegState(kind="pi", penalize=pw is not None, delta=zeros,
                        prev_params=_clone(params), count=count,
                        penalty_w=pw, old_params=anchor,
                        saved_score=_grow(score_prev, zeros))

    if kind == "rw":
        fisher = _grow(get("fisher"), ones)
        score_prev = get("score")
        pw = None
        if penalize and get("fisher") is not None \
                and score_prev is not None:
            f = finalize_pw(get("fisher"))
            s = finalize_pw(score_prev)
            pw = {k: f[k] + s[k] for k in f}
        saved_mask = None if score_prev is None \
            else {k: k in score_prev for k in params}
        return RegState(kind="rw", alpha=alpha, iterations=iterations,
                        penalize=pw is not None,
                        fisher=fisher if fisher is not None else ones,
                        score=zeros, prev_params=_clone(params), count=count,
                        penalty_w=pw, old_params=anchor,
                        saved_score=_grow(score_prev, zeros),
                        saved_mask=saved_mask)

    raise NotImplementedError(kind)


def _online_fisher(state: RegState, names, g) -> None:
    """F <- alpha g^2 + (1 - alpha) F, in place."""
    f = [state.fisher[k] for k in names]
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, state.alpha)
    torch._foreach_mul_(f, 1 - state.alpha)
    torch._foreach_add_(f, g2)


@torch.no_grad()
def update(state: Optional[RegState], grads: Mapping[str, torch.Tensor],
           params: Mapping[str, torch.Tensor]) -> None:
    """The per-iteration accumulator update with the main loss's gradients
    of every parameter (frozen ones included) and the parameters before
    the optimizer's update; in place. Where the JAX package selects 0 by
    the iteration count, the increment is multiplied by a 0/1 tensor: the
    same numbers for a finite gradient."""
    if state is None:
        return
    names = list(state.old_params)
    g = [grads[k] for k in names]
    p = [params[k] for k in names]
    if state.kind == "ewc":  # the count stays 0, as in the JAX package
        _online_fisher(state, names, g)
        return
    pp = [state.prev_params[k] for k in names]
    if state.kind == "pi":
        # delta += g (θ_prev - θ) from the second iteration on; θ_prev <- θ
        inc = torch._foreach_sub(pp, p)
        torch._foreach_mul_(inc, g)
        torch._foreach_mul_(inc, (state.count != 0).to(p[0].dtype))
        torch._foreach_add_([state.delta[k] for k in names], inc)
        torch._foreach_copy_(pp, p)
        state.count.add_(1)
        return
    if state.kind == "rw":
        # every `iterations` iterations (not the first):
        # score += g (θ_prev - θ) / (0.5 F (θ - θ_prev)^2 + EPS), θ_prev <- θ
        do_score = (state.count % state.iterations) == 0
        take = (do_score & (state.count > 0)).to(p[0].dtype)
        delta = torch._foreach_sub(pp, p)
        torch._foreach_mul_(delta, g)
        den = torch._foreach_sub(p, pp)
        torch._foreach_mul_(den, den)
        torch._foreach_mul_(den, [state.fisher[k] for k in names])
        torch._foreach_mul_(den, 0.5)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(delta, den)
        torch._foreach_mul_(delta, take)
        torch._foreach_add_([state.score[k] for k in names], delta)
        for a, b in zip(pp, p):
            a.copy_(torch.where(do_score, b, a))
        # online fisher every iteration, after the score read the old one
        _online_fisher(state, names, g)
        state.count.add_(1)
        return
    raise NotImplementedError(state.kind)


def _diffs(state: RegState, params) -> tuple:
    names = list(state.penalty_w)
    d = torch._foreach_sub([params[k] for k in names],
                           [state.old_params[k] for k in names])
    return names, d, [state.penalty_w[k] for k in names]


def _penalty_value(state: RegState, names, d, w) -> torch.Tensor:
    wd2 = torch._foreach_mul(w, torch._foreach_mul(d, d))
    sums = [x.sum() for x in wd2]
    if state.group is None:
        return torch.stack(sums).sum()
    # the sharded leaves' partial sums over the model group, once
    part = [s for k, s in zip(names, sums) if k in state.sharded]
    rest = [s for k, s in zip(names, sums) if k not in state.sharded]
    total = torch.zeros_like(sums[0])
    if part:
        total = all_reduce_sum_(torch.stack(part).sum(), state.group)
    if rest:
        total = total + torch.stack(rest).sum()
    return total


@torch.no_grad()
def penalty(state: Optional[RegState], params) -> Optional[torch.Tensor]:
    """Σ w (θ - θ_old)^2 as a 0-d tensor, or None when nothing is
    penalized."""
    if state is None or not state.penalize:
        return None
    names, d, w = _diffs(state, params)
    return _penalty_value(state, names, d, w)


@torch.no_grad()
def penalty_and_grad(state: Optional[RegState], params,
                     importance: float):
    """(importance * penalty, {name: its gradient 2 importance w (θ -
    θ_old)}), or (None, None) when nothing is penalized."""
    if state is None or not state.penalize:
        return None, None
    names, d, w = _diffs(state, params)
    grad = torch._foreach_mul(w, 2.0 * importance)
    torch._foreach_mul_(grad, d)
    return (importance * _penalty_value(state, names, d, w),
            dict(zip(names, grad)))


def penalty_grad(state: Optional[RegState], params, importance: float):
    """Gradient of importance * penalty by name, or None."""
    return penalty_and_grad(state, params, importance)[1]


def export_full(state: Optional[RegState]) -> Optional[dict]:
    """The in-flight accumulators and the count, for a same-step resume
    that is bit-identical to an uninterrupted run."""
    if state is None:
        return None
    out: dict = {"count": state.count}
    for f in MEMBER_FIELDS:
        v = getattr(state, f)
        if v is not None:
            out[f] = v
    return out


@torch.no_grad()
def restore_full(state: Optional[RegState],
                 saved: Optional[Mapping]) -> Optional[RegState]:
    """Copy a mid-step snapshot into a freshly initialized state, in place
    (a captured step keeps reading the same tensors). The penalty weights
    and the anchor come from the previous step's export at init."""
    if state is None or saved is None:
        return state
    state.count.fill_(int(torch.as_tensor(saved["count"])))
    for f in MEMBER_FIELDS:
        src, dst = saved.get(f), getattr(state, f)
        if src is None:
            continue
        if dst is None or set(src) != set(dst):
            raise ValueError(f"regularizer snapshot field {f!r} does not "
                             f"match the {state.kind} state")
        for k, t in dst.items():
            t.copy_(torch.as_tensor(src[k]))
    return state


@torch.no_grad()
def export_state(state: Optional[RegState], params) -> Optional[dict]:
    """The raw accumulators of the cross-step handoff (the next step's
    importance). PI: score = max(delta / ((θ - θ_start)^2 + 1e-20), 0),
    plus the previous score (a plain sum, as the reference). RW: score
    clamped at 0, averaged 0.5 (new + old) over the parameters present in
    the previous step's score; new parameters keep their own."""
    if state is None:
        return None
    if state.kind == "ewc":
        return {"fisher": _clone(state.fisher)}
    if state.kind == "pi":
        score = {}
        for k, d in state.delta.items():
            s = torch.clamp_min(
                d / ((params[k] - state.old_params[k]) ** 2 + 1e-20), 0.0)
            if state.saved_score is not None:
                s = s + state.saved_score[k]
            score[k] = s
        return {"score": score, "delta": _clone(state.delta)}
    if state.kind == "rw":
        score = {}
        for k, s in state.score.items():
            s = torch.clamp_min(s, 0.0)
            if state.saved_score is not None and (
                    state.saved_mask is None or state.saved_mask[k]):
                s = 0.5 * (s + state.saved_score[k])
            score[k] = s
        return {"score": score, "fisher": _clone(state.fisher)}
    raise NotImplementedError(state.kind)


def state_tensors(state: Optional[RegState]) -> list:
    """Every tensor of the state that a step reads or writes."""
    if state is None:
        return []
    out = [state.count]
    for f in TREE_FIELDS:
        tree = getattr(state, f)
        if tree is not None:
            out += list(tree.values())
    return out
