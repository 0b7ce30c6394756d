"""The collectives of the data-parallel step, over torch.distributed (NCCL
on the card, gloo on the CPU).

The JAX package's step is one SPMD program over the global batch; XLA
inserts its collectives. The port's step runs a process a device and
calls these explicitly, each where the global-batch math needs it:

  * `gather_rows`: the contrastive term's inputs of every process,
    concatenated in rank order (ops/contrastive.py); differentiable;
  * `all_gather_rows`: its forward, used also by the train-mode
    BatchNorm's statistics (models/layers.py);
  * `all_reduce_mean_`: the trainable gradients, one coalesced all-reduce
    a dtype (engine/train.py);
  * `reduce_metrics`: the step's loss metrics (engine/train.py,
    engine/experiment.py);
  * `all_reduce_sum_`: the confusion matrix (engine/metrics.py) and
    BatchNorm's backward sums.

Every function is the identity, and calls nothing, when no process group
is initialized; with a group of one process the collectives run (and carry
identity values). Nothing here synchronizes with the host, so the
collectives may sit inside a captured CUDA graph.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """True inside a process group (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def barrier() -> None:
    """Wait for every process of the group; a no-op without one."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(world * n, ...) = every process's (n, ...) `x` in rank order. Not
    differentiable (see `gather_rows`)."""
    x = x.contiguous()
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward gives this process its own
    slice of the gradient, times the world size.

    Every process computes the same function of the gathered tensor, so
    the gradient each holds for the gathered tensor is the same; the
    adjoint of the gather (a reduce-scatter of the sum) is then world x
    this process's slice, computed here without a collective (gloo has no
    reduce-scatter, and NCCL's would only add the same slice world
    times). The gradient all-reduce divides by the world size after the
    backward, so the contrastive term's gradient counts once."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        ctx.rank = dist.get_rank()
        ctx.world = dist.get_world_size()
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        mine = grad.narrow(0, ctx.rank * ctx.n, ctx.n)
        return mine * ctx.world


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's `x` concatenated along dim 0 in rank order, with
    `_GatherRows`'s gradient; `x` itself without a process group."""
    if not is_distributed():
        return x
    if x.requires_grad:
        return _GatherRows.apply(x)
    return all_gather_rows(x)


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the processes, in place; returns `x`."""
    if is_distributed():
        dist.all_reduce(x)
    return x


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average `tensors` over the processes, in place: one all-reduce of a
    flat buffer for each dtype, then a division by the world size."""
    if not is_distributed() or not tensors:
        return
    world = dist.get_world_size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(world)
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """`metrics` with the 0-d tensors named in `keys` replaced by their
    mean over the processes (one all-reduce); the global value of a mean
    over every pixel, since each process holds as many pixels."""
    if not is_distributed() or not keys:
        return metrics
    vals = torch.stack([metrics[k] for k in keys])
    dist.all_reduce(vals)
    vals = vals / dist.get_world_size()
    return {**metrics, **dict(zip(keys, vals.unbind()))}


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy process `src`'s `tensors` into every process's, in place: one
    broadcast of a flat buffer for each dtype."""
    if not is_distributed() or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])
