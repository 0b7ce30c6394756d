"""Core layers: fused norm+activation (ABN), conv and initializers.

Counterpart of ucd_tpu/models/layers.py. Modules are NCHW (the port keeps
activations in `channels_last` memory, so NCHW tensors are NHWC in memory).

Dtype policy, as in the JAX package: convolutions take and return the
model's compute dtype (bf16 or f32; cuDNN accumulates in f32) while their
master weights stay f32 and are cast at each call, so the optimizer, weight
decay and momentum act on f32 and the gradients arrive in f32. By default
every ABN normalizes in f32 from f32 statistics and casts back to the
compute dtype after the activation. With a bf16 `norm_dtype` (the JAX
package's `bf16_norm` / `bf16_norm_early`) the normalized output is rounded
to bf16 before the activation, where flax's `BatchNorm(dtype=bf16)` rounds
it; a bf16 input is then handed to the BatchNorm as it is (f32 weights and
statistics, f32 arithmetic inside), with no f32 copy. float64 is a
test-only compute dtype: weights, statistics and normalization are then
all f64. On the card, a bf16 BatchNorm ABN of a bf16 model with the wide
norm and leaky-ReLU or identity, in eval mode or outside a process group,
runs as ops/fused_abn.py's kernels (`ABN._fused`): the same values at the
same rounding point, bf16 in and out, f32 in registers only.

Train-mode BatchNorm follows flax: the batch is normalized with its biased
variance and the running variance takes the *biased* batch variance too
(torch's own update takes the unbiased one). The variance is always the
cancellation-free one (`stable_norm=True` on the JAX side); flax's default
one-pass E[x^2]-E[x]^2 is not reproduced.

Rematerialization (`remat_contexts`, the JAX package's `remat` /
`remat_early`): a block run under `torch.utils.checkpoint` runs its
forward twice, once in the forward pass and again in the backward. The
running statistics and `num_batches_tracked` move in the first run only, and
inside a process group the recompute reuses the global statistics of the
first run instead of gathering them again, so a rematerialized step leaves
the statistics as the plain step does (flax's `nn.remat` recomputes
functionally: its `batch_stats` move once).

On the 2-D data x model mesh (ucd_torch/parallel/mesh.py, `use_mesh`) a
wide conv holds a shard of its output channels and its ABN the same
shard of the per-channel parameters and statistics, so an activation is
either whole (every model rank computes it alike) or this rank's channel
shard; its channel count tells which. `conv_input` makes a conv's input
from either, and BatchNorm statistics, local to a channel, combine over
the data group only. A GroupNorm ABN normalizes its shard alone where the
shard holds whole groups, and else gathers its input and normalizes it
whole (`ABN._group_norm`). Rematerialized blocks re-run their model-axis
gathers in the recompute; the statistics still move once.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_abn as FA
from ..parallel.collectives import (all_gather_rows, all_reduce_sum_,
                                   copy_to_model, gather_from_model,
                                   is_distributed)
from ..utils import tracing


def leaky_relu_gain(negative_slope: float) -> float:
    """torch.nn.init.calculate_gain('leaky_relu', slope)."""
    return math.sqrt(2.0 / (1.0 + negative_slope ** 2))


def _trunc_normal_fan_in_(w: torch.Tensor, scale: float,
                          generator: torch.Generator) -> torch.Tensor:
    """flax variance_scaling(scale, 'fan_in', 'truncated_normal'): a normal
    truncated at two standard deviations, with the std corrected so the
    truncated draw has variance scale/fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def he_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax `nn.initializers.he_normal()` (the body's conv init)."""
    return _trunc_normal_fan_in_(w, 2.0, generator)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv kernel init (the `cls_i` classifiers)."""
    return _trunc_normal_fan_in_(w, 1.0, generator)


@torch.no_grad()
def xavier_normal_gain_(w: torch.Tensor, gain: float,
                        generator: torch.Generator) -> torch.Tensor:
    """Xavier/Glorot normal with an explicit gain (the ASPP head's init)."""
    return nn.init.xavier_normal_(w, gain=gain, generator=generator)


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype that norms, classifiers and losses compute in under the
    compute dtype `dtype`: f32, or f64 for the test-only f64 model."""
    return torch.float64 if dtype == torch.float64 else torch.float32


_remat = threading.local()


@contextlib.contextmanager
def _remat_phase(phase: str):
    saved = getattr(_remat, "phase", None)
    _remat.phase = phase
    try:
        yield
    finally:
        _remat.phase = saved


def remat_contexts():
    """`context_fn` for `torch.utils.checkpoint`: marks the first forward
    and the recompute, which runs in the backward (on whichever thread the
    autograd engine runs it)."""
    return _remat_phase("forward"), _remat_phase("recompute")


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a process group.

    Forward: each process's per-channel (count, mean, M2 = count * biased
    variance), all-gathered and combined with Chan's formula (M2 = sum M2_p
    + sum n_p (mean_p - mean)^2; never E[x^2] - E[x]^2), then x normalized
    with those global statistics. Backward: this process's per-channel
    sums of dy and dy * (x - mean), all-reduced, and dx from the global
    sums,

        dx = weight * invstd * (dy - mean(dy) - x_hat * mean(dy * x_hat));

    the weight and bias gradients stay this process's sums (the step's
    gradient all-reduce averages them). The collectives and the combine
    are one code path on gloo and NCCL; the per-process passes are torch's
    fused SyncBatchNorm kernels on CUDA (`batch_norm_stats`, `_elemt`,
    `_backward_reduce`, `_backward_elemt`: CUDA only, about a fifth of the
    device time of the generic ops there) and the generic ops elsewhere
    (`var_mean`, the normalize, the inference-mode BatchNorm backward plus
    the global sums' term). Returns (y, mean, biased variance) for the
    running statistics.

    A bf16 input with f32 weights is taken as it is on CUDA (the fused
    kernels compute in f32 and return bf16); elsewhere it is widened to the
    weights' dtype and the output rounded back. `stats` = (mean, biased
    variance, per-process counts) of an earlier run over the same batch (a
    rematerialized block's recompute) skips the statistics and their
    gather. `group` is the process group the batch is split over (None:
    the world; the data group on a 2-D mesh)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, stats=None, group=None):
        c = x.shape[1]
        in_dtype = x.dtype
        if not x.is_cuda and x.dtype != weight.dtype:
            x = x.to(weight.dtype)
        if not (x.is_contiguous()
                or x.is_contiguous(memory_format=torch.channels_last)):
            x = x.contiguous()
        if stats is not None:
            mean, var, counts = stats
        else:
            if x.is_cuda:
                mean, invstd = torch.batch_norm_stats(x, 0.0)
                # the biased variance (the kernel's invstd is 0 for a
                # constant channel)
                var = torch.where(invstd > 0, invstd.pow(-2), 0.0)
            else:
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            n = mean.new_full((1,), x.numel() // c)
            packed = torch.cat([n, mean, var * n])[None]
            gathered = all_gather_rows(packed) if group is None \
                else all_gather_rows(packed, group)
            counts, means = gathered[:, :1], gathered[:, 1:c + 1]
            m2 = gathered[:, c + 1:]
            total = counts.sum()
            mean = (counts * means).sum(0) / total
            var = (m2.sum(0) + (counts * (means - mean) ** 2).sum(0)) / total
            counts = counts.to(torch.int32).view(-1)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c, 1, 1)
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            # (x - mean) first: x * scale + shift would cancel where the
            # variance is small beside the mean
            y = torch.addcmul(bias.view(shape), x - mean.view(shape),
                              (invstd * weight).view(shape)).to(in_dtype)
        ctx.save_for_backward(x, weight, mean, var, invstd, counts)
        ctx.eps = eps
        ctx.group = group
        ctx.in_dtype = in_dtype
        ctx.mark_non_differentiable(mean, var, counts)
        return y, mean, var, counts

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcounts):
        x, weight, mean, var, invstd, counts = ctx.saved_tensors
        c = x.shape[1]
        dw, db = ctx.needs_input_grad[1:3]
        dy = dy.to(x.dtype)
        if not (dy.is_contiguous()
                or dy.is_contiguous(memory_format=torch.channels_last)):
            dy = dy.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, grad_w, grad_b = \
                torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                 True, dw, db)
            both = all_reduce_sum_(torch.cat([sum_dy, sum_dy_xmu]),
                                   ctx.group)
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, both[:c], both[c:], counts)
            return dx, grad_w, grad_b, None, None, None
        # inference mode: the statistics are constants here (CUDA's kernel
        # asks for them twice, as running and as saved statistics)
        dx, grad_w, grad_b = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, mean, var, mean, invstd, False, ctx.eps,
            [True, True, True])
        both = all_reduce_sum_(torch.cat([grad_b, grad_w]), ctx.group)
        total = counts.sum().to(x.dtype)
        scale = weight * invstd
        # dx - scale * (mean(dy) + x_hat * mean(dy * x_hat))
        a = -scale * invstd * both[c:] / total
        b = -scale * both[:c] / total
        shape = (1, c, 1, 1)
        dx = dx.addcmul_(x - mean.view(shape), a.view(shape)).add_(
            b.view(shape))
        return (dx.to(ctx.in_dtype), grad_w if dw else None,
                grad_b if db else None, None, None, None)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance takes the biased
    batch variance, as flax's BatchNorm does.

    Inside a process group (ucd_torch/parallel; any size, one included)
    the train-mode statistics are the global batch's, combined across the
    processes by `_SyncBatchNorm`, as the JAX program's are (it is one
    program over the global batch). torch's SyncBatchNorm is not used: it
    runs on CUDA only and its running variance is the unbiased one. Eval
    mode (the frozen donor, `fix_bn`) never synchronizes.

    Under rematerialization (`remat_contexts`) the statistics move in the
    first forward only; the recompute normalizes with the batch statistics
    again (from the first run's global ones inside a process group).

    `group` is the process group the batch is split over: None (the
    world), or the data group on a 2-D mesh (`use_mesh`), where the
    module may hold a channel shard of its parameters and statistics."""

    group = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # global statistics of rematerialized first runs, oldest first
        self._remat_stats = collections.deque()

    def tally(self):
        """(update, factor) of a train-mode call: whether the running
        statistics move (not in a rematerialized recompute; a call that
        moves them counts in `num_batches_tracked`) and their lerp
        weight."""
        update = getattr(_remat, "phase", None) != "recompute"
        if update:
            self.num_batches_tracked.add_(1)
        factor = self.momentum if self.momentum is not None \
            else 1.0 / float(self.num_batches_tracked)
        return update, factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        phase = getattr(_remat, "phase", None)
        update, factor = self.tally()
        if is_distributed():
            stats = self._remat_stats.popleft() if not update else None
            y, mean, var, counts = _SyncBatchNorm.apply(
                x, self.weight, self.bias, self.eps, stats, self.group)
            if update:
                if phase == "forward" and torch.is_grad_enabled():
                    self._remat_stats.append((mean, var, counts))
                with torch.no_grad():
                    self.running_mean.lerp_(mean, factor)
                    self.running_var.lerp_(var, factor)
            return y
        # the batch's mean and unbiased variance land in scratch buffers
        # (momentum 1); the running statistics then take the mean and the
        # *biased* variance, as flax's do
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        if update:
            with torch.no_grad():
                self.running_mean.lerp_(mean, factor)
                self.running_var.lerp_(var * ((n - 1) / n), factor)
        return y


class ABN(nn.Module):
    """BatchNorm (or GroupNorm) + activation (`inplace_abn.ABN` semantics).

    `activation='identity'` is the last norm of each residual block and of
    the projection shortcuts. Normalization and activation run in f32 (f64
    under the f64 test dtype) and the output is cast to `dtype`; a bf16
    `norm_dtype` rounds the normalized output to bf16 and activates in bf16
    (flax's `norm_dtype`). Flax momentum 0.9 is torch momentum 0.1.

    `norm_type='gn'` is GroupNorm with min(gn_groups, channels) groups, eps
    1e-5 and wide parameters under `gn` (flax's `gn/scale`, `gn/bias`); it
    has no running statistics.

    On the 2-D mesh (`mesh`) the ABN may hold a channel shard of its
    parameters and take that shard of its input."""

    mesh = None

    def __init__(self, channels: int, activation: str = "leaky_relu",
                 activation_param: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 norm_dtype: Optional[torch.dtype] = None,
                 norm_type: str = "bn", gn_groups: int = 16):
        super().__init__()
        if activation not in ("leaky_relu", "elu", "identity"):
            raise ValueError(f"unknown activation {activation!r}")
        if norm_type not in ("bn", "gn"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.channels = channels
        self.activation = activation
        self.activation_param = activation_param
        self.dtype = dtype
        self.wide = wide_dtype(dtype)
        # the dtype the normalized output is rounded to (None: the wide one)
        self.norm_dtype = norm_dtype
        self.norm_type = norm_type
        if norm_type == "gn":
            self.gn = nn.GroupNorm(min(gn_groups, channels), channels,
                                   eps=1e-5, dtype=self.wide)
        else:
            self.bn = BatchNorm2d(channels, eps=1e-5, momentum=0.1,
                                  dtype=self.wide)

    @property
    def norm(self) -> nn.Module:
        """The norm module (`bn` or `gn`)."""
        return self.gn if self.norm_type == "gn" else self.bn

    def forward(self, x: torch.Tensor, runs: int = 1) -> torch.Tensor:
        """`runs`: on the mesh, how many contiguous runs of the unsharded
        channels a shard holds (the ASPP's `map_bn` over sharded branches
        holds a slice of each, models/deeplab.py); 1 elsewhere. With
        tracing on it runs inside the profiler range `ucd.abn`
        (utils/tracing.py)."""
        if tracing.ON:
            with tracing.span("ucd.abn"):
                return self._norm_act(x, runs)
        return self._norm_act(x, runs)

    def _norm_act(self, x: torch.Tensor, runs: int) -> torch.Tensor:
        if FA.routes(x.device.type, x.dtype, self.dtype, self.norm_type,
                     self.norm_dtype, self.activation, self.norm.training,
                     is_distributed()):
            return self._fused(x)
        if x.is_cuda:
            FA.bypass()
        rounded = self.norm_dtype is not None and self.norm_dtype != self.wide
        if self.norm_type == "gn":
            y = self._group_norm(x.to(self.wide), runs)
        elif rounded and x.dtype == self.norm_dtype:
            # torch's mixed-dtype batch_norm (CUDA, and the CPU's) takes the
            # narrow input with wide weights and statistics, computes in
            # f32 and returns the narrow output: flax's rounding point
            y = self.bn(x)
        else:
            y = self.bn(x.to(self.wide))
        if rounded:
            y = y.to(self.norm_dtype)
        # in place: the norm's backward needs its input, not its output
        if self.activation == "leaky_relu":
            y = F.leaky_relu(y, self.activation_param, inplace=True)
        elif self.activation == "elu":
            y = F.elu(y, self.activation_param, inplace=True)
        return y.to(self.dtype)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """The chain through ops/fused_abn.py's kernels: the same values
        at the same rounding point, the running statistics moved as
        `BatchNorm2d.forward` moves them."""
        bn = self.bn
        update, factor = bn.tally() if bn.training else (False, 0.0)
        slope = self.activation_param if self.activation == "leaky_relu" \
            else 1.0
        return FA.fused_abn(x, bn.weight, bn.bias, bn.running_mean,
                            bn.running_var, training=bn.training,
                            update=update, momentum=factor, eps=bn.eps,
                            slope=slope)

    def _group_norm(self, x: torch.Tensor, runs: int) -> torch.Tensor:
        """GroupNorm of `x`, whole or this rank's channel shard. A shard
        that holds whole groups (each run a multiple of the group size) is
        normalized alone; else the shards are gathered, normalized whole
        in the unsharded channel order, and this rank keeps its channels
        (the gradient of the whole input, partial on each rank, is summed
        over the model group before each rank takes its slice)."""
        gn = self.gn
        c, channels = gn.weight.shape[0], gn.num_channels
        if c == channels:
            return gn(x)
        size = channels // gn.num_groups
        if (c // runs) % size == 0:
            return F.group_norm(x, c // size, gn.weight, gn.bias, gn.eps)
        group = self.mesh.model_group
        xw = copy_to_model(gather_from_model(x, group), group)
        # the gathered channels are rank-major (rank, run, slice)
        idx = torch.arange(channels, device=x.device).view(
            runs, self.mesh.n_model, -1)
        xw = xw.index_select(1, idx.transpose(0, 1).reshape(-1).argsort())
        y = F.group_norm(xw, gn.num_groups, eps=gn.eps).index_select(
            1, idx[:, self.mesh.model_index].reshape(-1))
        shape = (1, c, 1, 1)
        return y * gn.weight.view(shape) + gn.bias.view(shape)


class Conv2d(nn.Conv2d):
    """Bias-free conv whose weight is cast to the input's dtype at each call
    (f32 masters under the bf16 policy; a weight already in the compute
    dtype, as in a bf16 serving model, is used as it is)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        return self._conv_forward(x, w, None)


def conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
         dilation: int = 1, dtype: torch.dtype = torch.float32) -> Conv2d:
    """Bias-free conv with torch-style symmetric padding dilation*(k-1)//2.
    `dtype` is the dtype of the stored weight."""
    return Conv2d(in_channels, out_channels, kernel, stride=stride,
                  padding=dilation * (kernel - 1) // 2, dilation=dilation,
                  bias=False, dtype=dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims, keepdims."""
    return x.mean(dim=(2, 3), keepdim=True)


# ---------------------------------------------------------------------------
# the model axis of the 2-D mesh
# ---------------------------------------------------------------------------

def is_sharded(conv: nn.Conv2d) -> bool:
    """True where `conv` holds a shard of its output channels (its weight,
    or the donor's variable in its place under `functional_call`)."""
    return conv.weight.shape[0] != conv.out_channels


def whole(x: torch.Tensor, channels: int, group) -> torch.Tensor:
    """`x` with all its `channels`: gathered over the model `group` where
    it is this rank's shard."""
    return gather_from_model(x, group) if x.shape[1] != channels else x


def conv_input(x: torch.Tensor, conv: nn.Conv2d, group) -> torch.Tensor:
    """What `conv` takes from `x` (whole or a shard) on the model axis: the
    whole tensor, whose gradient is summed over the model `group` where
    `conv` is sharded (each rank holds a partial gradient through its own
    weight shard)."""
    x = whole(x, conv.in_channels, group)
    return copy_to_model(x, group) if is_sharded(conv) else x


def use_mesh(model: nn.Module, mesh) -> nn.Module:
    """Put `model` (its parameters already sharded, engine/state.py
    `shard_module_`, or a donor shell evaluated on sharded variables) on
    the 2-D mesh `mesh`: every module that carries the model axis reads
    `mesh`, and every BatchNorm combines its statistics over the data
    group. Every execution option and norm of the model runs there."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = mesh.data_group
        if "mesh" in type(m).__dict__:
            m.mesh = mesh
    return model
