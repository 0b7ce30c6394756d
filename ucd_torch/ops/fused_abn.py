"""Fused BatchNorm + activation (the ABN chain) for bf16 activations.

Replaces no kernel of the JAX package: XLA fuses the chain into the
convolutions on the TPU. On the card the plain chain of
models/layers.py `ABN` (widen to f32, cuDNN BatchNorm, leaky-ReLU, cast
back) moves some 104 bytes per element and step and keeps two f32 tensors
per element for the backward; `csrc/fused_abn.cu` reads bf16, computes in
f32 registers and writes bf16, at the plain chain's rounding point (the
note there gives the design and its bound).

`fused_abn` computes, for an NCHW input x (channels_last on the card),
weight w, bias b and the running statistics:
  train mode: mean and the biased variance of x over (N, H, W), the
      running mean and *biased* variance lerped towards them with
      `momentum` if `update` (not in a rematerialized recompute);
  eval mode: the running mean and variance;
  z = (x - mean) * (invstd * w) + b in the weights' dtype (f32; f64 for
      the f64 test model), invstd = 1 / sqrt(var + eps);
  y = z > 0 ? z : slope * z (identity: slope 1), rounded once to x's dtype.
The backward recomputes z, takes the activation's mask from its sign and
returns dx (x's dtype), dW and dB (the weights' dtype). Only x and the
per-channel (mean, invstd) are saved for it.

Both passes are `torch.library` operators, `ucd::batch_norm_act` and
`ucd::batch_norm_act_backward`, so the profiler names them (and the
kernels they launch) as host operators. A CUDA tensor launches the kernels
(bf16 only; counted in `fused_abn.launches_fwd` / `launches_eval` /
`launches_bwd`) or raises; a CPU tensor takes the plain version
(`batch_norm_act_plain`, `batch_norm_act_backward_plain`), which is also
the reference on the card. `routes` is the rule by which `ABN` sends a
call here; `fused_abn.bypassed` counts its calls on CUDA that kept the
plain chain.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from . import build

KERNEL = "fused_abn"
_count_lock = threading.Lock()

THREADS = 256             # a block of the [R, C] kernels
MAX_ROW_BLOCKS = 512      # row chunks: the partials the finalize combines
TARGET_BLOCKS = 264       # blocks of a launch: 2 per SM of an H100
MIN_ROWS_PER_THREAD = 16  # 4 groups of 4 rows in flight


def routes(device_type: str, x_dtype: torch.dtype,
           compute_dtype: torch.dtype, norm_type: str,
           norm_dtype: Optional[torch.dtype], activation: str,
           training: bool, distributed: bool) -> bool:
    """Whether an ABN call takes the fused kernels: a bf16 CUDA input of a
    bf16 model, BatchNorm normalizing in the wide f32 (no `bf16_norm`),
    leaky-ReLU or identity, and statistics of this process alone: eval
    mode, or train mode outside a process group (inside one, train-mode
    statistics are the global batch's, `_SyncBatchNorm`). Every other call
    keeps the plain chain."""
    return (device_type == "cuda" and x_dtype == torch.bfloat16
            and compute_dtype == torch.bfloat16 and norm_type == "bn"
            and norm_dtype in (None, torch.float32)
            and activation in ("leaky_relu", "identity")
            and not (training and distributed))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _z(xw, mean, invstd, weight, bias):
    return torch.addcmul(_per_channel(bias), xw - _per_channel(mean),
                         _per_channel(invstd * weight))


def batch_norm_act_plain(x, weight, bias, running_mean, running_var,
                         training: bool, update: bool, momentum: float,
                         eps: float, slope: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): the forward in plain PyTorch, in the weights' dtype;
    stats (2, C) = [mean; invstd] for the backward. Moves the running
    statistics in place in train mode if `update`."""
    wide = weight.dtype
    xw = x.to(wide)
    if training:
        var, mean = torch.var_mean(xw, dim=(0, 2, 3), correction=0)
        if update:
            with torch.no_grad():
                running_mean.lerp_(mean.to(running_mean.dtype), momentum)
                running_var.lerp_(var.to(running_var.dtype), momentum)
    else:
        mean, var = running_mean.to(wide), running_var.to(wide)
    invstd = 1.0 / torch.sqrt(var + eps)
    z = _z(xw, mean, invstd, weight, bias)
    y = torch.where(z > 0, z, z * slope)
    return y.to(x.dtype), torch.stack([mean, invstd])


def batch_norm_act_backward_plain(dy, x, weight, bias, stats,
                                  training: bool, slope: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dwb): the backward in plain PyTorch, dwb (2, C) = [dW; dB] in
    the weights' dtype. In eval mode the statistics are constants."""
    wide = weight.dtype
    xw = x.to(wide)
    mean, invstd = stats[0], stats[1]
    z = _z(xw, mean, invstd, weight, bias)
    g = dy.to(wide)
    dz = torch.where(z > 0, g, g * slope)
    xmu = xw - _per_channel(mean)
    sum_dz = dz.sum(dim=(0, 2, 3))
    sum_dz_xmu = (dz * xmu).sum(dim=(0, 2, 3))
    if training:
        n = x.numel() // x.shape[1]
        dz = dz - _per_channel(sum_dz / n) \
            - xmu * _per_channel(sum_dz_xmu / n * invstd * invstd)
    dx = dz * _per_channel(invstd * weight)
    return dx.to(x.dtype), torch.stack([sum_dz_xmu * invstd, sum_dz])


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def launch_plan(R: int, C: int, vec: int) -> Tuple[int, int, int, int]:
    """(tx, n_slices, n_rb, rb_rows) of the [R, C] kernels: tx threads of
    a block along groups of `vec` channels (a power of two up to 32; the
    rest of the block's 256 threads along rows), n_slices blocks across
    the channels, n_rb chunks of rb_rows rows (the last may be shorter,
    none is empty). About TARGET_BLOCKS blocks, each thread at least
    MIN_ROWS_PER_THREAD rows, at most MAX_ROW_BLOCKS chunks. A function of
    the shape alone, so the reductions' order is too."""
    groups = -(-C // vec)
    tx = 1
    while tx < min(groups, 32):
        tx *= 2
    ty = THREADS // tx
    n_slices = -(-groups // tx)
    n_rb = max(1, min(MAX_ROW_BLOCKS, -(-TARGET_BLOCKS // n_slices),
                      -(-R // (MIN_ROWS_PER_THREAD * ty))))
    rb_rows = -(-R // n_rb)
    return tx, n_slices, -(-R // rb_rows), rb_rows


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """(forward, eval, backward) entry points with their C signatures;
    each ends in (R, C, vec, tx, n_slices, n_rb, rb_rows, ...floats, ...,
    stream)."""
    lib = build.load(KERNEL)
    p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
    plan = [i64, i, i, i, i, i, i64]
    fwd, ev, bwd = lib.ucd_abn_forward, lib.ucd_abn_eval, \
        lib.ucd_abn_backward
    fwd.argtypes = [p] * 8 + plan + [f, f, f, i, p]
    ev.argtypes = [p] * 7 + plan + [f, f, p]
    bwd.argtypes = [p] * 8 + plan + [f, i, p]
    for fn in (fwd, ev, bwd):
        fn.restype = ctypes.c_int
    return fwd, ev, bwd


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it: bf16, channels_last ([R, C] row-major)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused ABN kernels take bfloat16 activations, "
                        f"got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected an NCHW activation, got "
                         f"{tuple(x.shape)}")
    return x.contiguous(memory_format=torch.channels_last)


def _check_params(x, *per_channel):
    for t in per_channel:
        if t.dtype != torch.float32 or t.device != x.device \
                or t.shape != (x.shape[1],) or not t.is_contiguous():
            raise ValueError(f"the fused ABN kernels take contiguous float32 "
                             f"({x.shape[1]},) parameters and statistics on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _plan(*tensors):
    x = tensors[0]
    R, C = x.numel() // x.shape[1], x.shape[1]
    if R < 1:
        raise ValueError("the fused ABN kernels need at least one row")
    vec = 8 if C % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in tensors) else 1
    return (R, C, vec, *launch_plan(R, C, vec))


def _launched(err: int, what: str, counter: str) -> None:
    if err != 0:
        raise RuntimeError(f"{KERNEL} {what} launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        setattr(fused_abn, counter, getattr(fused_abn, counter) + 1)


def _on(device):
    # the launch goes to the thread's current device: switch only if needed
    return (contextlib.nullcontext()
            if device.index == torch.cuda.current_device()
            else torch.cuda.device(device))


def _forward_cuda(x, weight, bias, running_mean, running_var,
                  training: bool, update: bool, momentum: float, eps: float,
                  slope: float):
    x = _rows(x)
    _check_params(x, weight, bias, running_mean, running_var)
    y = torch.empty_like(x)
    stats = torch.empty((2, x.shape[1]), dtype=torch.float32,
                        device=x.device)
    plan = _plan(x, y)
    fwd, ev, _ = _kernel_fns()
    with _on(x.device):
        if training:
            part = torch.empty((2 * plan[5], plan[1]), dtype=torch.float32,
                               device=x.device)
            err = fwd(x.data_ptr(), y.data_ptr(), stats.data_ptr(),
                      part.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                      running_mean.data_ptr(), running_var.data_ptr(),
                      *plan, eps, slope, momentum, int(update),
                      build.stream(x.device))
        else:
            err = ev(x.data_ptr(), y.data_ptr(), stats.data_ptr(),
                     weight.data_ptr(), bias.data_ptr(),
                     running_mean.data_ptr(), running_var.data_ptr(), *plan,
                     eps, slope, build.stream(x.device))
    _launched(err, "forward" if training else "eval",
              "launches_fwd" if training else "launches_eval")
    return y, stats


def _backward_cuda(dy, x, weight, bias, stats, training: bool,
                   slope: float):
    x, dy = _rows(x), _rows(dy)
    _check_params(x, weight, bias)
    dx = torch.empty_like(x)
    dwb = torch.empty((2, x.shape[1]), dtype=torch.float32, device=x.device)
    plan = _plan(x, dy, dx)
    part = torch.empty((2 * plan[5] + 2, plan[1]), dtype=torch.float32,
                       device=x.device)
    _, _, bwd = _kernel_fns()
    with _on(x.device):
        err = bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  dwb.data_ptr(), part.data_ptr(), *plan, slope,
                  int(training), build.stream(x.device))
    _launched(err, "backward", "launches_bwd")
    return dx, dwb


# the operators: their names are what the profiler shows
_lib = torch.library.Library("ucd", "FRAGMENT")
_lib.define("batch_norm_act(Tensor x, Tensor weight, Tensor bias, "
            "Tensor(a!) running_mean, Tensor(b!) running_var, "
            "bool training, bool update, float momentum, float eps, "
            "float slope) -> (Tensor, Tensor)")
_lib.define("batch_norm_act_backward(Tensor dy, Tensor x, Tensor weight, "
            "Tensor bias, Tensor stats, bool training, float slope) "
            "-> (Tensor, Tensor)")
_lib.impl("batch_norm_act", batch_norm_act_plain, "CPU")
_lib.impl("batch_norm_act", _forward_cuda, "CUDA")
_lib.impl("batch_norm_act_backward", batch_norm_act_backward_plain, "CPU")
_lib.impl("batch_norm_act_backward", _backward_cuda, "CUDA")


class _FusedABN(torch.autograd.Function):
    """forward -> `ucd::batch_norm_act`, backward ->
    `ucd::batch_norm_act_backward`; saves x and (mean, invstd)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, training,
                update, momentum, eps, slope):
        y, stats = torch.ops.ucd.batch_norm_act(
            x, weight, bias, running_mean, running_var, training, update,
            momentum, eps, slope)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.training, ctx.slope = training, slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dwb = torch.ops.ucd.batch_norm_act_backward(
            dy, x, weight, bias, stats, ctx.training, ctx.slope)
        dw, db = ctx.needs_input_grad[1:3]
        return (dx, dwb[0] if dw else None, dwb[1] if db else None,
                None, None, None, None, None, None, None)


def fused_abn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor, *,
              training: bool, update: bool, momentum: float, eps: float,
              slope: float) -> torch.Tensor:
    """act(BatchNorm(x)) rounded once to x's dtype (the module docstring).
    A call that needs no gradient calls the operator alone."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_abn runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    args = (x, weight, bias, running_mean, running_var, bool(training),
            bool(update), float(momentum), float(eps), float(slope))
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _FusedABN.apply(*args)
    return torch.ops.ucd.batch_norm_act(*args)[0]


fused_abn.launches_fwd = 0
fused_abn.launches_eval = 0
fused_abn.launches_bwd = 0
fused_abn.bypassed = 0


def bypass() -> None:
    """Count an ABN call on a CUDA tensor that keeps the plain chain."""
    with _count_lock:
        fused_abn.bypassed += 1
