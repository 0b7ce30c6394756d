"""The fused ABN chain (ucd_torch/ops/fused_abn.py): its plain version, the
one the CPU runs and the card's kernels are held to, against the plain
chain of models/layers.py `ABN`; the routing rule; the operators' names
in the profiler; the launch plan of the kernels."""

import copy
import re

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from ucd_torch.models.layers import ABN, remat_contexts
from ucd_torch.ops import build
from ucd_torch.ops import fused_abn as FA

# the `abn.ms_per_step` reader's operator pattern (benchmark/metrics/)
ABN_OPS = r"batch_norm|leaky_relu|_to_copy|aten::copy_"
CELL_SHAPES = [(64, 65536), (64, 16384), (128, 16384), (128, 4096),
               (256, 16384), (256, 4096), (256, 1024), (512, 4096),
               (512, 1024), (1024, 1024), (2048, 1024)]


def _abn(channels, activation, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    abn = ABN(channels, activation=activation, dtype=dtype)
    wide = abn.wide
    with torch.no_grad():
        abn.bn.weight.copy_(torch.rand(channels, generator=g) + 0.5)
        abn.bn.bias.copy_(torch.randn(channels, generator=g) * 0.3)
        abn.bn.running_mean.copy_(torch.randn(channels, generator=g) * 0.1)
        abn.bn.running_var.copy_(torch.rand(channels, generator=g) + 0.5)
    assert abn.bn.weight.dtype == wide
    return abn


def _inputs(shape, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g, dtype=torch.float64) * 2 + 0.7
    dy = torch.randn(*shape, generator=g, dtype=torch.float64)
    fmt = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=fmt).requires_grad_(True),
            dy.to(dtype).contiguous(memory_format=fmt))


def _fused(abn, x):
    """The plain version through the operators and their autograd, with
    the running statistics moved as `ABN._fused` moves them."""
    return abn._fused(x)


def _both(shape, dtype, activation, training):
    """(plain chain, fused plain version): output, dx, dW, dB and the
    module after the call, from the same module and inputs."""
    ref = _abn(shape[1], activation, dtype)
    ref.train(training)
    fused = copy.deepcopy(ref)
    x, dy = _inputs(shape, dtype)
    out = []
    for abn, fn in ((ref, lambda m, t: m(t)), (fused, _fused)):
        y = fn(abn, x)
        grads = torch.autograd.grad(y, (x, abn.bn.weight, abn.bn.bias), dy)
        out.append((y.detach(), *grads, abn))
    return out


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _bf16_ulps(a, b):
    """Largest |a - b| in bf16 units of the larger magnitude (8
    significant bits), with a floor of 2**-20 of the largest value for the
    f32 rounding of the values that cancel to near 0."""
    a, b = a.detach().double(), b.detach().double()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    floor = 2.0 ** -20 * float(mag.max())
    return float(((a - b).abs() / (ulp + floor)).max())


MODES = [(act, tr) for act in ("leaky_relu", "identity")
         for tr in (True, False)]


@pytest.mark.parametrize("activation,training", MODES)
def test_plain_version_matches_abn_f64(activation, training):
    """At f64 the fused plain version equals the plain chain to 1e-12:
    output, dx, dW, dB and the running statistics."""
    (y0, dx0, dw0, db0, m0), (y1, dx1, dw1, db1, m1) = _both(
        (3, 16, 5, 7), torch.float64, activation, training)
    for a, b in ((y1, y0), (dx1, dx0), (dw1, dw0), (db1, db0),
                 (m1.bn.running_mean, m0.bn.running_mean),
                 (m1.bn.running_var, m0.bn.running_var)):
        assert _rel(a, b) <= 1e-12
    assert int(m1.bn.num_batches_tracked) == int(m0.bn.num_batches_tracked) \
        == int(training)


@pytest.mark.parametrize("activation,training", MODES)
def test_plain_version_matches_abn_bf16(activation, training):
    """bf16 in and out, f32 inside: the output and dx within one bf16
    unit of the plain chain's, dW, dB and the running statistics to f32
    rounding."""
    (y0, dx0, dw0, db0, m0), (y1, dx1, dw1, db1, m1) = _both(
        (4, 32, 6, 6), torch.bfloat16, activation, training)
    assert y1.dtype == dx1.dtype == torch.bfloat16
    assert dw1.dtype == db1.dtype == torch.float32
    assert _bf16_ulps(y1, y0) <= 1.0
    assert _bf16_ulps(dx1, dx0) <= 1.0
    assert _rel(dw1, dw0) <= 1e-5 and _rel(db1, db0) <= 1e-5
    assert _rel(m1.bn.running_mean, m0.bn.running_mean) <= 1e-6
    assert _rel(m1.bn.running_var, m0.bn.running_var) <= 1e-6


@pytest.mark.parametrize("shape", [(2, 8, 1, 1), (1, 64, 1, 2),
                                   (3, 24, 1, 1), (2, 40, 3, 1)],
                         ids=["c8-r2", "c64-r2", "c24-r3", "c40-r6"])
def test_plain_version_matches_abn_at_few_rows(shape):
    """Channels 8-64 at 2-6 rows a channel, train mode, bf16."""
    (y0, dx0, dw0, db0, m0), (y1, dx1, dw1, db1, m1) = _both(
        shape, torch.bfloat16, "leaky_relu", True)
    assert _bf16_ulps(y1, y0) <= 1.0 and _bf16_ulps(dx1, dx0) <= 1.0
    assert _rel(dw1, dw0) <= 1e-5 and _rel(db1, db0) <= 1e-5
    assert _rel(m1.bn.running_var, m0.bn.running_var) <= 1e-6


def test_one_row_normalizes_to_the_bias():
    """One row a channel (which torch's train-mode BatchNorm refuses): the
    variance is 0, the output act(b), dx 0, dB dy and dW 0."""
    abn = _abn(16, "leaky_relu", torch.float64)
    rm, rv = abn.bn.running_mean.clone(), abn.bn.running_var.clone()
    x, dy = _inputs((1, 16, 1, 1), torch.float64)
    y = _fused(abn, x)
    b = abn.bn.bias.detach()
    assert torch.equal(y.flatten(), torch.where(b > 0, b, 0.01 * b))
    dx, dw, db = torch.autograd.grad(y, (x, abn.bn.weight, abn.bn.bias), dy)
    g = dy.flatten()
    assert float(dx.abs().max()) <= 1e-12 and float(dw.abs().max()) == 0
    assert torch.equal(db, torch.where(b > 0, g, g * 0.01))
    # the running mean moves towards the row, the variance towards 0
    assert torch.allclose(abn.bn.running_mean,
                          rm.lerp(x.detach().flatten(), 0.1))
    assert torch.allclose(abn.bn.running_var, rv * 0.9)
    assert float(abn.bn.num_batches_tracked) == 1


class _Block(torch.nn.Module):
    def __init__(self, abn, fused):
        super().__init__()
        self.abn, self.fused = abn, fused

    def forward(self, x):
        return _fused(self.abn, x) if self.fused else self.abn(x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["f64", "bf16"])
def test_remat_moves_the_statistics_once(dtype):
    """Under a rematerialized block (forward, then the recompute in the
    backward) the fused path moves the running statistics and
    num_batches_tracked once, as the plain chain does, with the same
    gradient."""
    ref = _abn(24, "leaky_relu", dtype)
    fused = copy.deepcopy(ref)
    x, dy = _inputs((2, 24, 4, 3), dtype)
    got = []
    for abn, use in ((ref, False), (fused, True)):
        block = _Block(abn, use)
        y = checkpoint(block, x, use_reentrant=False,
                       context_fn=remat_contexts)
        (dx,) = torch.autograd.grad(y, x, dy)
        got.append((dx, abn.bn))
    (dx0, bn0), (dx1, bn1) = got
    assert int(bn0.num_batches_tracked) == int(bn1.num_batches_tracked) == 1
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert _rel(bn1.running_mean, bn0.running_mean) <= tol
    assert _rel(bn1.running_var, bn0.running_var) <= tol
    if dtype == torch.float64:
        assert _rel(dx1, dx0) <= 1e-12
    else:
        assert _bf16_ulps(dx1, dx0) <= 1.0


BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
# (x dtype, compute dtype, norm, norm_dtype, activation) of the main path
MAIN = (BF16, BF16, "bn", None, "leaky_relu")
ROUTES = {
    # (device, x dtype, compute dtype, norm, norm_dtype, activation,
    #  training, distributed) -> fused?
    "cuda bf16 leaky train": (("cuda", *MAIN, True, False), True),
    "cuda bf16 leaky eval": (("cuda", *MAIN, False, False), True),
    "cuda bf16 identity": (("cuda", BF16, BF16, "bn", None, "identity",
                            True, False), True),
    "cuda bf16 wide f32 norm_dtype": (("cuda", BF16, BF16, "bn", F32,
                                       "leaky_relu", True, False), True),
    "cuda process group eval": (("cuda", *MAIN, False, True), True),
    "cuda process group train": (("cuda", *MAIN, True, True), False),
    "cpu bf16": (("cpu", *MAIN, True, False), False),
    "cuda f32": (("cuda", F32, F32, "bn", None, "leaky_relu", True, False),
                 False),
    "cuda f64": (("cuda", F64, F64, "bn", None, "identity", False, False),
                 False),
    "cuda bf16 into an f32 model": (("cuda", BF16, F32, "bn", None,
                                     "leaky_relu", True, False), False),
    "cuda bf16_norm": (("cuda", BF16, BF16, "bn", BF16, "leaky_relu", True,
                        False), False),
    "cuda groupnorm": (("cuda", BF16, BF16, "gn", None, "leaky_relu", True,
                        False), False),
    "cuda elu": (("cuda", BF16, BF16, "bn", None, "elu", True, False),
                 False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_rule(case):
    args, fused = ROUTES[case]
    assert FA.routes(*args) is fused


def test_cpu_abn_keeps_the_plain_chain_and_counts_nothing():
    """On the CPU every ABN takes the plain chain: no launch, no bypass
    counted (only CUDA calls are)."""
    before = (FA.fused_abn.launches_fwd, FA.fused_abn.launches_eval,
              FA.fused_abn.launches_bwd, FA.fused_abn.bypassed)
    (y0, *_), (y1, *_) = _both((2, 8, 3, 3), torch.bfloat16, "leaky_relu",
                               True)
    after = (FA.fused_abn.launches_fwd, FA.fused_abn.launches_eval,
             FA.fused_abn.launches_bwd, FA.fused_abn.bypassed)
    assert after == before


def test_profiler_names_the_operators():
    """A profiled forward and backward show the operators
    `ucd::batch_norm_act` and `ucd::batch_norm_act_backward`, which the
    `abn.ms_per_step` pattern matches, and no user-annotation range of
    them (one would lie on the device's rows and count as busy)."""
    from torch.profiler import ProfilerActivity, profile

    abn = _abn(8, "leaky_relu", torch.bfloat16)
    x, dy = _inputs((2, 8, 4, 4), torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = _fused(abn, x)
        y.backward(dy)
    names = {e.name for e in prof.events()}
    ours = {"ucd::batch_norm_act", "ucd::batch_norm_act_backward"}
    assert ours <= names, sorted(names)
    assert all(re.search(ABN_OPS, n) for n in ours)
    assert not [e.name for e in prof.events()
                if getattr(e, "is_user_annotation", False)
                and "batch_norm_act" in e.name]


@pytest.mark.parametrize("vec", [8, 1])
def test_launch_plan_covers_every_row_once(vec):
    """At the train cells' 11 ABN shapes (batch 24) and at a few rows:
    the chunks cover the rows (none empty), the slices the channels, and
    the block's thread rows are a power of two for the kernels' trees."""
    shapes = [(c, 24 * hw) for c, hw in CELL_SHAPES] + [
        (8, 1), (64, 2), (24, 3), (2048, 24), (3, 5), (1, 1)]
    for C, R in shapes:
        tx, n_slices, n_rb, rb_rows = FA.launch_plan(R, C, vec)
        groups = -(-C // vec)
        assert tx & (tx - 1) == 0 and 1 <= tx <= 32
        assert (FA.THREADS // tx) & (FA.THREADS // tx - 1) == 0
        assert n_slices * tx >= groups > (n_slices - 1) * tx
        assert 1 <= n_rb <= FA.MAX_ROW_BLOCKS
        assert (n_rb - 1) * rb_rows < R <= n_rb * rb_rows


def test_kernel_source_exports_the_entry_points():
    """The wrapper's three entry points are the source's C interface."""
    assert FA.KERNEL in build.kernel_sources()
    src = (build.CSRC / f"{FA.KERNEL}.cu").read_text()
    for name in ("ucd_abn_forward", "ucd_abn_eval", "ucd_abn_backward"):
        assert re.search(rf'extern "C" int {name}\(', src), name
