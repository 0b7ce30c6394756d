"""ucd_torch/ops/fused_eval.py against the JAX package's fused argmax.

On the CPU the port's `fused_argmax` runs its plain PyTorch version; it is
held against the JAX Pallas kernel (interpret mode) and the JAX dense
oracle with the near-tie rule of tests/test_fused_eval.py: mismatches only
where the top-2 gap is below 1e-4 (f32) or 0.08 (bf16) and at a rate
below 1e-3 (f32) or 2e-2 (bf16). The tap tables the CUDA kernel reads are
checked here through a numpy emulation of the kernel's arithmetic; the
kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import assert_argmax_close
from ucd_torch.ops import fused_eval as FE
from ucd_tpu.models.segmentation import resize_bilinear as jax_resize
from ucd_tpu.ops import fused_eval as JFE


def _up(z, H, W):
    return np.asarray(jax_resize(jnp.asarray(z), (H, W), dtype=jnp.float32))


def _port(z, H, W):
    return FE.fused_argmax(torch.from_numpy(np.ascontiguousarray(z)),
                           (H, W)).numpy()


def _check(z, H, W, gap_tol=1e-4, rate_tol=1e-3):
    got = _port(z, H, W)
    assert got.dtype == np.int32 and got.shape == (z.shape[0], H, W)
    up = _up(z, H, W)
    assert_argmax_close(got, np.asarray(JFE.fused_argmax_dense(
        jnp.asarray(z), (H, W))), up, gap_tol, rate_tol)
    assert_argmax_close(got, np.asarray(JFE.fused_argmax(
        jnp.asarray(z), (H, W), interpret=True)), up, gap_tol, rate_tol)
    return got


@pytest.mark.parametrize("C", [21, 151])
def test_random_logits_parity(C):
    z = np.random.RandomState(0).randn(2, 8, 8, C).astype(np.float32)
    _check(z, 128, 128)


def test_non_multiple_shapes():
    z = np.random.RandomState(1).randn(1, 13, 17, 21).astype(np.float32)
    _check(z, 100, 132)


def test_identity_resolution():
    z = np.random.RandomState(2).randn(1, 16, 16, 5).astype(np.float32)
    got = _check(z, 16, 16)
    np.testing.assert_array_equal(got, z.argmax(-1))


def test_separated_logits_exact():
    rng = np.random.RandomState(3)
    lab = rng.randint(0, 21, (2, 8, 8))
    z = np.full((2, 8, 8, 21), -10.0, np.float32)
    np.put_along_axis(z, lab[..., None], 10.0, axis=-1)
    z = z + rng.randn(2, 8, 8, 21).astype(np.float32) * 0.01
    got = _port(z, 64, 64)
    np.testing.assert_array_equal(got, np.asarray(JFE.fused_argmax_dense(
        jnp.asarray(z), (64, 64))))
    np.testing.assert_array_equal(got, np.asarray(JFE.fused_argmax(
        jnp.asarray(z), (64, 64), interpret=True)))


def test_exact_ties_take_first_class():
    """Classes 3 and 7 equal at every source pixel and above the rest:
    class 3 everywhere, in the port and in both JAX paths."""
    z = np.random.RandomState(12).randn(2, 8, 8, 21).astype(np.float32)
    z[..., 3] = z[..., 7] = z.max(-1) + 1.0
    np.testing.assert_array_equal(_port(z, 64, 64), 3)
    np.testing.assert_array_equal(np.asarray(JFE.fused_argmax(
        jnp.asarray(z), (64, 64), interpret=True)), 3)
    np.testing.assert_array_equal(np.asarray(JFE.fused_argmax_dense(
        jnp.asarray(z), (64, 64))), 3)


def test_bf16_input():
    """bf16 logits: the port interpolates the bf16 values in f32, so it
    matches the JAX dense oracle (f32 upsample of the same values) under
    the f32 tie rule, and the JAX kernel's bf16 interpolation under the
    bf16 rule."""
    z = jnp.asarray(np.random.RandomState(4).randn(1, 8, 8, 21),
                    jnp.bfloat16)
    z32 = np.array(z.astype(jnp.float32))
    got = FE.fused_argmax(torch.from_numpy(z32).to(torch.bfloat16),
                          (96, 96)).numpy()
    up = _up(z32, 96, 96)
    assert_argmax_close(got, np.asarray(JFE.fused_argmax_dense(z, (96, 96))),
                        up)
    assert_argmax_close(got, np.asarray(JFE.fused_argmax(
        z, (96, 96), interpret=True)), up, gap_tol=0.08, rate_tol=0.02)


def _separated(seed, B=2, h=8, w=8, C=5):
    """Random logits whose class 0 never wins on its own (-10), so that
    every class-0 pixel of either package comes from the NaN rule."""
    z = np.random.RandomState(seed).randn(B, h, w, C).astype(np.float32)
    z[..., 0] = -10.0
    return z


NAN_CASES = {"full source pixel": (0, 2, 3, slice(None)),
             "one class value": (1, 5, 1, 2),
             "row edge": (1, 0, 7, 4)}


def _jax_and_port(z, H, W, dtype):
    """(JAX kernel in interpret mode, port) ids of the same values in
    `dtype`, and the port's input tensor."""
    zj = jnp.asarray(z, jnp.dtype(dtype))
    jgot = np.asarray(JFE.fused_argmax(zj, (H, W), interpret=True))
    z32 = np.array(zj.astype(jnp.float32))
    zt = torch.from_numpy(z32).to(getattr(torch, dtype))
    return jgot, FE.fused_argmax(zt, (H, W)).numpy(), zt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(NAN_CASES))
def test_nan_pixels_stay_in_class_range(case, dtype):
    """A NaN in the logits gives class 0 to exactly the pixels the JAX
    kernel (interpret mode) gives class 0: every pixel of the output rows
    whose tile's 3-row source window holds the NaN (its width dot spreads
    0 * NaN along the rows), in f32 and in bf16 (classes padded to 16
    there). All other pixels follow the near-tie rule; ids stay in range."""
    z = _separated(7)
    z[NAN_CASES[case]] = np.nan
    H = W = 64
    jgot, got, zt = _jax_and_port(z, H, W, dtype)
    zero = got == 0
    assert zero.any() and not zero.all()
    np.testing.assert_array_equal(zero, jgot == 0)
    # the window rule, not the bilinear taps, decides: rows, whole
    nan_px = np.isnan(FE.jax_pattern(zt, (H, W)).numpy()).any(-1)
    np.testing.assert_array_equal(zero, nan_px)
    np.testing.assert_array_equal(nan_px, np.broadcast_to(
        nan_px.any(2, keepdims=True), nan_px.shape))
    up = _up(zt.float().numpy(), H, W)
    bf16 = dtype == "bfloat16"
    assert_argmax_close(got[~zero], jgot[~zero], up[~zero],
                        0.08 if bf16 else 1e-4, 2e-2 if bf16 else 1e-3)
    for g in (got, jgot):
        assert g.min() >= 0 and g.max() < z.shape[-1]


def test_all_nan_logits_give_class_zero():
    z_all = np.full((1, 4, 4, 5), np.nan, np.float32)
    np.testing.assert_array_equal(_port(z_all, 8, 8), 0)
    np.testing.assert_array_equal(np.asarray(JFE.fused_argmax(
        jnp.asarray(z_all), (8, 8), interpret=True)), 0)


def _inf_case(name):
    """Logits of `_separated(9)` with the case's infs (and NaN), and the
    output size."""
    z = _separated(9)
    if name == "+inf interior":
        z[0, 3, 4, 2] = np.inf
    elif name == "-inf interior":
        z[0, 3, 4, 2] = -np.inf
    elif name == "+inf row 0, first column":  # clamped edges: duplicated
        z[0, 0, 0, 2] = np.inf                # slots of weight 0
    elif name == "-inf row 0, last column":
        z[1, 0, 7, 3] = -np.inf
    elif name == "+inf last row, last column":
        z[1, 7, 7, 4] = np.inf
    elif name == "+inf and -inf in one row":  # NaN in their window
        z[0, 3, 4, 2] = np.inf
        z[0, 3, 1, 2] = -np.inf
    elif name == "+inf in two classes":       # the first wins
        z[0, 3, 4, 4] = np.inf
        z[0, 3, 4, 2] = np.inf
    elif name == "+inf in two classes, two columns":
        z[0, 3, 4, 4] = np.inf
        z[0, 3, 5, 1] = np.inf
    elif name == "all -inf":
        return np.full((1, 4, 4, 5), -np.inf, np.float32), (8, 8)
    elif name == "one image all -inf":
        z[1] = -np.inf
    elif name == "NaN and inf":
        z[0, 2, 3, :] = np.nan
        z[1, 5, 5, 1] = np.inf
    return z, (64, 64)


INF_CASES = ["+inf interior", "-inf interior", "+inf row 0, first column",
             "-inf row 0, last column", "+inf last row, last column",
             "+inf and -inf in one row", "+inf in two classes",
             "+inf in two classes, two columns", "all -inf",
             "one image all -inf", "NaN and inf"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", INF_CASES)
def test_nonfinite_pixels_match_jax(case, dtype):
    """±inf and NaN: on every pixel where the JAX kernel's upsampled
    logits hold a non-finite class (`jax_pattern`), the port's id equals
    the JAX kernel's (interpret mode) exactly, in f32 and bf16; elsewhere
    the near-tie rule holds. The plain version's pattern is the JAX
    kernel's: +inf wins where it is the only non-finite value of a pixel,
    and its window rows reach beyond the bilinear taps."""
    z, (H, W) = _inf_case(case)
    jgot, got, zt = _jax_and_port(z, H, W, dtype)
    pattern = FE.jax_pattern(zt, (H, W)).numpy()
    nonfinite = ~np.isfinite(pattern).all(-1)
    assert nonfinite.any()
    np.testing.assert_array_equal(got[nonfinite], jgot[nonfinite])
    up = _up(zt.float().numpy(), H, W)
    bf16 = dtype == "bfloat16"
    ok = ~nonfinite
    assert_argmax_close(got[ok], jgot[ok], up[ok], 0.08 if bf16 else 1e-4,
                        2e-2 if bf16 else 1e-3)
    if case == "+inf in two classes":
        carries = np.isposinf(pattern).any(-1) & ~np.isnan(pattern).any(-1)
        assert carries.any() and (got[carries] == 2).all()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_inf_logits_differ_from_jax_inside_the_window(sign):
    """An inf logit: the JAX kernel's width dot makes inf * 0 = NaN on every
    pixel of the inf's window that does not tap it with a positive weight
    (class 0 there), and inf where only positive weights meet it. The port
    once followed F.interpolate inside that window (hence this test's
    name); it now equals the JAX kernel on every pixel of the window, and
    on the pixels that carry the inf takes its class (+inf) or the argmax
    of the rest (-inf)."""
    z = _separated(9)
    z[0, 3, 4, 2] = sign * np.inf
    H = W = 64
    jgot, got, zt = _jax_and_port(z, H, W, "float32")
    zn = z.copy()
    zn[0, 3, 4, 2] = np.nan
    window = np.isnan(FE.jax_pattern(torch.from_numpy(zn), (H, W)).numpy()
                      ).any(-1)
    pattern = FE.jax_pattern(zt, (H, W)).numpy()[..., 2]
    carries = np.isinf(pattern)
    assert carries.any() and (window & ~carries).any()
    assert (window >= carries).all()
    np.testing.assert_array_equal(got, jgot)
    if sign > 0:
        assert (got[carries] == 2).all()
    assert (got[window & ~carries] == 0).all()


@pytest.mark.parametrize("lowres,out", [
    ((1, 8, 8, 21), (128, 128)), ((1, 8, 8, 21), (8, 8)),
    ((1, 16, 16, 21), (8, 8)), ((2, 13, 17, 3), (100, 16)),
    ((2, 13, 17, 3), (12, 132))])
def test_supported_gate(lowres, out):
    assert FE.supported(lowres, out) == JFE.supported(lowres, out)


def test_cpu_runs_plain_version_and_never_counts():
    """A CPU tensor takes the plain version and leaves the launch count
    alone; a tensor on neither CPU nor CUDA is refused."""
    z = torch.randn(1, 4, 4, 3)
    before = FE.fused_argmax.launches
    out = FE.fused_argmax(z, (8, 8))
    assert FE.fused_argmax.launches == before
    assert torch.equal(out, FE.fused_argmax_plain(z, (8, 8)))
    with pytest.raises(ValueError):
        FE.fused_argmax(torch.empty(1, 4, 4, 3, device="meta"), (8, 8))


def _emulate_kernel(z, H, W):
    """numpy emulation of csrc/fused_argmax.cu's per-pixel arithmetic over
    the tap tables the wrapper uploads."""
    B, h, w, C = z.shape
    identity = (h, w) == (H, W)
    iy0, iy1, fy = FE.taps(h, H, identity)
    ix0, ix1, fx = FE.taps(w, W, identity)
    ly, lx = fy[None, :, None, None], fx[None, None, :, None]
    hy, hx = np.float32(1) - ly, np.float32(1) - lx
    g = lambda iy, ix: z[:, iy][:, :, ix]           # noqa: E731
    up = hy * (hx * g(iy0, ix0) + lx * g(iy0, ix1)) + \
        ly * (hx * g(iy1, ix0) + lx * g(iy1, ix1))
    return up


@pytest.mark.parametrize("hw,out", [((8, 8), (128, 128)),
                                    ((13, 17), (100, 132)),
                                    ((32, 32), (512, 512)),
                                    ((16, 16), (16, 16)),
                                    ((4, 4), (8, 8))])
def test_kernel_taps_reproduce_interpolate(hw, out):
    """The kernel's taps give F.interpolate's values (to f32 rounding) and
    put NaN on exactly the same pixels."""
    rng = np.random.RandomState(11)
    z = rng.randn(1, *hw, 4).astype(np.float32)
    z[0, 1, 2, 1] = np.nan
    got = _emulate_kernel(z, *out)
    want = F.interpolate(torch.from_numpy(z).permute(0, 3, 1, 2), size=out,
                         mode="bilinear", align_corners=False)
    want = want.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                               equal_nan=True)


PLAN_SHAPES = [(8, 64, 8, 64, 5, False), (13, 100, 17, 132, 21, False),
               (32, 512, 32, 512, 21, True), (16, 16, 16, 16, 5, False),
               (4, 8, 4, 8, 151, False), (5, 7, 6, 9, 3, False)]


@pytest.mark.parametrize("h,H,w,W,C,bf16", PLAN_SHAPES)
def test_argmax_plan_covers_taps_and_windows(h, H, w, W, C, bf16):
    """The kernel's host tables: its row cells cover the output rows once,
    in order, and every row of a cell taps the cell's two source rows; the
    window span of a cell is exactly the union of its rows' JAX windows;
    the slots and their positive-weight bits are the JAX tile plan's
    (`_pick_to`, `_row_plan`), and the positive columns of each output
    column are the nonzero entries of the JAX interpolation matrix."""
    from ucd_tpu.ops import fused_loss as JF

    rows, yplan, fy, xplan, fx, max_rows = FE.argmax_plan(h, H, w, W, C,
                                                          bf16)
    identity = (h, w) == (H, W)
    iy0, iy1, fy_want = FE.taps(h, H, identity)
    first, end, src0, src1, rlo, rhi = rows[:, :6].T
    assert first[0] == 0 and end[-1] == H and (first[1:] == end[:-1]).all()
    cell = np.repeat(np.arange(len(rows)), end - first)
    np.testing.assert_array_equal(iy0, src0[cell])
    np.testing.assert_array_equal(iy1, src1[cell])
    np.testing.assert_array_equal(fy, fy_want)
    slots = yplan[:, :3]
    Cp = -(-C // (16 if bf16 else 8)) * (16 if bf16 else 8)
    To = JF._pick_to(H, h, W, Cp, 0)
    _, _, W3 = JF._row_plan(H, h, To)
    t = np.arange(H) // To
    want_slots = np.clip(np.array([JF._lo_min(tt, To, h, H) for tt in t]
                                  )[:, None] + np.arange(3), 0, h - 1)
    np.testing.assert_array_equal(slots, want_slots)
    np.testing.assert_array_equal(yplan[:, 3],
                                  ((W3[:H] > 0) * [1, 2, 4]).sum(1))
    for k in range(len(rows)):
        span = slots[first[k]:end[k]]
        assert (rlo[k], rhi[k]) == (span.min(), span.max())
        assert set(np.unique(span)) == set(range(rlo[k], rhi[k] + 1))
    assert max_rows == (rhi - rlo).max() + 1
    ix0, ix1, fx_want = FE.taps(w, W, identity)
    np.testing.assert_array_equal(xplan[:, 0], ix0)
    np.testing.assert_array_equal(xplan[:, 1], ix1)
    np.testing.assert_array_equal(fx, fx_want)
    A = JF.interp_matrix(W, w)
    for x in range(W):
        got = sorted(c for c in xplan[x, 2:] if c >= 0)
        assert got == list(np.flatnonzero(A[x] > 0)), x


def _emulate_argmax_kernel(z, H, W):
    """numpy emulation of csrc/fused_argmax.cu over the host's tables, block
    by block: the window span's finite test; the fast path's width lerp
    `top + ly * (bottom - top)` and first maximum; the slow path's tally
    per (window row, class) and the JAX rule from the slot bits and the
    positive columns."""
    B, h, w, C = z.shape
    rows, yplan, fy, xplan, fx, _ = FE.argmax_plan(h, H, w, W, C, False)
    out = np.zeros((B, H, W), np.int32)
    lx = fx[:, None]
    for b in range(B):
        for first, end, s0, s1, rlo, rhi, _, _ in rows:
            span = z[b, rlo:rhi + 1]
            if np.isfinite(span).all():
                top = (1 - lx) * z[b, s0, xplan[:, 0]] + lx * z[b, s0,
                                                              xplan[:, 1]]
                bot = (1 - lx) * z[b, s1, xplan[:, 0]] + lx * z[b, s1,
                                                              xplan[:, 1]]
                for y in range(first, end):
                    out[b, y] = (top + fy[y] * (bot - top)).argmax(-1)
                continue
            nan = np.isnan(span).any(1)                      # (rows, C)
            npos, nneg = np.isposinf(span).sum(1), np.isneginf(span).sum(1)
            for y in range(first, end):
                for x in range(W):
                    ly = fy[y]
                    fin = ((1 - ly) * ((1 - fx[x]) * z[b, s0, xplan[x, 0]]
                                       + fx[x] * z[b, s0, xplan[x, 1]])
                           + ly * ((1 - fx[x]) * z[b, s1, xplan[x, 0]]
                                   + fx[x] * z[b, s1, xplan[x, 1]]))
                    v = fin.astype(np.float64)
                    for c in range(C):
                        bad = pos = neg = anyj = False
                        for j in range(3):
                            r = yplan[y, j] - rlo
                            if not (nan[r, c] or npos[r, c] or nneg[r, c]):
                                continue
                            anyj = True
                            vals = [z[b, rlo + r, col, c]
                                    for col in xplan[x, 2:] if col >= 0]
                            kp = sum(v_ == np.inf for v_ in vals)
                            kn = sum(v_ == -np.inf for v_ in vals)
                            dot_nan = (nan[r, c] or npos[r, c] > kp
                                       or nneg[r, c] > kn or (kp and kn))
                            if dot_nan or not (yplan[y, 3] >> j) & 1:
                                bad = True
                            else:
                                pos |= kp > 0
                                neg |= kn > 0
                        if anyj:
                            v[c] = (np.nan if bad or (pos and neg)
                                    else np.inf if pos else -np.inf)
                    out[b, y, x] = 0 if np.isnan(v).any() else v.argmax()
    return out


@pytest.mark.filterwarnings("ignore:invalid value encountered")
@pytest.mark.parametrize("case", ["+inf interior", "-inf row 0, last column",
                                  "+inf row 0, first column",
                                  "+inf and -inf in one row",
                                  "+inf in two classes", "all -inf",
                                  "NaN and inf"])
def test_kernel_rule_emulation_matches_jax(case):
    """The kernel's own algorithm (emulated in numpy over the tables the
    wrapper uploads) gives the JAX kernel's ids on every non-finite pixel,
    and the near-tie rule elsewhere."""
    z, (H, W) = _inf_case(case)
    if case != "all -inf":
        z = z[:, :4]  # fewer source rows: the slow path is a Python loop
        H = 32
    got = _emulate_argmax_kernel(z, H, W)
    jgot = np.asarray(JFE.fused_argmax(jnp.asarray(z), (H, W),
                                       interpret=True))
    nonfinite = ~np.isfinite(FE.jax_pattern(torch.from_numpy(z), (H, W))
                             .numpy()).all(-1)
    assert nonfinite.any()
    np.testing.assert_array_equal(got[nonfinite], jgot[nonfinite])
    ok = ~nonfinite
    assert_argmax_close(got[ok], jgot[ok], _up(z, H, W)[ok])
