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
    zj = jnp.asarray(z, jnp.dtype(dtype))
    jgot = np.asarray(JFE.fused_argmax(zj, (H, W), interpret=True))
    z32 = np.array(zj.astype(jnp.float32))
    zt = torch.from_numpy(z32).to(getattr(torch, dtype))
    got = FE.fused_argmax(zt, (H, W)).numpy()
    zero = got == 0
    assert zero.any() and not zero.all()
    np.testing.assert_array_equal(zero, jgot == 0)
    # the window rule, not the bilinear taps, decides: rows, whole
    rows = FE.nan_rows(zt, (H, W)).numpy()
    np.testing.assert_array_equal(zero, np.broadcast_to(rows[:, :, None],
                                                        zero.shape))
    up = _up(z32, H, W)
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


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_inf_logits_differ_from_jax_inside_the_window(sign):
    """What the NaN rule leaves out (ROADMAP §C): an inf logit. The JAX
    kernel's width dot makes inf * 0 = NaN on every pixel of the inf's
    window that does not tap it with a positive weight, which become class
    0; the port follows F.interpolate there (finite values, their argmax).
    Both agree on every pixel outside the window and on the pixels that
    carry the inf (+inf: its class; -inf: the argmax of the rest)."""
    z = _separated(9)
    z[0, 3, 4, 2] = sign * np.inf
    H = W = 64
    got = _port(z, H, W)
    jgot = np.asarray(JFE.fused_argmax(jnp.asarray(z), (H, W),
                                       interpret=True))
    zn = z.copy()
    zn[0, 3, 4, 2] = np.nan
    window = np.broadcast_to(FE.nan_rows(torch.from_numpy(zn),
                                         (H, W)).numpy()[:, :, None],
                             got.shape)
    up = _up(z, H, W)
    carries = np.isinf(up[..., 2])
    assert carries.any() and (window & ~carries).any()
    np.testing.assert_array_equal(got[~window], jgot[~window])
    np.testing.assert_array_equal(got[carries], jgot[carries])
    if sign > 0:
        assert (got[carries] == 2).all()
    differ = window & ~carries
    assert (jgot[differ] == 0).all() and (got[differ] != 0).all()


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
