"""ucd_torch.ops.fused_loss on CPU tensors (the plain version, which is
what the CUDA kernels are held against on the card) vs the JAX package's
Pallas kernels in interpret mode (`fused_ce_kd(interpret=True)`) AND its
dense oracle (`fused_ce_kd_dense`), on the same numpy inputs.

Tolerances are the JAX repo's own for its kernels (tests/test_fused_loss.py):
losses rtol 1e-5 / atol 1e-6; the gradient of ce + 2.5*kd (distinct weights,
so cross-wired cotangents cannot cancel) within 2e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucd_torch.ops import fused_loss as TF
from ucd_tpu.ops import fused_loss as JF

MODES = [("ce", "none"), ("ce", "kd"), ("ce", "unkd"),
         ("unce", "none"), ("unce", "kd"), ("unce", "unkd")]


def _case(seed, B, h, w, C, Co, H, W):
    rs = np.random.RandomState(seed)
    z = rs.randn(B, h, w, C).astype(np.float32)
    t = rs.randn(B, h, w, max(Co, 1)).astype(np.float32)
    lab = rs.randint(0, C + 1, (B, H, W)).astype(np.int32)
    lab[lab == C] = 255  # sprinkle ignore pixels
    return z, t, lab


def _torch_loss_and_grad(z, t, lab, **kw):
    zt = torch.from_numpy(z).requires_grad_(True)
    lc, lk = TF.fused_ce_kd(zt, torch.from_numpy(lab), torch.from_numpy(t),
                            **kw)
    (g,) = torch.autograd.grad(lc + 2.5 * lk, zt)
    return float(lc.detach()), float(lk.detach()), g.numpy()


def _assert_parity(z, t, lab, **kw):
    lc, lk, g = _torch_loss_and_grad(z, t, lab, **kw)
    jz, jt, jl = jnp.asarray(z), jnp.asarray(t), jnp.asarray(lab)
    for name, fn in (
            ("pallas", lambda zz: JF.fused_ce_kd(zz, jl, jt, interpret=True,
                                                 **kw)),
            ("dense", lambda zz: JF.fused_ce_kd_dense(zz, jl, jt, **kw))):
        def total(zz):
            ce, kd = fn(zz)
            return ce + 2.5 * kd, (ce, kd)

        (_, (jc, jk)), gj = jax.value_and_grad(total, has_aux=True)(jz)
        np.testing.assert_allclose(lc, float(jc), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(lk, float(jk), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        gj = np.asarray(gj)
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(g / scale, gj / scale, rtol=0, atol=2e-4,
                                   err_msg=name)
    # the two plain entry points agree with the wrapper on CPU tensors
    zt, tt, lt = (torch.from_numpy(a) for a in (z, t, lab))
    pc, pk = TF.fused_ce_kd_plain(zt, lt, tt, **kw)
    assert float(pc) == lc and float(pk) == lk
    pg = TF.fused_ce_kd_grad_plain(zt, lt, tt, ct_kd=2.5, **kw)
    np.testing.assert_array_equal(pg.numpy(), g)


@pytest.mark.parametrize("ce_mode,kd_mode", MODES)
def test_mode_matrix_voc_shape(ce_mode, kd_mode):
    z, t, lab = _case(0, B=2, h=4, w=4, C=17, Co=16, H=32, W=32)
    _assert_parity(z, t, lab, old_cl=(16 if ce_mode == "unce" else 0),
                   ce_mode=ce_mode, kd_mode=kd_mode)


def test_non_divisible_shape():
    z, t, lab = _case(1, B=2, h=4, w=4, C=11, Co=6, H=44, W=40)
    _assert_parity(z, t, lab, old_cl=6, ce_mode="unce", kd_mode="unkd")


def test_alpha_scaling():
    z, t, lab = _case(2, B=1, h=4, w=4, C=11, Co=6, H=32, W=32)
    _assert_parity(z, t, lab, old_cl=6, ce_mode="unce", kd_mode="unkd",
                   alpha=2.0)
    a1 = _torch_loss_and_grad(z, t, lab, old_cl=6, ce_mode="unce",
                              kd_mode="unkd", alpha=1.0)
    a2 = _torch_loss_and_grad(z, t, lab, old_cl=6, ce_mode="unce",
                              kd_mode="unkd", alpha=2.0)
    assert a1[0] == a2[0] and a1[1] != a2[1]  # alpha scales the old logits


def test_all_ignore_labels_give_zero_ce():
    z, t, _ = _case(3, B=1, h=4, w=4, C=11, Co=6, H=32, W=32)
    lab = np.full((1, 32, 32), 255, np.int32)
    lc, _, g = _torch_loss_and_grad(z, t, lab, old_cl=6, ce_mode="unce",
                                    kd_mode="none")
    assert lc == 0.0 and not g.any()


def test_supported_gates():
    for fn in (TF.supported, JF.supported):
        assert fn((2, 4, 4, 11), (2, 32, 32), "unce", "unkd")
        assert not fn((2, 64, 4, 11), (2, 32, 32), "unce", "unkd")  # down
        assert not fn((2, 4, 4, 11), (2, 32, 32), "bce", "none")


def test_gradient_goes_to_the_new_logits_only():
    z, t, lab = _case(4, B=1, h=4, w=4, C=11, Co=6, H=16, W=16)
    zt = torch.from_numpy(z).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    lc, lk = TF.fused_ce_kd(zt, torch.from_numpy(lab), tt, old_cl=6,
                            ce_mode="unce", kd_mode="unkd")
    gz, gt = torch.autograd.grad(lc + lk, (zt, tt), allow_unused=True)
    assert gz is not None and gz.abs().max() > 0
    assert gt is None
    # each cotangent is honoured on its own
    g_ce = torch.autograd.grad(TF.fused_ce_kd(
        zt, torch.from_numpy(lab), tt, old_cl=6, ce_mode="unce",
        kd_mode="unkd")[0], zt)[0]
    g_kd = torch.autograd.grad(TF.fused_ce_kd(
        zt, torch.from_numpy(lab), tt, old_cl=6, ce_mode="unce",
        kd_mode="unkd")[1], zt)[0]
    torch.testing.assert_close(g_ce + g_kd, gz, rtol=1e-5, atol=1e-8)
    assert not torch.allclose(g_ce, g_kd)


def test_label_dtypes_and_bad_modes():
    z, t, lab = _case(5, B=1, h=4, w=4, C=11, Co=6, H=16, W=16)
    zt, tt = torch.from_numpy(z), torch.from_numpy(t)
    kw = dict(old_cl=6, ce_mode="unce", kd_mode="unkd")
    want = TF.fused_ce_kd(zt, torch.from_numpy(lab), tt, **kw)
    for dt in (torch.uint8, torch.int64):
        got = TF.fused_ce_kd(zt, torch.from_numpy(lab).to(dt), tt, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="old_cl"):
        TF.fused_ce_kd(zt, torch.from_numpy(lab), tt, old_cl=0,
                       ce_mode="unce")
    with pytest.raises(ValueError, match="old_logits_lr"):
        TF.fused_ce_kd(zt, torch.from_numpy(lab), None, kd_mode="kd")
    with pytest.raises(ValueError, match="unknown mode"):
        TF.fused_ce_kd(zt, torch.from_numpy(lab), tt, ce_mode="bce")
    assert TF.fused_ce_kd.launches_fwd == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("n_in,n_out", [(4, 32), (13, 100), (17, 132),
                                        (32, 512), (16, 16), (5, 7)])
def test_tap_ranges_cover_every_tap(n_in, n_out):
    """The backward kernel's host plan: each source index's output range is
    contiguous, holds every output that taps it (clamped edge taps too), and
    the weights gathered over the ranges are the interpolation matrix's
    column sums (what the JAX row plan folds)."""
    from ucd_torch.ops.fused_eval import taps

    identity = n_in == n_out
    i0, i1, frac = taps(n_in, n_out, identity)
    lo, hi = TF.tap_ranges(n_in, n_out, identity)
    col = np.zeros(n_in)
    for i in range(n_in):
        assert 0 <= lo[i] < hi[i] <= n_out
        inside = np.arange(lo[i], hi[i])
        hit = np.where((i0 == i) | (i1 == i))[0]
        assert set(hit) <= set(inside)
        col[i] = sum((1 - frac[o]) * (i0[o] == i) + frac[o] * (i1[o] == i)
                     for o in inside)
    np.testing.assert_allclose(col, JF.interp_matrix(n_out, n_in).sum(0),
                               rtol=1e-5, atol=1e-6)
