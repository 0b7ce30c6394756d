"""ucd_torch.ops.losses vs ucd_tpu.ops.losses: the five dense losses the
ported train step uses, values and gradients, on the same numpy inputs.

Tolerance: both sides compute in f32 with different summation orders;
values agree to rtol 1e-5 / atol 1e-6 and gradients to 1e-5 of their
largest entry (atol 1e-9 for the all-zero rows of ignored pixels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucd_torch.ops import losses as TL
from ucd_tpu.ops import losses as JL

B, H, W, C, CO = 2, 12, 10, 9, 6


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    z = (rs.randn(B, H, W, C) * 2).astype(np.float32)
    t = (rs.randn(B, H, W, CO) * 2).astype(np.float32)
    lab = rs.randint(0, C, (B, H, W)).astype(np.int32)
    lab[0, :3, :4] = 255
    return z, t, lab


def _compare(torch_fn, jax_fn, z):
    zt = torch.from_numpy(z).requires_grad_(True)
    vt = torch_fn(zt)
    (gt,) = torch.autograd.grad(vt, zt)
    vj, gj = jax.value_and_grad(jax_fn)(jnp.asarray(z))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5,
                               atol=1e-6)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=1e-5 * np.abs(gj).max() + 1e-9)


def test_cross_entropy():
    z, _, lab = _inputs()
    lt = torch.from_numpy(lab)
    _compare(lambda x: TL.cross_entropy(x, lt),
             lambda x: JL.cross_entropy(x, jnp.asarray(lab)), z)
    # mean over ALL pixels: ignored ones count in the denominator
    per_px = TL.cross_entropy(torch.from_numpy(z), lt, reduction="none")
    assert (per_px[0, :3, :4] == 0).all()
    np.testing.assert_allclose(
        float(TL.cross_entropy(torch.from_numpy(z), lt)),
        float(per_px.sum()) / (B * H * W), rtol=1e-6)
    np.testing.assert_allclose(
        float(TL.cross_entropy(torch.from_numpy(z), lt, reduction="sum")),
        float(JL.cross_entropy(jnp.asarray(z), jnp.asarray(lab),
                               reduction="sum")), rtol=1e-5)


@pytest.mark.parametrize("old_cl", [1, 6, 9])
def test_unbiased_cross_entropy(old_cl):
    z, _, lab = _inputs(1)
    lt = torch.from_numpy(lab)
    _compare(lambda x: TL.unbiased_cross_entropy(x, lt, old_cl),
             lambda x: JL.unbiased_cross_entropy(x, jnp.asarray(lab),
                                                 old_cl), z)


@pytest.mark.parametrize("alpha", [1.0, 2.0])
@pytest.mark.parametrize("name", ["knowledge_distillation",
                                  "unbiased_knowledge_distillation"])
def test_distillation(name, alpha):
    z, t, _ = _inputs(2)
    tt = torch.from_numpy(t)
    _compare(lambda x: getattr(TL, name)(x, tt, alpha=alpha),
             lambda x: getattr(JL, name)(x, jnp.asarray(t), alpha=alpha), z)
    mask = (np.random.RandomState(3).rand(B, H, W) > 0.5)
    _compare(lambda x: getattr(TL, name)(x, tt, alpha=alpha,
                                         mask=torch.from_numpy(mask)),
             lambda x: getattr(JL, name)(x, jnp.asarray(t), alpha=alpha,
                                         mask=jnp.asarray(mask)), z)


def test_feature_distillation():
    rs = np.random.RandomState(4)
    a = rs.randn(2, 4, 4, 16).astype(np.float32)
    b = rs.randn(2, 4, 4, 16).astype(np.float32)
    _compare(lambda x: TL.feature_distillation(x, torch.from_numpy(b)),
             lambda x: JL.feature_distillation(x, jnp.asarray(b)), a)


def test_labels_as_uint8_and_nchw_views():
    """uint8 labels give the same bits as int labels; a permuted NCHW view
    gives the value of the contiguous NHWC tensor (to 1e-6: the mean runs
    over another memory order)."""
    z, t, lab = _inputs(5)
    zt, lt = torch.from_numpy(z), torch.from_numpy(lab)
    view = zt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    for fn in (lambda x, y: TL.cross_entropy(x, y),
               lambda x, y: TL.unbiased_cross_entropy(x, y, 6)):
        want = fn(zt, lt)
        assert torch.equal(fn(zt, lt.to(torch.uint8)), want)
        torch.testing.assert_close(fn(view, lt), want, rtol=1e-6, atol=0)


def test_bf16_logits_are_cast_to_f32():
    z, t, lab = _inputs(6)
    zb = torch.from_numpy(z).bfloat16()
    got = TL.cross_entropy(zb, torch.from_numpy(lab))
    assert got.dtype == torch.float32
    want = JL.cross_entropy(jnp.asarray(z).astype(jnp.bfloat16),
                            jnp.asarray(lab))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
