"""Two edge cases the port's functional tests reach and the step tests did
not, held to the JAX package on the CPU:

* labels beyond the model's classes (a validate batch that holds a class
  the model has no head for yet): the dense losses take the JAX one-hot's
  0 for the missing logit, the plain version of the fused loss takes the
  last class, as both packages' kernels do;
* the dense path's bf16 upsample (`bf16_upsample` under the bf16 policy)
  on CPU tensors, which have no bf16 antialiased kernel: an upsample is
  plain bilinear, a downsample stays antialiased, as jax.image.resize."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucd_torch.models.segmentation import resize_bilinear
from ucd_torch.ops import fused_loss as TF
from ucd_torch.ops import losses as TL
from ucd_tpu.models.segmentation import resize_bilinear as jax_resize
from ucd_tpu.ops import fused_loss as JF
from ucd_tpu.ops import losses as JL

C = 5


def _labels(seed, shape):
    """Labels over [0, C + 2]: C and C + 1 are beyond the classes, with
    some 255 pixels."""
    rs = np.random.RandomState(seed)
    lab = rs.randint(0, C + 2, shape).astype(np.int32)
    lab[..., :2] = 255
    return lab


@pytest.mark.parametrize("loss", ["cross_entropy", "unbiased_cross_entropy"])
def test_dense_losses_take_the_jax_one_hot_beyond_the_classes(loss):
    rs = np.random.RandomState(3)
    z = rs.randn(2, 6, 6, C).astype(np.float32)
    lab = _labels(4, (2, 6, 6))
    kw = {"old_cl": 3} if loss == "unbiased_cross_entropy" else {}
    zt = torch.from_numpy(z).requires_grad_(True)
    got = getattr(TL, loss)(zt, torch.from_numpy(lab), **kw)
    (g,) = torch.autograd.grad(got, zt)
    want, gj = jax.value_and_grad(
        lambda zz: getattr(JL, loss)(zz, jnp.asarray(lab), **kw))(
            jnp.asarray(z))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("ce_mode,kd_mode", [("ce", "none"), ("unce", "kd")])
def test_fused_plain_takes_the_last_class_as_the_kernels(ce_mode, kd_mode):
    rs = np.random.RandomState(5)
    z = rs.randn(2, 4, 4, C).astype(np.float32)
    t = rs.randn(2, 4, 4, 3).astype(np.float32)
    lab = _labels(6, (2, 16, 16))
    kw = dict(old_cl=3, ce_mode=ce_mode, kd_mode=kd_mode)
    zt = torch.from_numpy(z).requires_grad_(True)
    lc, lk = TF.fused_ce_kd(zt, torch.from_numpy(lab), torch.from_numpy(t),
                            **kw)
    (g,) = torch.autograd.grad(lc + 2.5 * lk, zt)

    def total(zz):
        ce, kd = JF.fused_ce_kd(zz, jnp.asarray(lab), jnp.asarray(t),
                                interpret=True, **kw)
        return ce + 2.5 * kd, (ce, kd)

    (_, (jc, jk)), gj = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(z))
    np.testing.assert_allclose(float(lc.detach()), float(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(lk.detach()), float(jk), rtol=1e-5,
                               atol=1e-6)
    gj = np.asarray(gj)
    scale = np.abs(gj).max()
    np.testing.assert_allclose(g.numpy() / scale, gj / scale, rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("size,dtype", [((24, 20), "bfloat16"),
                                        ((24, 20), "float32"),
                                        ((6, 5), "float32")],
                         ids=["bf16_up", "f32_up", "f32_down"])
def test_resize_matches_jax(size, dtype):
    x = np.random.RandomState(7).randn(2, 8, 8, 3).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size,
                          dtype=tdt).permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(jax_resize(jnp.asarray(x), size,
                                 dtype=getattr(jnp, dtype)), np.float32)
    # bf16: one rounding of each side's f32-accumulated value
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
