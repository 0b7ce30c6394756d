"""The plain stages of the port's tiled contrastive loss
(ucd_torch/ops/tiled_contrastive.py: pass1_plain, pass2_plain, bwd_plain and
the composed wrapper on CPU tensors) against the JAX package's Pallas
kernels run in interpret mode (ucd_tpu/ops/pallas_contrastive.py) and
against the dense losses of both packages, on the same numpy inputs.

The JAX side runs `_pallas_fwd` once per case (loss; residuals neg, num, G)
and `_pallas_bwd` on those residuals (dA), so each case costs three
interpreted kernels. Tolerances: f32 mode per-anchor sums and the loss rtol
1e-5, `num` exact, dA rtol 1e-4 + atol 1e-6 (the JAX package's own
kernel-vs-dense bounds); bf16 mode within 3e-2 (loss) / 5e-2 of the largest
gradient entry of the f32 dense loss (tests/test_pallas_contrastive.py) and
within 2e-3 / 2e-2 of the JAX bf16 kernel, whose rounding points the plain
stages share (features, probabilities and dL/dadc rounded to bf16; what is
left is the summation order and one-ulp bf16 flips of dL/dadc)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import both_batches, make_inputs
from ucd_torch.ops import contrastive as TCon
from ucd_torch.ops import tiled_contrastive as TT
from ucd_tpu.ops import contrastive as JCon
from ucd_tpu.ops import pallas_contrastive as JP

TAU = 0.07
CASES = {
    "random": (dict(C=9, max_label=8), 0),
    "nonaligned_P50_C7": (dict(H=20, W=20, h=5, w=5, N=8, C=7, max_label=6),
                          0),
    "ade_C151": (dict(B=1, C=151, max_label=150), 0),
    "capacity_100": (dict(N=8, C=9, max_label=8), 100),
}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def case(name, dtype=torch.float32):
    """(torch batch, jax batch, the JAX kernels' loss / neg / num / G / dA)
    of one case, computed once per process."""
    kw, capacity = CASES[name]
    bt, bj = both_batches(make_inputs(21, **kw), kw["max_label"])
    bt = TCon.compact_batch(bt, capacity)
    bj = JCon.compact_batch(bj, capacity)
    return (bt, bj) + jax_kernels(bj, dtype)


def jax_kernels(bj, dtype=torch.float32):
    jd = JAX_DTYPES[dtype]
    P = bj.anchor_feat.shape[0]
    loss, res = JP._pallas_fwd(bj, TAU, True, None, jd)
    _, neg, num, g, _ = res
    (grads,) = JP._pallas_bwd(TAU, True, None, jd, res, jnp.float32(1.0))
    return (float(loss), np.asarray(neg)[:P, 0], np.asarray(num)[:P, 0],
            np.asarray(g)[:P, 0], np.asarray(grads.anchor_feat))


def torch_loss_and_grad(fn, bt, *args):
    af = bt.anchor_feat.detach().requires_grad_(True)
    loss = fn(bt._replace(anchor_feat=af), *args)
    (g,) = torch.autograd.grad(loss, af)
    return loss.detach(), g


@pytest.mark.parametrize("name", list(CASES))
def test_plain_stages_match_pallas_kernels_f32(name):
    bt, bj, loss_j, neg_j, num_j, g_j, da_j = case(name)
    neg, num = TT.pass1_plain(bt, TAU)
    np.testing.assert_array_equal(num.numpy(), num_j)
    np.testing.assert_allclose(neg.numpy(), neg_j, rtol=1e-5)
    s, g = TT.pass2_plain(bt, neg, TAU)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-12)
    loss = TT.finish_loss(s, num)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert loss_j > 0 and (num_j > 0).any()
    coef = TT.backward_coef(num, torch.ones(()))
    da = TT.bwd_plain(bt, neg, g, coef, TAU)
    np.testing.assert_allclose(da.numpy(), da_j, rtol=1e-4, atol=1e-6)
    assert np.abs(da_j).max() > 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_on_cpu_is_the_composed_plain_version(name):
    """On CPU tensors `pixel_contrastive_loss_tiled` is the plain stages
    (same bits as `pixel_contrastive_loss_tiled_plain`), counts no launch,
    and agrees with the dense loss of both packages in value and gradient
    (rtol 1e-5; 1e-4 + atol 1e-6)."""
    bt, bj, loss_j, _, _, _, da_j = case(name)
    fn = TT.pixel_contrastive_loss_tiled
    before = (fn.launches_pass1, fn.launches_pass2, fn.launches_bwd)
    loss, g = torch_loss_and_grad(fn, bt, TAU)
    loss_p, g_p = torch_loss_and_grad(TT.pixel_contrastive_loss_tiled_plain,
                                      bt, TAU)
    assert (fn.launches_pass1, fn.launches_pass2, fn.launches_bwd) == before
    assert torch.equal(loss, loss_p) and torch.equal(g, g_p)
    loss_d, g_d = torch_loss_and_grad(TCon.pixel_contrastive_loss, bt, TAU)
    np.testing.assert_allclose(float(loss), float(loss_d), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_d.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), da_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        float(loss), float(JCon.pixel_contrastive_loss(bj, TAU)), rtol=1e-5)


def test_bf16_mode():
    """bf16 mode against the f32 dense loss (3e-2; 5e-2 of the largest
    gradient entry) and, tighter, against the JAX kernel's bf16 mode (2e-3;
    2e-2)."""
    bt, bj, loss_j, neg_j, num_j, g_j, da_j = case("random", torch.bfloat16)
    loss, g = torch_loss_and_grad(TT.pixel_contrastive_loss_tiled, bt, TAU,
                                  torch.bfloat16)
    loss_d, g_d = torch_loss_and_grad(TCon.pixel_contrastive_loss, bt, TAU)
    scale = float(g_d.abs().max())
    np.testing.assert_allclose(float(loss), float(loss_d), rtol=3e-2)
    assert float((g - g_d).abs().max()) / scale < 5e-2
    assert float(loss) != float(loss_d)      # the rounding is really there
    np.testing.assert_allclose(float(loss), loss_j, rtol=2e-3)
    assert np.abs(g.numpy() - da_j).max() / scale < 2e-2
    neg, num = TT.pass1_plain(bt, TAU, torch.bfloat16)
    np.testing.assert_array_equal(num.numpy(), num_j)
    np.testing.assert_allclose(neg.numpy(), neg_j, rtol=2e-3)
    _, g_row = TT.pass2_plain(bt, neg, TAU, torch.bfloat16)
    np.testing.assert_allclose(g_row.numpy(), g_j, rtol=2e-3, atol=1e-12)


def test_no_valid_anchors():
    """Background everywhere and an old model that agrees: no valid slot.
    Loss exactly 0, gradient exactly 0, on both sides."""
    f_n, labels, l_po, f_o = make_inputs(22)
    labels[:] = 0
    l_po[..., 0] += 40.0
    bt, bj = both_batches((f_n, labels, l_po, f_o), 5)
    assert not bt.anchor_valid.any()
    loss_j, neg_j, num_j, g_j, da_j = jax_kernels(bj)
    loss, g = torch_loss_and_grad(TT.pixel_contrastive_loss_tiled, bt, TAU)
    assert float(loss) == loss_j == 0.0
    assert not g.any() and not da_j.any()
    neg, num = TT.pass1_plain(bt, TAU)
    assert not neg.any() and not num.any() and not num_j.any()


def test_anchor_rows_without_positives_or_pairs():
    """One image is all background (rows with no valid pair) and some valid
    anchors have no positive: finite everywhere, those rows get a zero
    gradient, values match the dense loss."""
    f_n, labels, l_po, f_o = make_inputs(23, C=9, max_label=8, ignore=False)
    labels[0] = 0
    l_po[0, ..., 0] += 40.0
    bt, _ = both_batches((f_n, labels, l_po, f_o), 8)
    assert not bt.anchor_valid[:64].any() and bt.anchor_valid[64:].any()
    loss, g = torch_loss_and_grad(TT.pixel_contrastive_loss_tiled, bt, TAU)
    loss_d, g_d = torch_loss_and_grad(TCon.pixel_contrastive_loss, bt, TAU)
    assert torch.isfinite(g).all() and not g[:64].any()
    np.testing.assert_allclose(float(loss), float(loss_d), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_d.numpy(), rtol=1e-4, atol=1e-6)


def test_cotangent_and_float64():
    """The incoming cotangent scales dA (it travels as a tensor, no host
    read); float64 batches stay float64 on the CPU path and agree with the
    f64 dense loss to 1e-10."""
    bt = case("random")[0]
    af = bt.anchor_feat.detach().requires_grad_(True)
    loss = TT.pixel_contrastive_loss_tiled(bt._replace(anchor_feat=af), TAU)
    (g1,) = torch.autograd.grad(loss * 0.01, af, retain_graph=True)
    (g2,) = torch.autograd.grad(loss, af)
    # coef carries the cotangent into dL/dadc before its row sums: rounding
    # differs from scaling afterwards by ~1e-7 of the largest entry
    np.testing.assert_allclose(g1.numpy(), 0.01 * g2.numpy(), rtol=1e-5,
                               atol=1e-6 * 0.01 * float(g2.abs().max()))
    b64 = bt._replace(**{k: getattr(bt, k).detach().double() for k in (
        "anchor_feat", "contrast_feat", "anchor_prob", "contrast_prob")})
    l64, g64 = torch_loss_and_grad(TT.pixel_contrastive_loss_tiled, b64, TAU)
    d64, gd64 = torch_loss_and_grad(TCon.pixel_contrastive_loss, b64, TAU)
    assert l64.dtype == g64.dtype == torch.float64
    np.testing.assert_allclose(float(l64), float(d64), rtol=1e-10)
    np.testing.assert_allclose(g64.numpy(), gd64.numpy(), rtol=1e-8,
                               atol=1e-12)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    bt = case("random")[0]
    with pytest.raises(ValueError, match="compute_dtype"):
        TT.pixel_contrastive_loss_tiled(bt, TAU, torch.float16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TT.pixel_contrastive_loss_tiled(
            bt._replace(anchor_feat=bt.anchor_feat.to("meta")), TAU)
    with pytest.raises(ValueError, match="run on CUDA tensors"):
        TT.prepare(bt)
