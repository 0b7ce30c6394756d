"""The port's contrastive batch construction and dense loss
(ucd_torch/ops/contrastive.py) against the JAX package's
(ucd_tpu/ops/contrastive.py) on the same numpy inputs, small shapes, CPU.

Tolerances: everything integer or boolean (interpolated labels, batch
labels, validity, is-new, compaction) is exact; features and probabilities
rtol 1e-6 (a norm and a softmax summed in another order); the dense loss
rtol 1e-5 and its gradient rtol 1e-4 + atol 1e-6, the bounds the JAX
package holds its own kernel to (tests/test_pallas_contrastive.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import both_batches, make_inputs
from ucd_torch.ops import contrastive as TCon
from ucd_tpu.ops import contrastive as JCon

TAU = 0.07
FIELDS_EXACT = ("anchor_label", "contrast_label", "anchor_valid",
                "contrast_valid", "anchor_is_new", "contrast_is_new")
FIELDS_FLOAT = ("anchor_feat", "contrast_feat", "anchor_prob",
                "contrast_prob")


def block_labels(seed, B, H, W, max_label, dtype=np.uint8):
    """Labels with spatial structure (blocks of one class, a 255 frame and
    a 255 rectangle), as a dataset's are."""
    rs = np.random.RandomState(seed)
    low = rs.randint(0, max_label + 1, size=(B, 4, 5))
    lab = np.repeat(np.repeat(low, -(-H // 4), axis=1), -(-W // 5), axis=2)
    lab = lab[:, :H, :W].astype(dtype)
    lab[:, :2] = lab[:, -2:] = 255
    lab[:, :, :2] = lab[:, :, -2:] = 255
    lab[:, H // 3:H // 2, W // 4:W // 2] = 255
    return lab


def assert_batches_equal(bt, bj):
    for name in FIELDS_EXACT:
        got, want = getattr(bt, name).numpy(), np.asarray(getattr(bj, name))
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in FIELDS_FLOAT:
        np.testing.assert_allclose(
            getattr(bt, name).detach().numpy(),
            np.asarray(getattr(bj, name)), rtol=1e-6, atol=1e-7,
            err_msg=name)


@pytest.mark.parametrize("in_hw,out_hw", [((32, 32), (8, 8)),
                                          ((50, 50), (7, 7)),
                                          ((20, 36), (5, 9)),
                                          ((64, 48), (4, 3)),
                                          ((8, 8), (8, 8)),
                                          ((7, 5), (16, 12))])
def test_interpolate_bilinear_bit_equal(in_hw, out_hw):
    """Same float32 bits as the JAX function (same operation order), at
    integer and non-integer ratios, down and up."""
    x = np.random.RandomState(1).randn(2, *in_hw).astype(np.float32) * 50
    want = np.asarray(JCon.interpolate_bilinear(jnp.array(x), *out_hw))
    got = TCon.interpolate_bilinear(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,W,h,w", [(32, 32, 8, 8), (50, 50, 7, 7),
                                     (64, 64, 4, 4), (33, 47, 5, 6)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_downsample_labels_exact(H, W, h, w, dtype):
    """Truncation toward zero after the float interpolation, 255 mixed into
    the averages and zeroed only where it lands above max_label: exact
    equality on block-structured and on per-pixel random labels."""
    for labels in (block_labels(2, 3, H, W, 20, dtype),
                   make_inputs(3, B=3, H=H, W=W, max_label=20,
                               label_dtype=dtype)[1]):
        assert (labels == 255).any()
        want = np.asarray(JCon.downsample_labels(jnp.array(labels), (h, w),
                                                 20))
        got = TCon.downsample_labels(torch.from_numpy(labels), (h, w), 20)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.max() <= 20 and got.min() >= 0


@pytest.mark.parametrize("case", ["random", "blocks_uint8", "nonaligned",
                                  "ade_width"])
def test_build_contrastive_batch_matches_jax(case):
    kw = {"random": dict(),
          "blocks_uint8": dict(label_dtype=np.uint8),
          "nonaligned": dict(H=50, W=50, h=7, w=7, N=8, C=7, max_label=6),
          "ade_width": dict(B=1, C=151, max_label=150)}[case]
    inputs = make_inputs(4, **kw)
    if case == "blocks_uint8":
        inputs = (inputs[0], block_labels(5, 2, 32, 32, 5), *inputs[2:])
    bt, bj = both_batches(inputs, kw.get("max_label", 5))
    assert_batches_equal(bt, bj)
    assert bt.anchor_valid.any() and bt.anchor_is_new.any()
    assert not bt.contrast_feat.requires_grad


def test_batch_without_new_pixels():
    """No GT-new pixel: min_new is int32 max, so no slot is marked new; the
    pseudo-labels alone decide validity."""
    f_n, _, l_po, f_o = make_inputs(6)
    for fill in (0, 255):
        labels = np.full((2, 32, 32), fill, np.uint8)
        bt, bj = both_batches((f_n, labels, l_po, f_o), 5)
        assert_batches_equal(bt, bj)
        assert not bt.anchor_is_new.any() and bt.anchor_valid.any()
        loss = TCon.pixel_contrastive_loss(bt, TAU)
        np.testing.assert_allclose(
            float(loss), float(JCon.pixel_contrastive_loss(bj, TAU)),
            rtol=1e-5)


def test_pseudo_label_takes_the_first_maximum():
    """Exact ties in the old logits: the first maximal class wins, as
    jnp.argmax has it."""
    f_n, labels, l_po, f_o = make_inputs(7)
    labels[:] = 0
    l_po[0, 0, 0, :] = 1.0                       # all classes tied -> 0
    l_po[0, 1, 2, 2] = l_po[0, 1, 2, 4] = 9.0    # 2 and 4 tied -> 2
    l_po[1, 3, 3, 5] = l_po[1, 3, 3, 1] = 9.0    # 1 and 5 tied -> 1
    bt, bj = both_batches((f_n, labels, l_po, f_o), 5)
    lab = bt.anchor_label.reshape(2, 8, 8)
    assert (int(lab[0, 0, 0]), int(lab[0, 1, 2]), int(lab[1, 3, 3])) == (
        0, 2, 1)
    assert_batches_equal(bt, bj)
    x = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0], [0.0, -1.0, 5.0]])
    assert TCon.first_argmax(x).tolist() == [1, 0, 2]


@pytest.mark.parametrize("capacity,few_valid", [(100, False), (40, True),
                                                (0, False), (128, False)])
def test_compact_batch_exact(capacity, few_valid):
    """The first `capacity` valid slots in order, padding rows zeroed and
    masked out; every field bit-equal to the JAX compaction of the same
    batch."""
    inputs = make_inputs(8, C=9, max_label=8)
    if few_valid:   # fewer valid anchors than the capacity: padding rows
        inputs[1][:] = 0
        inputs[2][..., 0] += 12.0
        inputs[2][0, :3, :4, 0] -= 30.0
    bt, bj = both_batches(inputs, 8)
    n_valid = int(bt.anchor_valid.sum())
    ct, cj = TCon.compact_batch(bt, capacity), JCon.compact_batch(bj, capacity)
    P = capacity if 0 < capacity < 128 else 128
    assert ct.anchor_feat.shape[0] == P and ct.contrast_feat.shape[0] == 2 * P
    if few_valid:
        assert 0 < n_valid < capacity
        assert int(ct.anchor_valid.sum()) == n_valid
        assert not ct.anchor_feat[n_valid:].any()
    for name in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)), name)
    for name in FIELDS_FLOAT:
        # a gather of values already compared: same tolerance, and the
        # compaction itself adds no rounding
        np.testing.assert_allclose(getattr(ct, name).detach().numpy(),
                                   np.asarray(getattr(cj, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if 0 < capacity < 128:
            idx = torch.nonzero(bt.anchor_valid).squeeze(1)[:capacity]
            # the anchor half of either set, gathered in order
            np.testing.assert_array_equal(
                getattr(ct, name)[:len(idx)].detach().numpy(),
                getattr(bt, name)[idx].detach().numpy())
    # anchor i's self-pair is still contrast column i
    np.testing.assert_array_equal(ct.contrast_feat[:P].numpy(),
                                  ct.anchor_feat.detach().numpy())


def _dense_loss_and_grad_jax(bj, bug):
    return jax.value_and_grad(lambda af: JCon.pixel_contrastive_loss(
        bj._replace(anchor_feat=af), TAU, bug_compatible=bug))(
            bj.anchor_feat)


def _dense_loss_and_grad_torch(bt, bug):
    af = bt.anchor_feat.detach().requires_grad_(True)
    loss = TCon.pixel_contrastive_loss(bt._replace(anchor_feat=af), TAU,
                                       bug_compatible=bug)
    (g,) = torch.autograd.grad(loss, af)
    return loss.detach(), g


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("case", ["random", "nonaligned", "compacted"])
def test_dense_loss_and_gradient_match_jax(case, bug):
    kw = dict(H=20, W=20, h=5, w=5, N=8, C=7, max_label=6) \
        if case == "nonaligned" else dict(C=9, max_label=8)
    bt, bj = both_batches(make_inputs(9, **kw), kw["max_label"])
    if case == "compacted":
        bt, bj = TCon.compact_batch(bt, 100), JCon.compact_batch(bj, 100)
    lj, gj = _dense_loss_and_grad_jax(bj, bug)
    lt, gt = _dense_loss_and_grad_torch(bt, bug)
    assert float(lj) > 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(np.asarray(gj)).max() > 1e-4


def test_dense_gradient_finite_with_invalid_anchor_rows():
    """A whole image of background: its anchor rows have no valid pair; the
    loss and the gradient stay finite and match (the row-max clamp)."""
    f_n, labels, l_po, f_o = make_inputs(10, C=9, max_label=8, ignore=False)
    labels[0] = 0
    l_po[0, ..., 0] += 40.0     # and the old model says background there
    bt, bj = both_batches((f_n, labels, l_po, f_o), 8)
    assert not bt.anchor_valid[:64].any() and bt.anchor_valid[64:].any()
    for bug in (False, True):
        lj, gj = _dense_loss_and_grad_jax(bj, bug)
        lt, gt = _dense_loss_and_grad_torch(bt, bug)
        assert torch.isfinite(gt).all() and np.isfinite(float(lt))
        assert not gt[:64].any()
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-6)
    # no valid anchor at all: loss exactly 0, zero gradient
    labels[:] = 0
    l_po[..., 0] += 40.0
    bt, _ = both_batches((f_n, labels, l_po, f_o), 8)
    assert not bt.anchor_valid.any()
    lt, gt = _dense_loss_and_grad_torch(bt, False)
    assert float(lt) == 0.0 and not gt.any()


@pytest.mark.parametrize("capacity,bug", [(0, False), (100, False),
                                          (0, True)])
def test_ucd_contrastive_loss_end_to_end(capacity, bug):
    """build -> compact -> dense loss, value and gradient w.r.t. f_n (rtol
    1e-5 / 1e-4 + atol 1e-6); gradient reaches f_n only."""
    f_n, labels, l_po, f_o = make_inputs(11, C=9, max_label=8,
                                         label_dtype=np.uint8)
    kw = dict(max_label=8, temperature=TAU, capacity=capacity,
              bug_compatible=bug)
    lj, gj = jax.value_and_grad(lambda f: JCon.ucd_contrastive_loss(
        f, jnp.array(labels), jnp.array(l_po), jnp.array(f_o), **kw))(
            jnp.array(f_n))
    tf_n = torch.from_numpy(f_n).requires_grad_(True)
    tf_o = torch.from_numpy(f_o).requires_grad_(True)
    tl_po = torch.from_numpy(l_po).requires_grad_(True)
    lt = TCon.ucd_contrastive_loss(tf_n, torch.from_numpy(labels), tl_po,
                                   tf_o, **kw)
    g_n, g_o, g_l = torch.autograd.grad(lt, (tf_n, tf_o, tl_po),
                                        allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(g_n.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-6)
    assert float(g_n.abs().sum()) > 0
    assert g_o is None and g_l is None   # contrast set and JM are detached


def test_kernel_path_with_bug_compatible_raises():
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="bug_compatible"):
        TCon.ucd_contrastive_loss(f, torch.zeros(1, 16, 16, dtype=torch.int32),
                                  torch.zeros(1, 4, 4, 5), f, max_label=5,
                                  use_pallas=True, bug_compatible=True)
    from ucd_torch import config
    with pytest.raises(ValueError, match="no_pallas"):
        config.make_config(dataset="voc", task="15-5s", step=1, method="UCD",
                           contrastive_bug_compatible=True)


def test_float64_features_stay_float64():
    """float64 is the port's test-only dtype: features and probabilities
    keep it (the JAX functions cast to float32), labels do not depend on
    it."""
    f_n, labels, l_po, f_o = make_inputs(12)
    b32 = TCon.build_contrastive_batch(
        torch.from_numpy(f_n), torch.from_numpy(labels),
        torch.from_numpy(l_po), torch.from_numpy(f_o), 5)
    b64 = TCon.build_contrastive_batch(
        torch.from_numpy(f_n).double(), torch.from_numpy(labels),
        torch.from_numpy(l_po).double(), torch.from_numpy(f_o).double(), 5)
    assert b64.anchor_feat.dtype == b64.anchor_prob.dtype == torch.float64
    for name in FIELDS_EXACT:
        assert torch.equal(getattr(b32, name), getattr(b64, name)), name
    l32 = TCon.pixel_contrastive_loss(b32, TAU)
    l64 = TCon.pixel_contrastive_loss(b64, TAU)
    assert l64.dtype == torch.float64
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-5)
