"""The host side of the tensor-core variant of the port's tiled contrastive
kernels (ucd_torch/ops/tiled_contrastive.py): the bf16 layout with its zero
padding, the split of the walk over M with its fixed-order sum, the ring
depth and the variant table. The kernels themselves only run on the card;
what surrounds them runs here on CPU tensors, and the padded bf16 batch goes
through the plain stages against the JAX package's Pallas kernels in
interpret mode (ucd_tpu/ops/pallas_contrastive.py, bf16 mode).

Tolerances: a widened 2-byte value equals `_rounded` bit for bit; padding
with zero columns and invalid slots leaves pass 2 and the backward within
rtol 1e-6 (+ 1e-7 of the largest entry: only the order of the matrix
product's sum may move); the parts of a split walk add up to the unsplit
result within rtol 1e-5 (f32 sums in another order) and to the same bits
every time; against the JAX bf16 kernel 2e-3 (loss, per-anchor sums) and
2e-2 of the largest gradient entry, as tests/test_torch_tiled_contrastive.py
holds the unpadded plain stages."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import both_batches, make_inputs
from ucd_torch.ops import contrastive as TCon
from ucd_torch.ops import tiled_contrastive as TT
from ucd_tpu.ops import pallas_contrastive as JP

TAU = 0.07
BF16 = torch.bfloat16
# name -> make_inputs arguments; P = B h w slots, M = 2 P
SHAPES = {
    "C7_D8_P50": dict(H=20, W=20, h=5, w=5, N=8, C=7, max_label=6),
    "C151": dict(B=1, C=151, max_label=150),
    "D300": dict(B=1, N=300, C=9, max_label=8),
    "aligned_P256_D16_C16": dict(B=4, N=16, C=16, max_label=15),
}


@functools.lru_cache(maxsize=None)
def batches(name):
    kw = SHAPES[name]
    return both_batches(make_inputs(31, **kw), kw["max_label"])


def batch(name):
    return batches(name)[0]


def slots_of(bt):
    return (bt.anchor_label, bt.anchor_valid.view(torch.uint8),
            bt.anchor_is_new.view(torch.uint8), bt.contrast_label,
            bt.contrast_valid.view(torch.uint8),
            bt.contrast_is_new.view(torch.uint8))


def layout(bt, **kw):
    return TT.bf16_layout(bt.anchor_feat, bt.anchor_prob, bt.contrast_feat,
                          bt.contrast_prob, slots_of(bt), **kw)


def padded_batch(ops):
    """The padded operands as a batch of float32 tensors: what the
    tensor-core kernels see."""
    la, av, an, lc, cv, cn = ops.slots
    return TCon.ContrastiveBatch(
        anchor_feat=ops.af.float(), contrast_feat=ops.cf.float(),
        anchor_label=la, contrast_label=lc, anchor_valid=av.bool(),
        contrast_valid=cv.bool(), anchor_prob=ops.ap.float(),
        contrast_prob=ops.cp.float(), anchor_is_new=an.bool(),
        contrast_is_new=cn.bool())


def rows(bt):
    """neg, num, G and coef of the plain stages in bf16 mode."""
    neg, num = TT.pass1_plain(bt, TAU, BF16)
    _, g = TT.pass2_plain(bt, neg, TAU, BF16)
    return neg, num, g, TT.backward_coef(num, torch.ones(()))


def pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, n - x.shape[0]))


@pytest.mark.parametrize("name", list(SHAPES))
def test_layout_values_are_the_rounded_values(name):
    """The 2-byte operands widened are `_rounded(...)` bit for bit, so the
    kernels and the plain versions multiply the same numbers; everything
    beyond the true shape is zero, every padded slot invalid."""
    bt = batch(name)
    ops = layout(bt)
    P, M, D, C = ops.dims
    assert (P, D) == tuple(bt.anchor_feat.shape)
    assert (M, C) == tuple(bt.contrast_prob.shape)
    Pp, Dp = ops.af.shape
    Mp, Cp = ops.cp.shape
    assert Pp % 256 == 0 and Mp % 64 == 0 and Dp % 16 == 0 and Cp % 16 == 0
    assert Pp - P < 256 and Mp - M < 64 and Dp - D < 16 and Cp - C < 16
    assert ops.ap.shape == (Pp, Cp) and ops.cf.shape == (Mp, Dp)
    for got, src, n, k in ((ops.af, bt.anchor_feat, P, D),
                           (ops.ap, bt.anchor_prob, P, C),
                           (ops.cf, bt.contrast_feat, M, D),
                           (ops.cp, bt.contrast_prob, M, C)):
        assert got.dtype == BF16 and got.is_contiguous()
        assert torch.equal(got[:n, :k].float(),
                           TT._rounded(src.detach(), BF16))
        assert not got[n:].any() and not got[:, k:].any()
    for got, src, n in zip(ops.slots, slots_of(bt), (P, P, P, M, M, M)):
        assert got.dtype == src.dtype and got.is_contiguous()
        assert torch.equal(got[:n], src) and not got[n:].any()
    if name.startswith("aligned"):
        # nothing to pad: the slot arrays are handed over as they are
        assert (Pp, Mp, Dp, Cp) == (P, M, D, C)
        assert all(a.data_ptr() == b.data_ptr()
                   for a, b in zip(ops.slots, slots_of(bt)))


@pytest.mark.parametrize("stage", ["pass1", "pass2", "bwd"])
@pytest.mark.parametrize("name", ["C7_D8_P50", "C151", "D300"])
def test_padding_changes_no_result(name, stage):
    """pass1_plain, pass2_plain and bwd_plain on the padded batch (zero
    columns of D and C, invalid slots beyond P and M) equal the unpadded
    result on the true rows and columns (`num` exactly); padded anchors get
    neg = num = S = G = 0 and a zero gradient."""
    bt = batch(name)
    ops = layout(bt)
    P, M, D, C = ops.dims
    big = padded_batch(ops)
    assert big.anchor_feat.shape != bt.anchor_feat.shape \
        or big.anchor_prob.shape != bt.anchor_prob.shape
    neg, num, g, coef = rows(bt)
    Pp = big.anchor_feat.shape[0]
    if stage == "pass1":
        want = TT.pass1_plain(bt, TAU, BF16)
        got = TT.pass1_plain(big, TAU, BF16)
        assert torch.equal(got[1][:P], want[1])
    elif stage == "pass2":
        want = TT.pass2_plain(bt, neg, TAU, BF16)
        got = TT.pass2_plain(big, pad_rows(neg, Pp), TAU, BF16)
    else:
        want = (TT.bwd_plain(bt, neg, g, coef, TAU, BF16),)
        got = (TT.bwd_plain(big, pad_rows(neg, Pp), pad_rows(g, Pp),
                            pad_rows(coef, Pp), TAU, BF16),)
    for x, y in zip(got, want):
        assert float(y.abs().max()) > 0
        assert not x[P:].any()
        if stage == "bwd":
            assert not x[:, D:].any()
            x = x[:, :D]
        np.testing.assert_allclose(
            x[:P].numpy(), y.numpy(), rtol=1e-6,
            atol=1e-7 * float(y.abs().max()))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_split_walk_sums_to_the_unsplit_result(parts):
    """The walk over M in `parts` ranges of whole tiles: each part's neg,
    num, S, G and dA (the plain stages with the other parts' slots invalid)
    added by `sum_parts` give the unsplit result (`num` exactly: integer
    counts), and the same bits twice."""
    bt = batch("C151")
    tile = 16                         # M = 128: 8 tiles of 16 slots here
    M = bt.contrast_feat.shape[0]
    n_tiles = M // tile
    parts = TT.m_parts(1, n_tiles, 132, parts)
    per_part = -(-n_tiles // parts)
    neg, num, g, coef = rows(bt)

    def partials():
        out = [[] for _ in range(5)]
        for k in range(parts):
            inside = torch.zeros(M, dtype=torch.bool)
            inside[k * per_part * tile:(k + 1) * per_part * tile] = True
            part = bt._replace(contrast_valid=bt.contrast_valid & inside)
            for acc, x in zip(out, (
                    *TT.pass1_plain(part, TAU, BF16),
                    *TT.pass2_plain(part, neg, TAU, BF16),
                    TT.bwd_plain(part, neg, g, coef, TAU, BF16))):
                acc.append(x)
        return [TT.sum_parts(torch.stack(x)) for x in out]

    once, twice = partials(), partials()
    assert all(torch.equal(a, b) for a, b in zip(once, twice))
    assert torch.equal(once[1], num)
    s, gg = TT.pass2_plain(bt, neg, TAU, BF16)
    da = TT.bwd_plain(bt, neg, g, coef, TAU, BF16)
    for got, want in zip(once[:1] + once[2:], (neg, s, gg, da)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


def test_sum_parts_adds_first_to_last():
    """((p0 + p1) + p2) + p3 in float32, not a pairwise or a widened sum."""
    x = torch.tensor([[1.0], [2.0 ** -24], [2.0 ** -24], [-1.0]])
    assert float(TT.sum_parts(x)) == 0.0            # the small terms are lost
    assert float(TT.sum_parts(x.flip(0))) == 2.0 ** -23
    one = torch.randn(1, 5, 3)
    assert TT.sum_parts(one).data_ptr() == one.data_ptr()  # no copy, no add


@pytest.mark.parametrize("row_blocks,n_tiles,asked,want", [
    (64, 256, None, 2),       # the backward at batch 8: 128 blocks
    (32, 256, None, 4),       # pass 2 (256 anchors a block) at batch 8
    (128, 512, None, 1),      # the backward at batch 16: one wave already
    (16, 64, None, 8),
    (1, 2, None, 2),          # never a part without a tile
    (1, 1, None, 1),
    (1, 5, 4, 3),             # 4 asked: 2 tiles per part -> 3 parts
    (64, 256, 4, 4),
    (1, 1000, None, TT.MMA_MAX_PARTS),
])
def test_m_parts(row_blocks, n_tiles, asked, want):
    got = TT.m_parts(row_blocks, n_tiles, 132, asked)
    assert got == want
    per_part = -(-n_tiles // got)
    assert (got - 1) * per_part < n_tiles <= got * per_part


@pytest.mark.parametrize("D,C,tile_a,want", [
    (256, 16, 128, 4),        # the train shape: 73728 + 4 x 37248 bytes
    (256, 16, 64, 4),
    (256, 0, 256, 2),         # pass 1: no probabilities, 16 warps
    (256, 0, 128, 4),
    (256, 160, 128, 2),       # ADE's 151 probabilities
    (304, 16, 128, 3),
    (16, 16, 128, 4),
])
def test_ring_stages(D, C, tile_a, want):
    assert TT.ring_stages(D, C, tile_a) == want
    pitch = 2 * D + 16 + 2 * C + 16
    used = tile_a * pitch + want * 64 * (pitch + 6)
    assert used <= TT.MMA_SMEM_LIMIT
    assert want == TT.MMA_MAX_STAGES \
        or used + 64 * (pitch + 6) > TT.MMA_SMEM_LIMIT


@pytest.mark.parametrize("kernel,D,C,want", [
    ("pass1", 256, 0, 256),   # the train shape: 16 warps per block
    ("pass1", 304, 0, 128),
    ("pass2", 256, 16, 256),  # the train shape: 16 warps per block
    ("pass2", 256, 160, 128),  # ADE: 256 anchors leave no room for a ring
    ("pass2", 304, 16, 128),
    ("bwd", 256, 16, 128),
    ("bwd", 256, 160, 128),
])
def test_anchor_tile(kernel, D, C, want):
    assert TT.anchor_tile(kernel, D, C) == want
    assert TT.ring_stages(D, C, want) >= 2
    with pytest.raises(ValueError, match="shared memory"):
        TT.anchor_tile(kernel, 1024, 16)


def test_ring_stages_raises_when_two_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        TT.ring_stages(1024, 16, 128)


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, "fma"), (torch.bfloat16, "mma"),
    (torch.float16, None), (torch.float64, None), (torch.int32, None),
    (None, None)])
def test_kernel_variant_table(dtype, want):
    """f32 mode -> the FMA kernels, bf16 mode -> the tensor-core kernels
    for all three stages (pass 1 is routed too: each has its anchor tiles),
    anything else raises: the mode alone decides, nothing falls back."""
    assert set(TT.MMA_TILE_A) == {"pass1", "pass2", "bwd"}
    if want is None:
        with pytest.raises(ValueError, match="compute_dtype"):
            TT.kernel_variant(dtype)
    else:
        assert TT.kernel_variant(dtype) == want


@pytest.mark.parametrize("name", ["C7_D8_P50", "aligned_P256_D16_C16"])
def test_bf16_layout_holds_no_widened_copies(name):
    """In bf16 mode the kernels' batch is the padded 2-byte operands and the
    slot arrays alone: no float32 copy of the features or probabilities
    (pass 1 reads the bf16 operands too). f32 mode hands the float32
    tensors over and makes no bf16 operands."""
    bt = batch(name)
    prep = TT.layout_batch(bt, BF16)
    assert prep.variant == "mma" and prep.device == torch.device("cpu")
    assert (prep.af, prep.ap, prep.cf, prep.cp) == (None,) * 4
    assert {t.dtype for t in prep.mma[:4]} == {BF16}
    ref = layout(bt)
    assert all(torch.equal(a, b) for a, b in zip(prep.mma[:4], ref[:4]))
    assert prep.dims == ref.dims == (bt.anchor_feat.shape[0],
                                     bt.contrast_feat.shape[0],
                                     bt.anchor_feat.shape[1],
                                     bt.anchor_prob.shape[1])
    f32 = TT.layout_batch(bt, torch.float32)
    assert f32.variant == "fma" and f32.mma is None
    assert {t.dtype for t in (f32.af, f32.ap, f32.cf, f32.cp)} == {
        torch.float32}


def test_prepare_takes_no_cpu_batch_in_either_mode():
    for dtype in (torch.float32, BF16):
        with pytest.raises(ValueError, match="run on CUDA tensors"):
            TT.prepare(batch("C151"), dtype)


def test_padded_bf16_batch_matches_the_pallas_bf16_kernels():
    """The padded bf16 operands through the plain stages against the JAX
    kernels' bf16 mode (interpret mode) on the unpadded batch, at the
    non-aligned shape P 50, D 8, C 7."""
    bt, bj = batches("C7_D8_P50")
    loss_j, res = JP._pallas_fwd(bj, TAU, True, None, jnp.bfloat16)
    _, neg_j, num_j, g_j, _ = res
    (grads,) = JP._pallas_bwd(TAU, True, None, jnp.bfloat16, res,
                              jnp.float32(1.0))
    da_j = np.asarray(grads.anchor_feat)
    ops = layout(bt)
    P, _, D, _ = ops.dims
    big = padded_batch(ops)
    neg, num = TT.pass1_plain(big, TAU, BF16)
    np.testing.assert_array_equal(num[:P].numpy(), np.asarray(num_j)[:P, 0])
    np.testing.assert_allclose(neg[:P].numpy(), np.asarray(neg_j)[:P, 0],
                               rtol=2e-3)
    s, g = TT.pass2_plain(big, neg, TAU, BF16)
    np.testing.assert_allclose(g[:P].numpy(), np.asarray(g_j)[:P, 0],
                               rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(float(TT.finish_loss(s, num)), float(loss_j),
                               rtol=2e-3)
    coef = TT.backward_coef(num, torch.ones(()))
    da = TT.bwd_plain(big, neg, g, coef, TAU, BF16)[:P, :D]
    assert np.abs(da_j).max() > 1e-4
    assert np.abs(da.numpy() - da_j).max() / np.abs(da_j).max() < 2e-2
