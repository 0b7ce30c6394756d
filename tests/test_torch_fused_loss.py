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


RATIOS = [(4, 32), (13, 100), (17, 132), (32, 512), (16, 16), (5, 7)]


def _src64(n_in, n_out, identity):
    """`taps` in float64: (index0, index1, frac), F.interpolate's own
    weights at f64 (the kernel reads them rounded to f32)."""
    o = np.arange(n_out, dtype=np.float64)
    src = np.maximum((o + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = i0 if identity else np.minimum(i0 + 1, n_in - 1)
    return i0, i1, src - i0


@pytest.mark.parametrize("n_in,n_out", RATIOS)
def test_cell_tables_partition_the_output(n_in, n_out):
    """The backward kernel's host plan: the cells cover the outputs once, in
    order; every output of a cell taps the cell's two source indices and
    neighbouring cells tap different ones (maximal runs); each source's
    feeds are exactly the (cell, tap) pairs that land on it, in increasing
    order, and the weights they gather are the interpolation matrix's
    column sums (what the JAX row plan folds)."""
    from ucd_torch.ops.fused_eval import taps

    identity = n_in == n_out
    i0, i1, frac = taps(n_in, n_out, identity)
    table, feeds = TF.cells(n_in, n_out, identity)
    first, end, src0, src1 = table.T
    assert first[0] == 0 and end[-1] == n_out
    np.testing.assert_array_equal(first[1:], end[:-1])
    assert (end > first).all()
    cell = np.repeat(np.arange(len(table)), end - first)
    np.testing.assert_array_equal(i0, src0[cell])
    np.testing.assert_array_equal(i1, src1[cell])
    assert ((src0[1:] != src0[:-1]) | (src1[1:] != src1[:-1])).all()
    col = np.zeros(n_in)
    for i in range(n_in):
        want = [2 * k + t for k in range(len(table))
                for t, src in enumerate((src0[k], src1[k])) if src == i]
        got = [f for f in feeds[i] if f >= 0]
        assert got == want and (feeds[i][len(got):] == -1).all()
        for f in got:
            o = np.arange(first[f >> 1], end[f >> 1])
            col[i] += (frac[o] if f & 1 else 1 - frac[o]).sum()
    np.testing.assert_allclose(col, JF.interp_matrix(n_out, n_in).sum(0),
                               rtol=1e-5, atol=1e-6)


def _per_pixel_grad(z, t, lab, ct_kd, old_cl, ce_mode, kd_mode, alpha=1.0):
    """d(ce + ct_kd * kd) / d(upsampled logits), (B, H, W, C), through the
    same plain losses as fused_ce_kd_plain, in z's dtype."""
    from ucd_torch.ops import losses as TL

    H, W = lab.shape[1:]

    def upsample(x):
        return torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)

    up = upsample(z).detach().requires_grad_(True)
    lab = lab.long()
    total = (TL.unbiased_cross_entropy(up, lab, old_cl) if ce_mode == "unce"
             else TL.cross_entropy(up, lab))
    if kd_mode != "none":
        kd = (TL.unbiased_knowledge_distillation if kd_mode == "unkd"
              else TL.knowledge_distillation)
        total = total + ct_kd * kd(up, upsample(t), alpha=alpha)
    return torch.autograd.grad(total, up)[0]


def _fold_cells(g, h, w):
    """The backward kernels' order in torch: each cell's pixels folded onto
    its 2 x 2 corners (weights wy * wx), then each low-res pixel the sum of
    the corners its feeds name, rows outer, columns inner."""
    B, H, W, C = g.shape
    identity = (h, w) == (H, W)

    def weights(n_in, n_out):
        table, feeds = TF.cells(n_in, n_out, identity)
        frac = torch.from_numpy(_src64(n_in, n_out, identity)[2]).to(g.dtype)
        wt = torch.zeros(len(table), 2, n_out, dtype=g.dtype)
        for k, (a, b, _, _) in enumerate(table):
            wt[k, 0, a:b] = 1 - frac[a:b]
            wt[k, 1, a:b] = frac[a:b]
        return wt, feeds

    (wy, fy), (wx, fx) = weights(h, H), weights(w, W)
    part = torch.einsum("krY,lsX,bYXc->bklrsc", wy, wx, g)
    dz = torch.zeros(B, h, w, C, dtype=g.dtype)
    for i in range(h):
        for j in range(w):
            for e in fy[i][fy[i] >= 0]:
                for f in fx[j][fx[j] >= 0]:
                    dz[:, i, j] += part[:, e >> 1, f >> 1, e & 1, f & 1]
    return dz


@pytest.mark.parametrize("ce_mode,kd_mode", MODES)
def test_cell_fold_gives_the_plain_gradient(ce_mode, kd_mode):
    """The cell-then-fold order of the backward kernels, emulated in torch
    over the per-pixel gradient of the plain losses: at f64 it is
    fused_ce_kd_grad_plain's gradient (rtol 1e-12: only the order of the
    sums differs), at f32 the JAX `_grad_kernel`'s (interpret mode) within
    2e-4 of its largest entry."""
    z, t, lab = _case(6, B=2, h=4, w=4, C=17, Co=16, H=32, W=32)
    kw = dict(old_cl=16 if ce_mode == "unce" else 0, ce_mode=ce_mode,
              kd_mode=kd_mode)
    z64, t64 = torch.from_numpy(z).double(), torch.from_numpy(t).double()
    lab_t = torch.from_numpy(lab)
    got = _fold_cells(_per_pixel_grad(z64, t64, lab_t, 2.5, **kw), 4, 4)
    want = TF.fused_ce_kd_grad_plain(z64, lab_t, t64, ct_kd=2.5, **kw)
    assert float(want.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    g32 = _fold_cells(_per_pixel_grad(torch.from_numpy(z),
                                      torch.from_numpy(t), lab_t, 2.5, **kw),
                      4, 4).numpy()
    jl, jt = jnp.asarray(lab), jnp.asarray(t)

    def total(zz):
        ce, kd = JF.fused_ce_kd(zz, jl, jt, interpret=True, **kw)
        return ce + 2.5 * kd

    gj = np.asarray(jax.grad(total)(jnp.asarray(z)))
    scale = np.abs(gj).max()
    np.testing.assert_allclose(g32 / scale, gj / scale, rtol=0, atol=2e-4)


@pytest.mark.parametrize("hw,out", [((13, 17), (100, 132)),
                                    ((16, 16), (16, 16)),
                                    ((5, 7), (7, 9))])
def test_cell_fold_at_other_ratios(hw, out):
    """Non-integer ratios, identity and ratios below 2: the same f64
    equality with the plain gradient (unce + unkd, alpha 2)."""
    z, t, lab = _case(7, B=1, h=hw[0], w=hw[1], C=11, Co=6, H=out[0],
                      W=out[1])
    kw = dict(old_cl=6, ce_mode="unce", kd_mode="unkd", alpha=2.0)
    z64, t64 = torch.from_numpy(z).double(), torch.from_numpy(t).double()
    lab_t = torch.from_numpy(lab)
    got = _fold_cells(_per_pixel_grad(z64, t64, lab_t, 2.5, **kw), *hw)
    want = TF.fused_ce_kd_grad_plain(z64, lab_t, t64, ct_kd=2.5, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


def test_backward_class_limit_is_its_shared_memory():
    """The backward's only class limit is the cell kernel's shared memory:
    the wrapper's sizes are the CUDA source's, the main path's 17 + 16
    classes and ADE's 151 fit, and a count over the card's limit is refused
    before any kernel is built or launched."""
    import re
    from pathlib import Path

    src = (Path(TF.__file__).parent / "csrc" / "fused_loss.cu").read_text()
    for name in ("CELL_WARPS", "BATCH_PX", "NSTAT"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(TF, name), name
    assert "MAX_SHARED = 227 * 1024;" in src
    assert TF.bwd_shared_bytes(17, 16) == 4 * (8 * 17 + 4 * 16 + 512) * 4
    for C, Co in ((17, 16), (151, 101), (1000, 1000)):
        assert TF.bwd_shared_bytes(C, Co) <= TF.MAX_SHARED, (C, Co)
    C = 1300
    assert TF.bwd_shared_bytes(C, C) > TF.MAX_SHARED
    z = torch.zeros(1, 2, 2, C)
    lab = torch.zeros(1, 4, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="shared memory"):
        TF.launch_bwd(z, z, lab, torch.zeros(2), old_cl=1, ce_mode="unce",
                      kd_mode="unkd", alpha=1.0)


def test_gate_refuses_class_counts_beyond_the_kernels_on_cuda():
    """The fused-loss gate of the train and validate steps: on a CUDA
    device a class count whose backward cell kernel needs more than the
    card's shared memory takes the dense path (1300 / 1300 classes), ADE's
    151 / 101 the fused one; on the CPU the gate is the JAX one at any
    class count."""
    from ucd_torch import config as C
    from ucd_torch.engine.train import _fused_gate

    cfg = C.make_config(dataset="ade", task="100-50", step=1, method="MiB",
                        crop_size=64)
    cuda = torch.device("cuda")
    for n, n_old, want in ((1300, 1300, False), (151, 101, True)):
        sem, old = (2, 4, 4, n), (2, 4, 4, n_old)
        assert _fused_gate(cfg, sem, (2, 64, 64), old, cuda) == (
            "unce", "unkd", want), n
        assert _fused_gate(cfg, sem, (2, 64, 64), old, "cpu")[2]
        assert JF.supported(sem, (2, 64, 64), "unce", "unkd")
    # without KD the backward holds C classes and one unused old one
    assert not TF.supported((2, 4, 4, 1800), (2, 64, 64), "ce", "none",
                            None, cuda)
    assert TF.supported((2, 4, 4, 1100), (2, 64, 64), "ce", "none", None,
                        cuda)


RATIOS_2D = [((4, 4), (32, 32)), ((13, 17), (100, 132)), ((16, 16), (16, 16)),
             ((5, 7), (7, 9))]


def _forward_emulation(z, t, lab, old_cl, ce_mode, kd_mode, alpha=1.0):
    """torch emulation of csrc/fused_loss.cu's forward in z's dtype: per
    cell of `cells`, each class's 2x2 corners as the polynomial k0 + lx k1
    + ly (k2 + lx k3) (alpha folded into the old logits'), then per pixel
    the kernel's subset maxima and sums, its label' rule and its CE / KD
    formulas. Returns (sum of CE terms, sum of KD terms)."""
    B, h, w, C = z.shape
    H, W = lab.shape[1:]
    identity = (h, w) == (H, W)
    (ycells, _), (xcells, _) = (TF.cells(h, H, identity),
                                TF.cells(w, W, identity))
    fy = torch.from_numpy(_src64(h, H, identity)[2]).to(z.dtype)
    fx = torch.from_numpy(_src64(w, W, identity)[2]).to(z.dtype)

    def upsample(x):
        out = torch.empty(B, H, W, x.shape[-1], dtype=x.dtype)
        for y0, y1, r0, r1 in ycells:
            for x0, x1, c0, c1 in xcells:
                a, b_ = x[:, r0, c0], x[:, r0, c1]
                c_, d = x[:, r1, c0], x[:, r1, c1]
                k0, k1, k2, k3 = a, b_ - a, c_ - a, (a - b_) - (c_ - d)
                ly = fy[y0:y1, None, None]
                lx = fx[None, x0:x1, None]
                out[:, y0:y1, x0:x1] = (ly * (lx * k3[:, None, None]
                                              + k2[:, None, None])
                                        + (lx * k1[:, None, None]
                                           + k0[:, None, None]))
        return out

    v = upsample(z)
    lse = lambda x: x.amax(-1) + torch.log(  # noqa: E731
        torch.exp(x - x.amax(-1, keepdim=True)).sum(-1))
    den = lse(v)
    lab = lab.long()
    valid = lab != 255
    safe = torch.where(valid, lab, 0)
    if ce_mode == "unce":
        safe = torch.where(safe < old_cl, 0, safe)
    safe = safe.clamp(0, C - 1)
    sel = v.gather(-1, safe[..., None])[..., 0]
    if ce_mode == "unce":
        sel = torch.where(safe == 0, lse(v[..., :old_cl]), sel)
    ce = torch.where(valid, den - sel, 0).sum()
    if kd_mode == "none":
        return ce, torch.zeros((), dtype=z.dtype)
    Co = t.shape[-1]
    tv = upsample(alpha * t)
    e = torch.exp(tv - tv.amax(-1, keepdim=True))
    s_t = e.sum(-1)
    if kd_mode == "kd":
        kd = (e * v[..., :Co]).sum(-1) / s_t - lse(v[..., :Co])
    else:
        lse_bn = lse(torch.cat([v[..., :1], v[..., Co:]], -1))
        t2 = (e[..., 1:] * v[..., 1:Co]).sum(-1)
        kd = (e[..., 0] / s_t * (lse_bn - den) + t2 / s_t
              - e[..., 1:].sum(-1) / s_t * den)
    return ce, kd.sum()


@pytest.mark.parametrize("hw,out", RATIOS_2D)
@pytest.mark.parametrize("ce_mode,kd_mode", [("ce", "none"), ("unce", "kd"),
                                             ("unce", "unkd")])
def test_forward_cells_give_the_plain_losses(hw, out, ce_mode, kd_mode):
    """The forward kernel's cell polynomials cover every output pixel with
    its own 2x2 taps, and its per-pixel formulas are the plain losses': at
    f64 (weights too) the emulation equals fused_ce_kd_plain to rtol
    1e-12 (alpha 2)."""
    z, t, lab = _case(8, B=2, h=hw[0], w=hw[1], C=11, Co=6, H=out[0],
                      W=out[1])
    kw = dict(old_cl=6 if ce_mode == "unce" else 0, ce_mode=ce_mode,
              kd_mode=kd_mode, alpha=2.0)
    z64, t64 = torch.from_numpy(z).double(), torch.from_numpy(t).double()
    lab_t = torch.from_numpy(lab)
    ce, kd = _forward_emulation(z64, t64, lab_t, **kw)
    n_pix = lab.size
    pc, pk = TF.fused_ce_kd_plain(z64, lab_t, t64, **kw)
    np.testing.assert_allclose(float(ce) / n_pix, float(pc), rtol=1e-12)
    np.testing.assert_allclose(-float(kd) / (t.shape[-1] * n_pix),
                               float(pk), rtol=1e-12, atol=1e-15)


def test_forward_register_bounds_match_the_source():
    """The forward's sizes in the wrapper are the CUDA source's: FWD_WARPS
    cells a block, one float4 a class of z and of the old logits."""
    import re
    from pathlib import Path

    src = (Path(TF.__file__).parent / "csrc" / "fused_loss.cu").read_text()
    m = re.search(r"constexpr int FWD_WARPS = (\d+);", src)
    assert m and int(m.group(1)) == TF.FWD_WARPS
    assert TF.fwd_shared_bytes(17, 16) == TF.FWD_WARPS * 33 * 16
    assert TF.fwd_shared_bytes(151, 101) <= TF.MAX_SHARED
