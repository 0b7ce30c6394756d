"""The off-path modules of the port against the JAX package: the v1
contrastive losses (ops/contrastive_v1.py), the Sinkhorn-Knopp assignment
(ops/assignment.py) and the non-local block (models/nonlocal_block.py),
in value and gradient.

Both packages compute the losses and the assignment in f32 whatever the
input dtype, so f64 inputs (under jax_enable_x64) are held to the same
bound as f32 ones: values rtol 1e-5 (atol 1e-6) and gradients rtol 1e-5
(atol 1e-6 of the largest gradient entry). The non-local block, with the JAX parameters
carried across by models/convert.py, is compared in train and eval mode,
with `sub_sample` and `bn_layer` each on and off, at rtol 1e-5 (f32; its
BatchNorm's running statistics rtol 1e-6) and 1e-9 (f64 convs; the
BatchNorm is f32 on both sides); a parameter gradient's atol is that
rtol times the largest gradient entry of the block (phi's bias has a zero
gradient in exact arithmetic: the softmax does not see it). Gradients
through the train-mode f32 BatchNorm take atol 1e-4 of their largest
entry: its backward cancels (DESIGN.md §9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import unflatten
from ucd_torch.models import (NonLocalBlock2D, flax_to_state_dict,
                              module_to_flax)
from ucd_torch.ops import (pixel_con_loss_v1, shoot_infs, sinkhorn_knopp,
                           sup_con_loss)
from ucd_tpu.models import NonLocalBlock2D as JaxNonLocal
from ucd_tpu.ops import assignment as JA
from ucd_tpu.ops import contrastive_v1 as JV


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    """The input dtype; f64 with jax_enable_x64 on (restored after)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", request.param == "float64")
    yield request.param
    jax.config.update("jax_enable_x64", prev)


def _normalized(rs, shape, dtype):
    f = rs.randn(*shape)
    return (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(dtype)


def _check(fn_t, fn_j, x, *args, rtol=1e-5):
    """Value and gradient w.r.t. `x` of fn_t (torch) against fn_j (JAX)."""
    val_j, grad_j = jax.value_and_grad(
        lambda a: fn_j(a, *[jnp.asarray(v) if isinstance(v, np.ndarray)
                            else v for v in args]))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    val_t = fn_t(xt, *[torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v for v in args])
    val_t.backward()
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=rtol,
                               atol=1e-6)
    gj = np.asarray(grad_j)
    assert xt.grad.dtype == xt.dtype and gj.dtype == x.dtype
    np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=rtol,
                               atol=1e-6 * np.abs(gj).max())
    return float(val_t)


@pytest.mark.parametrize("mode", ["all", "one"])
@pytest.mark.parametrize("supervision", ["labels", "mask", "simclr"])
def test_sup_con_loss_matches_jax(mode, supervision, dtype):
    rs = np.random.RandomState(hash((mode, supervision)) % 1000)
    feats = _normalized(rs, (6, 2, 8), dtype)
    labels = rs.randint(0, 3, 6).astype(np.int64)
    kw = dict(temperature=0.1, base_temperature=0.07, contrast_mode=mode)
    if supervision == "labels":
        args = (labels,)
    elif supervision == "mask":
        args = (None, (rs.rand(6, 6) > 0.5).astype(dtype))
    else:
        args = ()
    loss = _check(lambda x, *a: sup_con_loss(x, *a, **kw),
                  lambda x, *a: JV.sup_con_loss(x, *a, **kw), feats, *args)
    assert np.isfinite(loss) and loss > 0
    with pytest.raises(ValueError, match="unknown mode"):
        sup_con_loss(torch.from_numpy(feats), contrast_mode="two")


@pytest.mark.parametrize("case", ["mixed", "singletons", "two_classes"])
def test_pixel_con_loss_v1_matches_jax(case, dtype):
    """The column's negative sum inside the log, and anchors without a
    positive left out of the mean (`singletons`: one label of its own)."""
    rs = np.random.RandomState(len(case))
    feats = _normalized(rs, (10, 1, 16), dtype)
    labels = {"mixed": rs.randint(0, 3, 10),
              "singletons": np.array([0, 0, 1, 2, 2, 2, 3, 4, 4, 5]),
              "two_classes": np.arange(10) % 2}[case].astype(np.int64)
    _check(lambda x, lab: pixel_con_loss_v1(x, lab, temperature=0.5),
           lambda x, lab: JV.pixel_con_loss_v1(x, lab, temperature=0.5),
           feats, labels)


def test_pixel_con_loss_v1_without_positives_is_zero():
    feats = torch.from_numpy(_normalized(np.random.RandomState(0),
                                         (4, 1, 5), np.float32))
    got = pixel_con_loss_v1(feats, torch.arange(4))
    want = JV.pixel_con_loss_v1(jnp.asarray(feats.numpy()),
                                jnp.arange(4))
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("case", ["finite", "posinf", "neginf"])
def test_shoot_infs_matches_jax(case):
    x = np.random.RandomState(2).randn(5, 7).astype(np.float32)
    if case == "posinf":
        x[1, 2] = x[4, 0] = np.inf
    elif case == "neginf":
        x[0, 0] = -np.inf
        x[3, 3] = np.inf
    got = shoot_infs(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JA.shoot_infs(
        jnp.asarray(x))))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("num_iters", [1, 3, 10])
def test_sinkhorn_knopp_matches_jax(num_iters, dtype):
    rs = np.random.RandomState(num_iters)
    # q = logits / epsilon spans about +-10: exp stays normal
    logits = (rs.randn(12, 5) * 0.2).astype(dtype)
    q_t = sinkhorn_knopp(torch.from_numpy(logits), num_iters=num_iters)
    q_j = np.asarray(JA.sinkhorn_knopp(jnp.asarray(logits),
                                       num_iters=num_iters))
    assert q_t.dtype == torch.float32 and q_j.dtype == np.float32
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(q_t.sum(1).numpy(), 1.0, rtol=1e-5)
    w = rs.randn(12, 5).astype(np.float32)
    _check(lambda x: (sinkhorn_knopp(x, num_iters=num_iters)
                      * torch.from_numpy(w)).sum(),
           lambda x: (JA.sinkhorn_knopp(x, num_iters=num_iters) * w).sum(),
           logits)


def _nonlocal_pair(sub_sample, bn_layer, dtype, channels=8, hw=(6, 4)):
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    jm = JaxNonLocal(sub_sample=sub_sample, bn_layer=bn_layer, dtype=jdt)
    rs = np.random.RandomState(int(sub_sample) * 2 + int(bn_layer))
    x = rs.randn(2, *hw, channels).astype(dtype)
    v = jm.init(jax.random.key(0), jnp.asarray(x), False)
    flat = {}
    for coll, tree in v.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join([coll] + [p.key for p in path])
            # non-trivial values everywhere: the zero-init BN scale and W
            # would hide a layout bug
            flat[key] = (rs.randn(*leaf.shape) * 0.3
                         + (0.8 if key.endswith("/var") else 0.0)
                         ).astype(np.float32)
            if key.endswith("/var"):
                flat[key] = np.abs(flat[key]) + 0.5
    tm = NonLocalBlock2D(channels, sub_sample=sub_sample, bn_layer=bn_layer,
                         dtype=torch.float64 if dtype == "float64"
                         else torch.float32)
    tm.load_state_dict(flax_to_state_dict(flat), strict=True)
    return jm, tm, flat, x


@pytest.mark.parametrize("sub_sample", [True, False])
@pytest.mark.parametrize("bn_layer", [True, False])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_nonlocal_block_matches_jax(sub_sample, bn_layer, train, dtype):
    jm, tm, flat, x = _nonlocal_pair(sub_sample, bn_layer, dtype)
    g = np.random.RandomState(9).randn(*x.shape).astype(dtype)
    variables = unflatten(flat)
    mutable = ["batch_stats"] if train and bn_layer else False

    def loss(params, x):
        out = jm.apply({**variables, "params": params}, x, train,
                       mutable=mutable)
        y = out[0] if mutable else out
        return jnp.sum(y * g), out

    (val_j, out_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    y_j = out_j[0] if mutable else out_j
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y_t = tm.train(train)(xt)
    (y_t * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    assert y_t.dtype == xt.dtype
    rtol = 1e-9 if dtype == "float64" and not bn_layer else 1e-5
    grad_atol = 1e-4 if train and bn_layer else rtol

    def close(a, b, what, atol=rtol):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol * np.abs(b).max(),
                                   err_msg=what)

    close(y_t.detach().permute(0, 2, 3, 1).numpy(), y_j, "output")
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, "input gradient",
          grad_atol)
    grads = {"params/" + "/".join(p.key for p in path): leaf for path, leaf
             in jax.tree_util.tree_flatten_with_path(gp)[0]}
    got = module_to_flax(tm)
    port_grads = {k: torch.zeros(0) for k in got}
    for name, p in tm.named_parameters():
        *path, leaf = name.split(".")
        leaf = {"weight": "kernel" if p.ndim == 4 else "scale",
                "bias": "bias"}[leaf]
        port_grads["params/" + "/".join(path) + "/" + leaf] = (
            p.grad.permute(2, 3, 1, 0) if p.ndim == 4 else p.grad)
    assert set(grads) <= set(port_grads)
    gmax = max(np.abs(np.asarray(v)).max() for v in grads.values())
    for k, v in grads.items():
        np.testing.assert_allclose(port_grads[k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=grad_atol * gmax,
                                   err_msg=k)
    if mutable:
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                got[f"batch_stats/W_bn/{leaf}"],
                np.asarray(out_j[1]["batch_stats"]["W_bn"][leaf]),
                rtol=1e-6, atol=1e-7, err_msg=leaf)
    for k, v in flat.items():
        if not mutable or not k.startswith("batch_stats/"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_nonlocal_block_starts_as_identity():
    """flax's init: the zero-scale BatchNorm (or the zero W without it)
    makes the block the identity; the weights round-trip through the
    bridge."""
    for bn_layer in (True, False):
        tm = NonLocalBlock2D(8, bn_layer=bn_layer).init_weights(
            torch.Generator().manual_seed(0))
        x = torch.randn(2, 8, 6, 4, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(tm.train()(x), x, rtol=0, atol=0)
        back = NonLocalBlock2D(8, bn_layer=bn_layer)
        back.load_state_dict(flax_to_state_dict(module_to_flax(tm)))
        for k, v in tm.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, back.state_dict()[k]), k
