"""The model's execution options in the port against the JAX package:
`stem_s2d` (the space-to-depth stem conv), `remat` / `remat_early`
(rematerialized residual blocks), `bf16_norm` / `bf16_norm_early` (ABN
outputs rounded to bf16) and ABN's `norm_type="gn"`.

Bounds: the S2D stem against the JAX `S2DStemConv` max|d| <= 1e-5 max|ref|
(f32; a different summation order), against the plain strided conv 1e-12
relative at f64 and exactly at odd sizes (the same conv); a remat step at
f64 equals the port's plain step bit for bit (gradients, parameters,
running statistics, metrics) and the JAX step with the same option at
tests/test_torch_train_step.py's f64 bounds; the bf16-norm forwards at
tests/test_torch_models.py's bf16 bound (5e-2 of max|ref|); one bf16 ABN
within a bf16 ulp of flax's; GroupNorm rtol 1e-5 at f32 and 1e-10 at f64,
its gradients too; a JAX `stem_s2d` export served by the port at 1e-4 of
max|ref| on the logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

import torch_dp_workers as W
from test_torch_train_step import (B, SIZE, TOTAL_ITERS,
                                   _assert_updates_close, _batches, _cfgs,
                                   _flat_of, _jax_state, _tree)
from torch_port_helpers import (assert_argmax_close, jax_forward, nhwc,
                                one_torch_thread, random_flat_variables,
                                unflatten)
from ucd_torch.engine.export import load_inference, save_inference
from ucd_torch.engine.predictor import Predictor
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import make_train_step
from ucd_torch.models import (flax_to_state_dict, load_flax_variables,
                              make_model, module_to_flax)
from ucd_torch.models.layers import ABN
from ucd_torch.models.resnet import S2DStemConv
from ucd_tpu import engine as JE
from ucd_tpu.engine import checkpoint as JK
from ucd_tpu.engine import export as JX
from ucd_tpu.models import layers as JL
from ucd_tpu.models import make_model as jax_make_model
from ucd_tpu.models.resnet import S2DStemConv as JaxS2D

__all__ = ["one_torch_thread"]


@pytest.fixture(autouse=True)
def jax_norm_defaults():
    """The JAX `make_model` sets two process-wide norm defaults from its
    config: restore them after each test."""
    saved = JL.DEFAULT_NORM_DTYPE[0], JL.DEFAULT_FAST_VARIANCE[0]
    yield
    JL.DEFAULT_NORM_DTYPE[0], JL.DEFAULT_FAST_VARIANCE[0] = saved


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# the space-to-depth stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(32, 32), (40, 24), (33, 31), (32, 17)])
def test_s2d_stem_matches_jax_and_the_plain_conv(hw):
    rs = np.random.RandomState(sum(hw))
    x = rs.randn(2, *hw, 3).astype(np.float32)
    kernel = (rs.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    want = np.asarray(JaxS2D(features=64).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x)))
    conv = S2DStemConv(3, 64)
    sd = flax_to_state_dict({"params/kernel": kernel})
    conv.load_state_dict({"weight": sd[".weight"]})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = nhwc(conv(xt))
        plain = nhwc(F.conv2d(xt, conv.weight, stride=2, padding=3))
    assert got.shape == want.shape == plain.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if hw[0] % 2 or hw[1] % 2:
        np.testing.assert_array_equal(got, plain)
    with torch.no_grad():
        got64 = conv.double()(xt.double())
        plain64 = F.conv2d(xt.double(), conv.weight, stride=2, padding=3)
    err = (got64 - plain64).abs().max() / plain64.abs().max()
    assert err <= 1e-12, float(err)


# ---------------------------------------------------------------------------
# f64 train steps: remat, remat_early and stem_s2d
# ---------------------------------------------------------------------------

def _flat0(cfg_j):
    model0_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    return random_flat_variables(model0_j, (SIZE, SIZE), seed=11)


def _port_steps(cfg_t, flat0, batches):
    """The port's UCD step-1 steps from `flat0`: the model, its starting
    variables (flat) and per step the metrics, the gradients and the
    model's state_dict."""
    model = make_model(cfg_t)
    model_old = make_model(cfg_t, cfg_t.classes_per_step[:-1])
    state, old = build_train_state(
        cfg_t, model, torch.Generator().manual_seed(1), TOTAL_ITERS,
        prev_model_state=flax_to_state_dict(flat0), device="cpu")
    step = make_train_step(cfg_t, model, model_old, TOTAL_ITERS,
                           device="cpu")
    start = module_to_flax(model)
    out = []
    for batch in batches:
        state, m = step(state, batch, old)
        out.append(({k: float(v) for k, v in m.items()},
                    {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None},
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return model, start, out


@pytest.mark.parametrize("option", ["remat", "remat_early"])
def test_remat_step_equals_the_plain_step_bitwise(option, one_torch_thread):
    """Two f64 UCD iterations: gradients, parameters, running statistics,
    `num_batches_tracked` and metrics carry the plain step's bits; the
    rematerialized blocks really ran under the checkpoint."""
    cfg_t, cfg_j = _cfgs(1, "UCD", "float64")
    flat0 = _flat0(cfg_j)
    batches = _batches(2, cfg_t.tot_classes, seed=12)
    _, _, plain = _port_steps(cfg_t, flat0, batches)
    model, _, got = _port_steps(dataclasses.replace(cfg_t, **{option: True}),
                             flat0, batches)
    want_blocks = {n for n in model.body.block_names
                   if option == "remat" or n.startswith("mod2_")}
    assert model.body.remat_blocks == want_blocks
    for (m_p, g_p, s_p), (m_r, g_r, s_r) in zip(plain, got):
        assert m_p == m_r
        assert g_p.keys() == g_r.keys() and s_p.keys() == s_r.keys()
        for k in g_p:
            assert torch.equal(g_p[k], g_r[k]), k
        for k in s_p:
            assert torch.equal(s_p[k], s_r[k]), k
    assert int(got[-1][2]["body.mod2_block1.bn1.bn.num_batches_tracked"]) \
        == 2


@pytest.mark.parametrize("option", ["remat", "remat_early", "stem_s2d"])
def test_option_step_matches_jax_at_float64(option, x64, one_torch_thread):
    """One f64 UCD step-1 iteration with the option on both sides (the JAX
    side's dense losses), at tests/test_torch_train_step.py's bounds."""
    cfg_t, cfg_j = _cfgs(1, "UCD", "float64", **{option: True})
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    flat0 = _flat0(cfg_j)
    model_j = jax_make_model(cfg_j)
    prev = {"params": _tree(flat0, "params", jnp.float64),
            "batch_stats": _tree(flat0, "batch_stats", jnp.float64)}
    state_j, old_j = JE.build_train_state(
        cfg_j, model_j, jax.random.key(1), total_iters=TOTAL_ITERS,
        prev_model_state=prev, input_shape=(1, SIZE, SIZE, 3))
    state_j = state_j.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), state_j.batch_stats))
    before = _flat_of(state_j.params, state_j.batch_stats)
    step_j = jax.jit(JE.make_train_step(
        cfg_j, model_j, jax_make_model(cfg_j, cfg_j.classes_per_step[:-1]),
        total_iters=TOTAL_ITERS))
    batch = _batches(1, cfg_t.tot_classes, seed=12)[0]
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, old_j)

    model_t, start_t, [(m_t, _, _)] = _port_steps(cfg_t, flat0, [batch])
    if option == "stem_s2d":
        assert isinstance(model_t.body.mod1_conv1, S2DStemConv)
    for key in ("loss", "lkd", "lde", "l_con", "l_icarl", "l_reg",
                "loss_tot"):
        np.testing.assert_allclose(m_t[key], float(m_j[key]), rtol=2e-5,
                                   atol=1e-9, err_msg=key)
    after_j = _flat_of(state_j.params, state_j.batch_stats)
    after_t = module_to_flax(model_t)
    _assert_updates_close(before, start_t, after_t, after_j, "params/cls_0/",
                          0)
    for k in after_j:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(after_t[k], after_j[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    assert m_t["l_con"] > 0


def test_remat_statistics_move_once_in_a_process_group(tmp_path):
    """Two gloo ranks, one image each: the rematerialized body's gradients
    and BatchNorm state equal the plain body's bit for bit, and its
    recompute gathers no statistics again."""
    W.run_ranks(W.remat_worker, 2, tmp_path, str(tmp_path))
    for r in (0, 1):
        res = torch.load(tmp_path / f"remat{r}.pt")
        plain, remat = res[False], res[True]
        assert remat["gathers"] == plain["gathers"] > 0
        for k, v in plain["grads"].items():
            assert torch.equal(v, remat["grads"][k]), k
        for k, v in plain["state"].items():
            assert torch.equal(v, remat["state"][k]), k
        assert int(remat["state"]["mod2_block1.bn1.bn.num_batches_tracked"]) \
            == 1


# ---------------------------------------------------------------------------
# bf16 norms
# ---------------------------------------------------------------------------

NORM_CASES = {
    "bf16_norm_f32": ("bf16_norm", "float32"),
    "bf16_norm_bf16": ("bf16_norm", "bfloat16"),
    "bf16_norm_early_bf16": ("bf16_norm_early", "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(NORM_CASES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_norm_forward_matches_jax(case, train):
    """ResNet-18 forward against the JAX model built by its make_model.
    Eval mode (running statistics): the three outputs. Train mode (batch
    statistics and their update): the body's output and every body
    BatchNorm's new statistics; the head's outputs are left out there,
    because its pooling branch's BatchNorm normalizes two values a channel
    at batch 2 and spreads bf16 rounding over the whole map, by 15-25 % of
    max|ref| without any option at all."""
    option, dtype = NORM_CASES[case]
    cfg_t, cfg_j = _cfgs(1, "MiB", dtype, **{option: True})
    model_j = jax_make_model(cfg_j)
    assert (JL.DEFAULT_NORM_DTYPE[0] == jnp.bfloat16) == (
        option == "bf16_norm")
    flat = random_flat_variables(model_j, (SIZE, SIZE), seed=3)
    model_t = load_flax_variables(make_model(cfg_t), flat).to(
        memory_format=torch.channels_last).train(train)
    rounded = [m.norm_dtype for m in model_t.modules()
               if isinstance(m, ABN)]
    # bf16_norm_early: the stem's ABN and mod2's two basic blocks
    assert rounded.count(torch.bfloat16) == (
        len(rounded) if option == "bf16_norm" else 1 + 2 * 2)
    x = np.random.RandomState(4).randint(0, 256, (2, SIZE, SIZE, 3),
                                         np.uint8)
    if train:
        (_, want), upd = jax.jit(lambda v, x: model_j.apply(
            v, x, train=True, mutable=["batch_stats"]))(unflatten(flat),
                                                        jnp.asarray(x))
        want = {k: np.asarray(v) for k, v in want.items()}
        stats = {"batch_stats/" + k: np.asarray(v) for k, v in
                 flatten_dict(upd["batch_stats"], sep="/").items()}
    else:
        _, want = jax_forward(model_j, flat, jnp.asarray(x))
    with torch.no_grad():
        _, feats = model_t(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("body",) if train else ("sem", "body", "pre_logits"):
        got, ref = nhwc(feats[k]), want[k].astype(np.float32)
        assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max(), k
    if train:
        got = module_to_flax(model_t)
        for k, ref in stats.items():
            if not k.startswith("batch_stats/body/"):
                continue
            err = np.abs(got[k] - ref).max()
            assert err <= 5e-2 * np.abs(ref).max(), (k, err)


def test_one_bf16_abn_rounds_where_flax_does():
    """A train-mode bf16 ABN on a bf16 input: the statistics in f32, the
    normalized output rounded to bf16, the activation in bf16; every value
    within one bf16 ulp of flax's, the running statistics at rtol 1e-6."""
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 9, 7, 16) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jm = JL.ABN(dtype=jnp.bfloat16, norm_dtype=jnp.bfloat16)
    v = jm.init(jax.random.key(0), xb, True)
    flat = {"params/bn/scale": rs.rand(16).astype(np.float32) + 0.5,
            "params/bn/bias": rs.randn(16).astype(np.float32),
            "batch_stats/bn/mean": np.zeros(16, np.float32),
            "batch_stats/bn/var": np.ones(16, np.float32)}
    y_j, upd = jm.apply(unflatten(flat), xb, True, mutable=["batch_stats"])
    tm = ABN(16, dtype=torch.bfloat16, norm_dtype=torch.bfloat16)
    tm.load_state_dict(flax_to_state_dict(flat))
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    y_t = tm.train()(xt)
    assert y_t.dtype == torch.bfloat16 and "bn" in v["params"]
    got = nhwc(y_t)
    ref = np.asarray(y_j.astype(jnp.float32))
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()
    for leaf, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(
            getattr(tm.bn, name).numpy(),
            np.asarray(upd["batch_stats"]["bn"][leaf]), rtol=1e-6,
            atol=1e-7)


# ---------------------------------------------------------------------------
# GroupNorm ABN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels,groups", [(32, 16), (8, 16), (48, 16),
                                             (12, 4)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_groupnorm_abn_matches_jax(channels, groups, dtype, x64):
    """Value and input/parameter gradients of ABN(norm_type='gn') against
    flax with the same parameters, under the names gn/scale, gn/bias."""
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    rs = np.random.RandomState(channels)
    x = (rs.randn(2, 5, 6, channels) * 2 + 0.5).astype(dtype)
    g = rs.randn(*x.shape).astype(dtype)
    flat = {"params/gn/scale": rs.rand(channels).astype(dtype) + 0.5,
            "params/gn/bias": rs.randn(channels).astype(dtype)}
    jm = JL.ABN(norm_type="gn", gn_groups=groups, dtype=jdt, norm_dtype=jdt)

    def loss(params, x):
        return jnp.sum(jm.apply({"params": params}, x, True) * g)

    params = unflatten(flat)["params"]
    val, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    tm = ABN(channels, dtype=tdt, norm_type="gn", gn_groups=groups)
    tm.load_state_dict(flax_to_state_dict(flat), strict=True)
    assert tm.gn.num_groups == min(groups, channels)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = tm.train()(xt)
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    rtol = 1e-10 if dtype == "float64" else 1e-5
    y_j = jm.apply({"params": params}, jnp.asarray(x), True)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_j), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(tm.gn.weight.grad.numpy(),
                               np.asarray(gp["gn"]["scale"]), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(
                                   gp["gn"]["scale"])).max())
    np.testing.assert_allclose(tm.gn.bias.grad.numpy(),
                               np.asarray(gp["gn"]["bias"]), rtol=rtol,
                               atol=rtol)


# ---------------------------------------------------------------------------
# a JAX stem_s2d export served by the port
# ---------------------------------------------------------------------------

def test_jax_stem_s2d_export_serves_in_the_port(tmp_path):
    _, cfg_j = _cfgs(1, "MiB", "float32", stem_s2d=True)
    cfg_t, _ = _cfgs(1, "MiB", "float32", stem_s2d=True)
    model_j = jax_make_model(cfg_j)
    flat = random_flat_variables(model_j, (SIZE, SIZE), seed=31)
    ckpt = str(tmp_path / "jax_ckpt")
    JK.save_checkpoint(ckpt, _jax_state(cfg_j, model_j, flat, jnp.float32),
                       epoch=0, best_score=0.0)
    meta = JX.export_inference(ckpt, str(tmp_path / "m"), cfg_j, "float32")
    assert meta["stem_s2d"] is True
    served, meta_t = load_inference(meta["path"], device="cpu")
    assert meta_t["stem_s2d"] is True
    assert isinstance(served.body.mod1_conv1, S2DStemConv)
    x = np.random.RandomState(5).randint(0, 256, (B, SIZE, SIZE, 3),
                                         np.uint8)
    up, want = jax_forward(model_j, flat, jnp.asarray(x))
    with torch.no_grad():
        sem = served.forward_sem(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(nhwc(sem) - want["sem"]).max() \
        <= 1e-4 * np.abs(want["sem"]).max()
    preds = Predictor(served, device="cpu").predict_labels(x)
    assert_argmax_close(preds.numpy(), up.argmax(-1), up)
    # the port's own export of the same weights writes the same header
    own = load_flax_variables(make_model(cfg_t), flat)
    mine = save_inference(own, str(tmp_path / "t"), export_dtype="float32")
    assert {k: v for k, v in mine.items() if k != "path"} == \
        {k: v for k, v in meta.items() if k != "path"}
