"""The port's composed train step, validate step and train-state
construction against the JAX package's, from one shared numpy variable tree.

The train step runs at FLOAT64 on both sides (gradients through stacked
train-mode BatchNorms are cancellation-dominated in f32: no f32 tolerance
separates a bug from rounding), over two iterations so that the momentum
buffer and the per-iteration PolyLR are exercised: the JAX side with
`fused_loss=False` (its dense losses), the port through `fused_ce_kd`'s
plain path. Bounds, as tests/test_train_step_parity.py: loss terms rtol
2e-5; per-leaf updates |e| <= 2e-4 |ref| + 3e-6 max|ref|; the global update
|e| <= 1e-4 |ref|; frozen leaves exactly unchanged.

ResNet-18 keeps the run in tier-1 time; `Config.validate` admits only
resnet50/101, so the backbone is set after `make_config` on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_port_helpers import (assert_argmax_close, random_flat_variables,
                                unflatten)
from ucd_torch import config as TC
from ucd_torch.engine.metrics import empty_confusion
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import (make_eval_step, make_lr_schedule,
                                    make_train_step)
from ucd_torch.models import (flax_to_state_dict, load_flax_variables,
                              make_model, module_to_flax)
from ucd_tpu import config as JC
from ucd_tpu import engine as JE
from ucd_tpu.models import make_model as jax_make_model

SIZE, B, TOTAL_ITERS = 64, 2, 10
COMMON = dict(dataset="voc", task="15-5s", crop_size=SIZE, batch_size=B)


@pytest.fixture
def x64():
    """Enable 64-bit jax for this test only (restored afterwards)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _cfgs(step, method, dtype, **kw):
    """The same Config on both sides, with the ResNet-18 backbone."""
    args = dict(COMMON, step=step, method=method, dtype=dtype, **kw)
    return (dataclasses.replace(TC.make_config(**args), backbone="resnet18"),
            dataclasses.replace(JC.make_config(**args), backbone="resnet18"))


def _batches(n, n_classes, seed, uint8=False):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if uint8:
            img = rs.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
        else:
            img = rs.randn(B, SIZE, SIZE, 3).astype(np.float32)
        lab = rs.randint(0, n_classes, (B, SIZE, SIZE)).astype(np.int32)
        lab[0, :8, :8] = 255  # exercised ignore region
        out.append({"image": img, "label": lab})
    return out


def _tree(flat, collection, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype),
        unflatten({k[len(collection) + 1:]: v for k, v in flat.items()
                   if k.startswith(collection + "/")}))


def _jax_state(cfg_j, model_j, flat, dtype):
    """A JAX TrainState holding exactly `flat` (cast to `dtype`)."""
    state, _ = JE.build_train_state(cfg_j, model_j, jax.random.key(0),
                                    total_iters=TOTAL_ITERS,
                                    input_shape=(1, SIZE, SIZE, 3))
    params = _tree(flat, "params", dtype)
    return state.replace(
        params=params, batch_stats=_tree(flat, "batch_stats", dtype),
        opt_state=JE.make_optimizer(cfg_j, TOTAL_ITERS).init(params))


def _flat_of(params, batch_stats=None):
    out = {"params/" + k: np.asarray(v, np.float64) for k, v in
           flatten_dict(params, sep="/").items()}
    if batch_stats is not None:
        out.update({"batch_stats/" + k: np.asarray(v, np.float64) for k, v
                    in flatten_dict(batch_stats, sep="/").items()})
    return out


def _assert_updates_close(before, before_t, after_t, after_j, frozen_prefix,
                          step_i):
    g_err = g_ref = 0.0
    keys = [k for k in before if k.startswith("params/")]
    scale = max(np.linalg.norm(after_j[k] - before[k]) for k in keys)
    for k in keys:
        d_t, d_j = after_t[k] - before_t[k], after_j[k] - before[k]
        if frozen_prefix and k.startswith(frozen_prefix):
            np.testing.assert_array_equal(d_t, 0.0, err_msg=k)
            np.testing.assert_array_equal(d_j, 0.0, err_msg=k)
            continue
        err, ref = float(np.linalg.norm(d_t - d_j)), float(
            np.linalg.norm(d_j))
        assert ref > 0, f"{k} did not move"
        g_err += err ** 2
        g_ref += ref ** 2
        assert err <= 2e-4 * ref + 3e-6 * scale, (
            f"step {step_i} update mismatch at {k}: |e|={err:.3e}, "
            f"ref {ref:.3e}")
    assert np.sqrt(g_err) <= 1e-4 * np.sqrt(g_ref), (step_i, g_err, g_ref)


@pytest.mark.parametrize("method,step", [("MiB", 1), ("FT", 0), ("UCD", 1)])
def test_two_train_iterations_match_jax_at_float64(method, step, x64):
    cfg_t, cfg_j = _cfgs(step, method, "float64")
    # the JAX side takes its dense losses; the port goes through its
    # wrappers' CPU path (fused_ce_kd and the tiled contrastive stages)
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    assert cfg_t.use_pallas_contrastive and cfg_t.contrastive == (
        method == "UCD")
    incremental = step > 0
    if incremental:
        assert cfg_t.unce and cfg_t.unkd and cfg_t.loss_kd == 10.0 \
            and cfg_t.init_balanced and cfg_t.fused_loss

    # ---- one numpy tree: the previous step's (or the initial) variables
    classes0 = cfg_j.classes_per_step[:-1] if incremental \
        else cfg_j.classes_per_step
    model0_j = jax_make_model(cfg_j, classes=classes0)
    flat0 = random_flat_variables(model0_j, (SIZE, SIZE), seed=11)

    # ---- JAX side
    model_j = jax_make_model(cfg_j)
    if incremental:
        prev = {"params": _tree(flat0, "params", jnp.float64),
                "batch_stats": _tree(flat0, "batch_stats", jnp.float64)}
        state_j, old_j = JE.build_train_state(
            cfg_j, model_j, jax.random.key(1), total_iters=TOTAL_ITERS,
            prev_model_state=prev, input_shape=(1, SIZE, SIZE, 3))
        state_j = state_j.replace(
            batch_stats=jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), state_j.batch_stats))
        model_old_j = model0_j
    else:
        state_j, old_j, model_old_j = _jax_state(
            cfg_j, model_j, flat0, jnp.float64), None, None
    step_j = jax.jit(JE.make_train_step(cfg_j, model_j, model_old_j,
                                        total_iters=TOTAL_ITERS))

    # ---- the port
    model_t = make_model(cfg_t)
    gen = torch.Generator().manual_seed(1)
    if incremental:
        model_old_t = make_model(cfg_t, cfg_t.classes_per_step[:-1])
        state_t, old_t = build_train_state(
            cfg_t, model_t, gen, TOTAL_ITERS,
            prev_model_state=flax_to_state_dict(flat0), device="cpu")
    else:
        model_old_t, old_t = None, None
        state_t, _ = build_train_state(cfg_t, model_t, gen, TOTAL_ITERS,
                                       device="cpu")
        load_flax_variables(model_t, flat0)
    assert all(p.dtype == torch.float64 for p in model_t.parameters())
    step_t = make_train_step(cfg_t, model_t, model_old_t, TOTAL_ITERS,
                             device="cpu")

    # both sides start from the same variables (the imprint included)
    before = _flat_of(state_j.params, state_j.batch_stats)
    start_t = module_to_flax(model_t)
    for k, v in before.items():
        np.testing.assert_allclose(start_t[k], v, rtol=1e-6, atol=0,
                                   err_msg=k)
    donor_before = None if old_t is None else \
        {k: v.clone() for k, v in old_t.items()}

    frozen = "params/cls_0/" if incremental else None
    for i, batch in enumerate(_batches(2, cfg_t.tot_classes, seed=12)):
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, old_j)
        state_t, m_t = step_t(state_t, batch, old_t)
        for key in ("loss", "lkd", "lde", "l_con", "l_icarl", "l_reg",
                    "loss_tot"):
            np.testing.assert_allclose(
                float(m_t[key]), float(m_j[key]), rtol=2e-5, atol=1e-9,
                err_msg=f"loss term {key} diverged at step {i}")
        np.testing.assert_allclose(m_t["lr"], float(m_j["lr"]), rtol=1e-6)
        after_j = _flat_of(state_j.params, state_j.batch_stats)
        after_t = module_to_flax(model_t)
        assert set(after_t) == set(after_j) == set(before)
        _assert_updates_close(before, start_t, after_t, after_j, frozen, i)
        for k in after_j:
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(after_t[k], after_j[k],
                                           rtol=1e-6, atol=1e-9, err_msg=k)
                assert not np.array_equal(after_t[k], before[k]), k
        before = start_t = after_j
        # the next step starts from the JAX side's variables on both sides:
        # each step is then compared from a common starting point
        load_flax_variables(model_t, after_j)
    assert state_t.step == 2 and int(state_j.step) == 2
    assert m_t["lr"] < cfg_t.lr  # the schedule moved
    if incremental:
        assert float(m_t["lkd"]) > 0
        assert (float(m_t["l_con"]) > 0) == (method == "UCD")
        for k, v in donor_before.items():
            assert torch.equal(v, old_t[k]), k


def test_lr_schedules_match():
    for policy in ("poly", "step"):
        cfg_t, cfg_j = _cfgs(0, "FT", "float32", lr_policy=policy,
                             lr_decay_step=3)
        st, sj = make_lr_schedule(cfg_t, 10), JE.make_lr_schedule(cfg_j, 10)
        for count in (0, 1, 5, 9, 10, 12):
            np.testing.assert_allclose(st(count), float(sj(count)),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("nan_guard", [False, True])
def test_optimizer_matches_optax(nan_guard):
    """Coupled weight decay, then nesterov momentum, on a small tree over
    four updates against the JAX package's optax chain (f32, rtol 1e-6).
    With `nan_guard`, the update with a non-finite gradient is skipped
    whole and the schedule does not advance; without it the NaN spreads,
    on both sides."""
    from ucd_torch.engine.train import make_optimizer

    cfg_t, cfg_j = _cfgs(0, "FT", "float32", nan_guard=nan_guard)
    rs = np.random.RandomState(5)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2, 2)}
    p0 = {k: rs.randn(*sh).astype(np.float32) for k, sh in shapes.items()}
    grads = [{k: rs.randn(*sh).astype(np.float32) for k, sh in
              shapes.items()} for _ in range(4)]
    grads[2]["b"][3] = np.inf

    tx_j = JE.make_optimizer(cfg_j, TOTAL_ITERS)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_j = tx_j.init(params_j)
    tx_t = make_optimizer(cfg_t, TOTAL_ITERS)
    params_t = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt_t = tx_t.init(params_t)
    for i, g in enumerate(grads):
        upd, opt_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                 opt_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        before = {k: v.clone() for k, v in params_t.items()}
        tx_t.update(params_t, {k: torch.from_numpy(v) for k, v in g.items()},
                    opt_t)
        for k in shapes:
            np.testing.assert_allclose(params_t[k].numpy(),
                                       np.asarray(params_j[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {i}")
        if i == 2 and nan_guard:
            assert all(torch.equal(before[k], params_t[k]) for k in shapes)
    assert opt_t["count"] == (3 if nan_guard else 4)
    assert bool(torch.isfinite(params_t["b"]).all()) == nan_guard


def test_eval_step_matches_jax():
    """f32, fused path on both sides (the JAX kernels in interpret mode,
    the port's plain versions), uint8 images and labels. Tolerance: `loss`
    and `lkd` rtol 1e-5; predictions equal except at near-exact ties, and
    the confusion matrices differ by at most those pixels."""
    cfg_t, cfg_j = _cfgs(1, "MiB", "float32")
    model_j = jax_make_model(cfg_j)
    model_old_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    flat = random_flat_variables(model_j, (SIZE, SIZE), seed=21)
    flat_old = random_flat_variables(model_old_j, (SIZE, SIZE), seed=22)
    eval_j = jax.jit(JE.make_eval_step(cfg_j, model_j, model_old_j))

    model_t = load_flax_variables(make_model(cfg_t), flat)
    model_old_t = make_model(cfg_t, cfg_t.classes_per_step[:-1])
    eval_t = make_eval_step(cfg_t, model_t, model_old_t, device="cpu")
    old_t = flax_to_state_dict(flat_old)

    n = cfg_t.tot_classes
    hist_j = JE.empty_confusion(n)
    hist_t = empty_confusion(n, "cpu")
    n_mism = 0
    for batch in _batches(2, n, seed=23, uint8=True):
        batch["label"] = batch["label"].astype(np.uint8)
        hist_j, m_j, preds_j = eval_j(
            unflatten(flat), {k: jnp.asarray(v) for k, v in batch.items()},
            hist_j, unflatten(flat_old))
        hist_t, m_t, preds_t = eval_t(None, batch, hist_t, old_t)
        for key in ("loss", "lkd"):
            np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                       rtol=1e-5, err_msg=key)
        assert float(m_t["lde"]) == float(m_j["lde"]) == 0.0
        up, _ = model_j.apply(unflatten(flat), jnp.asarray(batch["image"]),
                              train=False)
        assert preds_t.dtype == torch.int32
        assert_argmax_close(preds_t.numpy(), np.asarray(preds_j),
                            np.asarray(up))
        n_mism += int((preds_t.numpy() != np.asarray(preds_j)).sum())
    assert int(hist_t.sum()) == int(np.asarray(hist_j).sum())
    assert np.abs(hist_t.numpy() - np.asarray(hist_j)).sum() <= 2 * n_mism
    # evaluating on an explicit state_dict is the same function
    hist2, m2, preds2 = eval_t(model_t.state_dict(), batch,
                               empty_confusion(n, "cpu"), old_t)
    assert torch.equal(preds2, preds_t) and float(m2["loss"]) == float(
        m_t["loss"])
    # without the donor's variables there is no KD term
    _, m3, _ = eval_t(None, batch, empty_confusion(n, "cpu"))
    assert float(m3["lkd"]) == 0.0


def test_build_train_state_step0_to_step1_matches_jax():
    """Step 0's variables (a JAX init, exported as numpy) go into both
    packages' step-1 `build_train_state`: same merged + imprinted
    parameters, the donor's variables verbatim, zero momentum, step 0."""
    cfg0_t, cfg0_j = _cfgs(0, "MiB", "float32")
    cfg1_t, cfg1_j = _cfgs(1, "MiB", "float32")
    model0_j = jax_make_model(cfg0_j)
    state0, none = JE.build_train_state(cfg0_j, model0_j, jax.random.key(3),
                                        total_iters=TOTAL_ITERS,
                                        input_shape=(1, SIZE, SIZE, 3))
    assert none is None
    prev = {"params": state0.params, "batch_stats": state0.batch_stats}
    flat0 = {k: np.asarray(v) for k, v in
             _flat_of(state0.params, state0.batch_stats).items()}
    flat0 = {k: v.astype(np.float32) for k, v in flat0.items()}

    state1_j, old_j = JE.build_train_state(
        cfg1_j, jax_make_model(cfg1_j), jax.random.key(4),
        total_iters=TOTAL_ITERS, prev_model_state=prev,
        input_shape=(1, SIZE, SIZE, 3))
    model1_t = make_model(cfg1_t)
    state1_t, old_t = build_train_state(
        cfg1_t, model1_t, torch.Generator().manual_seed(4), TOTAL_ITERS,
        prev_model_state=flax_to_state_dict(flat0), device="cpu")

    want = _flat_of(state1_j.params, state1_j.batch_stats)
    got = module_to_flax(model1_t)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0, err_msg=k)
    # the donor: the previous variables verbatim
    from ucd_torch.models import state_dict_to_flax
    donor = state_dict_to_flax(old_t)
    want_old = _flat_of(old_j["params"], old_j["batch_stats"])
    assert set(donor) == set(want_old)
    for k, v in want_old.items():
        np.testing.assert_array_equal(donor[k], v, err_msg=k)
    assert state1_t.step == 0 and state1_t.model is model1_t
    assert state1_t.opt_state["count"] == 0
    assert set(state1_t.opt_state["trace"]) == set(state1_t.params)
    assert all(not t.any() for t in state1_t.opt_state["trace"].values())

    # step 0 on the port side: seeded, reproducible, no donor
    def fresh(seed):
        m = make_model(cfg0_t)
        s, old = build_train_state(cfg0_t, m,
                                   torch.Generator().manual_seed(seed),
                                   TOTAL_ITERS, device="cpu")
        assert old is None
        return m.state_dict()

    a, b, c = fresh(0), fresh(0), fresh(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cls_0.weight"], c["cls_0.weight"])

    # a pretrained body (a state_dict of `model.body`) replaces the body's
    # init and nothing else
    g = torch.Generator().manual_seed(9)
    body = {k: torch.randn(v.shape, generator=g).to(v.dtype)
            for k, v in make_model(cfg0_t).body.state_dict().items()}
    m = make_model(cfg0_t)
    build_train_state(cfg0_t, m, torch.Generator().manual_seed(0),
                      TOTAL_ITERS, pretrained_body=body, device="cpu")
    got = m.state_dict()
    assert all(torch.equal(got["body." + k], v) for k, v in body.items())
    assert all(torch.equal(got[k], a[k]) for k in got
               if not k.startswith("body."))


def _ucd_step_inputs(seed, **kw):
    """A UCD step-1 config with the NHWC tensors `compute_train_losses`
    reads, made from a seed with numpy (f32, 4x4 maps under 64x64 labels)."""
    cfg, _ = _cfgs(1, "UCD", "float32", **kw)
    rs = np.random.RandomState(seed)
    h = SIZE // 16

    def t(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))

    feats = {"sem": t(B, h, h, cfg.tot_classes, scale=2.0),
             "pre_logits": t(B, h, h, 32)}
    feats_old = {"sem": t(B, h, h, cfg.old_classes, scale=2.0),
                 "pre_logits": t(B, h, h, 32)}
    labels = torch.from_numpy(
        _batches(1, cfg.tot_classes, seed + 1)[0]["label"].astype(np.uint8))
    return cfg, feats, labels, feats_old


def test_ucd_losses_tiled_and_dense_paths_agree_at_float32():
    """`compute_train_losses` under --method UCD at f32: the tiled stages
    (`use_pallas_contrastive`, the CPU path of the kernels' wrapper) and the
    dense loss give the same `l_con` (rtol 1e-5) and the same gradient to
    the new model's pre_logits (rtol 1e-4 + 1e-6 of its largest entry, the
    kernel-vs-dense bounds of tests/test_pallas_contrastive.py); `l_con` is
    part of `loss_tot`, carries `contrastive_weight`, and vanishes without a
    donor."""
    from ucd_torch.engine.train import compute_train_losses
    from ucd_torch.ops.tiled_contrastive import pixel_contrastive_loss_tiled

    cfg, feats, labels, feats_old = _ucd_step_inputs(31)
    assert cfg.contrastive and cfg.use_pallas_contrastive
    out = {}
    for name, c in (("tiled", cfg), ("dense", dataclasses.replace(
            cfg, use_pallas_contrastive=False))):
        f = dict(feats, pre_logits=feats["pre_logits"].clone()
                 .requires_grad_(True))
        terms = compute_train_losses(c, None, f, labels, None, feats_old)
        (g,) = torch.autograd.grad(terms["l_con"], f["pre_logits"])
        out[name] = (terms, g)
    (tt, gt), (td, gd) = out["tiled"], out["dense"]
    assert float(td["l_con"].detach()) > 0
    np.testing.assert_allclose(float(tt["l_con"].detach()),
                               float(td["l_con"].detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), gd.numpy(), rtol=1e-4,
                               atol=1e-6 * float(gd.abs().max()))
    for t in (tt, td):
        np.testing.assert_allclose(
            float(t["loss_tot"].detach()),
            float((t["loss"] + t["l_con"] + t["lkd"] + t["lde"]).detach()),
            rtol=1e-6)
    assert pixel_contrastive_loss_tiled.launches_pass1 == 0  # CPU: no kernel
    # the weight is applied once
    double = compute_train_losses(
        dataclasses.replace(cfg, contrastive_weight=0.02), None, feats,
        labels, None, feats_old)
    np.testing.assert_allclose(float(double["l_con"]),
                               2 * float(tt["l_con"].detach()), rtol=1e-6)
    # step 0 (no donor): no contrastive term
    none = compute_train_losses(cfg, None, feats, labels)
    assert float(none["l_con"]) == 0.0


def test_ucd_step_feeds_attended_pre_logits():
    """The UCD step asks both forwards for the attention maps (the
    contrastive term reads the attended pre_logits); the MiB step does
    not."""
    seen = {}
    for method in ("UCD", "MiB"):
        cfg, _ = _cfgs(1, method, "float32")
        m = make_model(cfg)
        mo = make_model(cfg, cfg.classes_per_step[:-1])
        state, old = build_train_state(
            cfg, m, torch.Generator().manual_seed(0), TOTAL_ITERS,
            prev_model_state=mo.state_dict(), device="cpu")
        calls = []
        for mod in (m, mo):
            orig = mod.forward

            def spy(x, upsample=True, attention=True, _orig=orig):
                calls.append(attention)
                return _orig(x, upsample=upsample, attention=attention)
            mod.forward = spy
        step = make_train_step(cfg, m, mo, TOTAL_ITERS, device="cpu")
        _, metrics = step(state, _batches(1, cfg.tot_classes, seed=3)[0],
                          old)
        seen[method] = (calls, float(metrics["l_con"]))
    assert seen["UCD"][0] == [True, True] and seen["UCD"][1] > 0
    assert seen["MiB"][0] == [False, False] and seen["MiB"][1] == 0.0


def test_unported_branches_raise_by_name():
    """No branch is dropped silently. The iCaRL criteria and the
    regularizers are ported: LWF-MC trains (its dense BCE criterion and
    iCaRL term, no fused kernel) and EWC builds its state; `remat` is
    ported and takes a step; `xla_options`, the one TPU-only field left,
    raises on a non-default value, naming the field."""
    def step_for(**kw):
        cfg, _ = _cfgs(1, kw.pop("method", "MiB"), "float32", **kw)
        m = make_model(cfg)
        mo = make_model(cfg, cfg.classes_per_step[:-1])
        return cfg, m, mo

    cfg, m, mo = step_for(method="LWF-MC")
    state, old = build_train_state(cfg, m, torch.Generator().manual_seed(0),
                                   TOTAL_ITERS,
                                   prev_model_state=mo.state_dict(),
                                   device="cpu")
    batch = _batches(1, cfg.tot_classes, seed=1)[0]
    before = m.cls_1.weight.detach().clone()
    _, metrics = make_train_step(cfg, m, mo, TOTAL_ITERS,
                                 device="cpu")(state, batch, old)
    assert float(metrics["l_icarl"]) > 0 and float(metrics["loss"]) > 0
    assert np.isfinite(float(metrics["loss_tot"]))
    assert not torch.equal(before, m.cls_1.weight)
    cfg, m, mo = step_for(method="EWC")
    make_train_step(cfg, m, mo, TOTAL_ITERS, device="cpu")
    state, _ = build_train_state(cfg, m, torch.Generator().manual_seed(0),
                                 TOTAL_ITERS, device="cpu")
    assert state.reg_state.kind == "ewc" and not state.reg_state.penalize
    cfg, m, mo = step_for(remat=True)
    state, old = build_train_state(cfg, m, torch.Generator().manual_seed(0),
                                   TOTAL_ITERS,
                                   prev_model_state=mo.state_dict(),
                                   device="cpu")
    _, metrics = make_train_step(cfg, m, mo, TOTAL_ITERS,
                                 device="cpu")(state, batch, old)
    assert np.isfinite(float(metrics["loss_tot"]))
    assert m.body.remat_blocks == set(m.body.block_names)
    make_eval_step(cfg, m, mo, device="cpu")
    cfg, m, mo = step_for(xla_options="a=b")
    with pytest.raises(NotImplementedError, match="xla_options"):
        make_train_step(cfg, m, mo, TOTAL_ITERS, device="cpu")
    with pytest.raises(NotImplementedError, match="xla_options"):
        make_eval_step(cfg, m, mo, device="cpu")


def test_steps_run_on_cuda_unless_given_a_device():
    """Without `device=`, `make_train_step`, `make_eval_step` and
    `empty_confusion` mean CUDA:
    on a host without a GPU they raise and do not move to the CPU on their
    own; with `device="cpu"` a model that lies elsewhere is refused, and
    `mark` is called around each part of the real step."""
    cfg, _ = _cfgs(0, "FT", "float32")
    m = make_model(cfg)
    state, _ = build_train_state(cfg, m, torch.Generator().manual_seed(0),
                                 TOTAL_ITERS, device="cpu")
    if not torch.cuda.is_available():
        for build in (lambda: make_train_step(cfg, m, None, TOTAL_ITERS),
                      lambda: make_eval_step(cfg, m),
                      lambda: empty_confusion(cfg.tot_classes)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build()
    with pytest.raises(ValueError, match="the model is on meta"):
        make_eval_step(cfg, make_model(cfg).to("meta"), device="cpu")
    marks = []
    step = make_train_step(cfg, m, None, TOTAL_ITERS, device="cpu",
                           mark=marks.append)
    _, metrics = step(state, _batches(1, cfg.tot_classes, seed=2)[0])
    assert marks == ["start", "upload", "donor_forward", "forward", "losses",
                     "backward", "optimizer"]
    assert np.isfinite(float(metrics["loss_tot"])) and state.step == 1
