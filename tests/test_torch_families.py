"""The remaining method families of the port against the JAX package: the
losses that iCaRL (LWF-MC), the BCE criterion and the unwired masked
variants use, and composed float64 train steps of iCaRL combined, iCaRL
disjoint and `--bce`.

- Losses (f32, seeded numpy logits with ignored pixels): each function of
  ucd_torch/ops/losses.py that ucd_tpu/ops/losses.py has beside the
  step's CE/KD terms, rtol 1e-5 / atol 1e-6.
- Steps: VOC 15-5s step 1 from one seeded step-0 tree, two iterations at
  float64 (ResNet-18, 64x64, batch 2), each from the JAX side's variables,
  as tests/test_torch_train_step.py does: loss terms rtol 2e-5 / atol 1e-9
  (the JAX losses round through f32), per-tensor updates |e| <= 2e-4 |ref|
  + 3e-6 max|ref| and 1e-4 over all, frozen tensors unchanged. The new
  classifier starts from the JAX side's init on both sides (neither preset
  imprints it). `run_composed` is shared with
  tests/test_torch_regularizers.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (B, SIZE, TOTAL_ITERS,
                                   _assert_updates_close, _batches, _cfgs,
                                   _flat_of, _tree)
from torch_port_helpers import random_flat_variables, unflatten
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import make_eval_step, make_train_step
from ucd_torch.models import (flax_to_state_dict, load_flax_variables,
                              make_model, module_to_flax, state_dict_to_flax)
from ucd_torch.ops import losses as TL
from ucd_tpu import engine as JE
from ucd_tpu.models import make_model as jax_make_model
from ucd_tpu.ops import losses as JL
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TERMS = ("loss", "lkd", "lde", "l_con", "l_icarl", "l_reg", "loss_tot")


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _loss_inputs(seed=0, C=7, n_old=4):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(2, 8, 8, C) * 2).astype(np.float32)
    old = (rs.randn(2, 8, 8, n_old) * 2).astype(np.float32)
    labels = rs.randint(0, C, (2, 8, 8)).astype(np.int32)
    labels[0, :3, :3] = 255
    mask = rs.randint(0, 2, (2, 8, 8)).astype(np.int32)
    return logits, old, labels, mask


LOSS_CASES = {
    "focal": lambda M, z, o, y, m: M.focal_loss(z, y),
    "focal_sum": lambda M, z, o, y, m: M.focal_loss(
        z, y, alpha=0.5, gamma=1.5, size_average=False),
    "one_hot_ignore": lambda M, z, o, y, m: M._one_hot_ignore(y, 7),
    "bce_elementwise": lambda M, z, o, y, m: M._bce_with_logits(
        z, M._one_hot_ignore(y, 7)),
    "bce_mean": lambda M, z, o, y, m: M.bce_with_logits_ignore(z, y),
    "bce_mean_all": lambda M, z, o, y, m: M.bce_with_logits_ignore(
        z, y, reduction="mean_all"),
    "bce_sum": lambda M, z, o, y, m: M.bce_with_logits_ignore(
        z, y, reduction="sum"),
    "bce_none": lambda M, z, o, y, m: M.bce_with_logits_ignore(
        z, y, reduction="none"),
    "icarl": lambda M, z, o, y, m: M.icarl_loss(z, y, _sigmoid(M, o)),
    "icarl_bkg": lambda M, z, o, y, m: M.icarl_loss(
        z, y, _sigmoid(M, o), bkg=True),
    "icarl_none": lambda M, z, o, y, m: M.icarl_loss(
        z, y, _sigmoid(M, o), reduction="none"),
    "icarl_combined": lambda M, z, o, y, m: M.icarl_combined_loss(
        z, o, 10.0),
    "mask_ce": lambda M, z, o, y, m: M.mask_cross_entropy(z, y, 4),
    "mask_ce_old": lambda M, z, o, y, m: M.mask_cross_entropy(
        z, y, 4, outputs_old=o),
    "mask_ce_sum": lambda M, z, o, y, m: M.mask_cross_entropy(
        z, y, 4, outputs_old=o, reduction="sum"),
    "mask_kd": lambda M, z, o, y, m: M.mask_knowledge_distillation(z, o),
    "mask_kd_mask": lambda M, z, o, y, m: M.mask_knowledge_distillation(
        z, o, alpha=2.0, mask=m),
}


def _sigmoid(M, x):
    return torch.sigmoid(x) if M is TL else jax.nn.sigmoid(x)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(case):
    z, o, y, m = _loss_inputs()
    fn = LOSS_CASES[case]
    got = fn(TL, *(torch.from_numpy(a) for a in (z, o, y, m)))
    want = np.asarray(fn(JL, *(jnp.asarray(a) for a in (z, o, y, m))))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                               err_msg=case)


def _saved_reg(cfg_t, flat0, seed):
    """A previous step's regularizer export, seeded and positive, as the
    JAX tree and the port's dict by parameter name."""
    rs = np.random.RandomState(seed)
    keys = {"ewc": ("fisher",), "pi": ("score", "delta"),
            "rw": ("score", "fisher")}[cfg_t.regularizer]
    flat = {name: {k: np.abs(rs.randn(*v.shape)) * 10.0 ** rs.randint(-4, 1)
                   for k, v in flat0.items() if k.startswith("params/")}
            for name in keys}
    jax_tree = {name: unflatten({k[len("params/"):]: jnp.asarray(v) for
                                 k, v in f.items()})
                for name, f in flat.items()}
    port = {name: flax_to_state_dict(f) for name, f in flat.items()}
    return jax_tree, port


def _reg_flat(rs, field, jax_side):
    tree = getattr(rs, field)
    if tree is None:
        return None
    if jax_side:
        return _flat_of(tree)
    return {k: v.astype(np.float64) for k, v in
            state_dict_to_flax(tree).items()}


REG_FIELDS = ("fisher", "delta", "score", "prev_params", "penalty_w",
              "old_params", "saved_score")


def _assert_reg_close(rs_t, rs_j, when):
    """Every accumulator of the two regularizer states, tensor by tensor:
    |e| <= 1e-5 |ref| + 1e-12 (the gradients carry the JAX losses' f32
    rounding); the iteration count exact."""
    assert rs_t.kind == rs_j.kind and rs_t.penalize == rs_j.penalize
    assert int(rs_t.count) == int(rs_j.count), when
    for field in REG_FIELDS:
        a, b = _reg_flat(rs_t, field, False), _reg_flat(rs_j, field, True)
        assert (a is None) == (b is None), (when, field)
        if a is None:
            continue
        assert set(a) == set(b), (when, field)
        for k in b:
            err = float(np.linalg.norm(a[k] - b[k]))
            ref = float(np.linalg.norm(b[k]))
            assert err <= 1e-5 * ref + 1e-12, (when, field, k, err, ref)


def jax_step1_state(cfg_j, model_j, flat0, saved_j):
    """The JAX package's step-1 state at float64, as `build_train_state`
    makes it (the step-0 tree merged into the new model's, optimizer and
    regularizer state from their init functions), without flax's eager
    init: the new classifier is a seeded numpy draw and the init
    functions run under jit. Returns (state, donor variables)."""
    from ucd_tpu.engine.train import TrainState
    from ucd_tpu.ops import regularizers as JR

    flat = random_flat_variables(model_j, (SIZE, SIZE), seed=13)
    flat.update(flat0)
    params = _tree(flat, "params", jnp.float64)
    old = {"params": _tree(flat0, "params", jnp.float64),
           "batch_stats": _tree(flat0, "batch_stats", jnp.float64)}
    reg = None
    if cfg_j.regularizer is not None:
        reg = jax.jit(lambda p, o, sv: JR.init_reg_state(
            cfg_j.regularizer, p, old_params=o, saved=sv,
            alpha=cfg_j.reg_alpha, iterations=cfg_j.reg_iterations,
            normalize=cfg_j.reg_normalize))(params, old["params"], saved_j)
    state = TrainState(
        params=params, batch_stats=_tree(flat, "batch_stats", jnp.float64),
        opt_state=jax.jit(JE.make_optimizer(cfg_j, TOTAL_ITERS).init)(
            params),
        reg_state=reg, step=jnp.zeros((), jnp.int32))
    return state, old


def run_composed(method, reg_seed=None, n_iter=2, **kw):
    """Two float64 iterations of VOC 15-5s step 1 under `method` on both
    sides, each from the JAX side's variables. Returns the port's metrics
    of each iteration."""
    cfg_t, cfg_j = _cfgs(1, method, "float64", **kw)
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    model0_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    flat0 = random_flat_variables(model0_j, (SIZE, SIZE), seed=11)
    saved_j = saved_t = None
    if cfg_t.regularizer is not None:
        saved_j, saved_t = _saved_reg(cfg_t, flat0, reg_seed)

    model_j = jax_make_model(cfg_j)
    state_j, old_j = jax_step1_state(cfg_j, model_j, flat0, saved_j)
    step_j = jax.jit(JE.make_train_step(cfg_j, model_j, model0_j,
                                        total_iters=TOTAL_ITERS))

    model_t = make_model(cfg_t)
    model_old_t = make_model(cfg_t, cfg_t.classes_per_step[:-1])
    state_t, old_t = build_train_state(
        cfg_t, model_t, torch.Generator().manual_seed(1), TOTAL_ITERS,
        prev_model_state=flax_to_state_dict(flat0), prev_reg_saved=saved_t,
        device="cpu")
    before = _flat_of(state_j.params, state_j.batch_stats)
    # the new classifier's init is the JAX side's; so are the regularizer's
    # copies of the starting parameters
    load_flax_variables(model_t, before)
    rs_t = state_t.reg_state
    if rs_t is not None:
        with torch.no_grad():
            for k, p in model_t.named_parameters():
                if rs_t.prev_params is not None:
                    rs_t.prev_params[k].copy_(p)
                if k not in old_t:
                    rs_t.old_params[k].copy_(p)
        _assert_reg_close(rs_t, state_j.reg_state, "init")
    step_t = make_train_step(cfg_t, model_t, model_old_t, TOTAL_ITERS,
                             device="cpu")
    start_t = module_to_flax(model_t)
    history = []
    for i, batch in enumerate(_batches(n_iter, cfg_t.tot_classes,
                                       seed=12)):
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, old_j)
        state_t, m_t = step_t(state_t, batch, old_t)
        for key in TERMS:
            np.testing.assert_allclose(
                float(m_t[key]), float(m_j[key]), rtol=2e-5, atol=1e-9,
                err_msg=f"{method}: {key} diverged at step {i}")
        np.testing.assert_allclose(float(m_t["lr"]), float(m_j["lr"]),
                                   rtol=1e-6)
        after_j = _flat_of(state_j.params, state_j.batch_stats)
        _assert_updates_close(before, start_t, module_to_flax(model_t),
                              after_j, "params/cls_0/", i)
        if rs_t is not None:
            _assert_reg_close(rs_t, state_j.reg_state, f"step {i}")
        history.append({k: float(v) for k, v in m_t.items()})
        before = start_t = after_j
        load_flax_variables(model_t, after_j)
    return history


@pytest.mark.parametrize("method,kw", [
    ("LWF-MC", {}), ("LWF-MC", {"icarl_disjoint": True}),
    ("FT", {"bce": True})], ids=["icarl_combined", "icarl_disjoint", "bce"])
def test_composed_family_steps_match_jax_at_float64(method, kw, x64):
    history = run_composed(method, **kw)
    for m in history:
        assert np.isfinite(m["loss_tot"]) and m["loss"] > 0
        assert (m["l_icarl"] > 0) == (method == "LWF-MC"
                                      and not kw.get("icarl_disjoint"))


def test_icarl_disjoint_validate_and_contrastive_gate():
    """iCaRL's disjoint mode: the validate step's criterion is the iCaRL
    loss against the donor's logits (the JAX eval step's), and the train
    step computes no contrastive term even when the config asks for one."""
    cfg_t, cfg_j = _cfgs(1, "LWF-MC", "float32", icarl_disjoint=True)
    model_j = jax_make_model(cfg_j)
    model_old_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    flat = random_flat_variables(model_j, (SIZE, SIZE), seed=21)
    flat_old = random_flat_variables(model_old_j, (SIZE, SIZE), seed=22)
    eval_j = jax.jit(JE.make_eval_step(cfg_j, model_j, model_old_j))
    model_t = load_flax_variables(make_model(cfg_t), flat)
    model_old_t = make_model(cfg_t, cfg_t.classes_per_step[:-1])
    eval_t = make_eval_step(cfg_t, model_t, model_old_t, device="cpu")
    batch = _batches(1, cfg_t.tot_classes, seed=23, uint8=True)[0]
    hist = JE.empty_confusion(cfg_t.tot_classes)
    _, m_j, _ = eval_j(unflatten(flat), {k: jnp.asarray(v) for k, v in
                                         batch.items()}, hist,
                       unflatten(flat_old))
    from ucd_torch.engine.metrics import empty_confusion
    _, m_t, _ = eval_t(None, batch, empty_confusion(cfg_t.tot_classes,
                                                    "cpu"),
                       flax_to_state_dict(flat_old))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)

    from ucd_torch.engine.train import compute_train_losses
    cfg_c = dataclasses.replace(cfg_t, contrastive=True)
    rs = np.random.RandomState(3)
    h = SIZE // 16

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    labels = torch.from_numpy(batch["label"].astype(np.int64))
    feats = {"sem": t(B, h, h, cfg_t.tot_classes), "pre_logits": t(B, h, h,
                                                                   16)}
    feats_old = {"sem": t(B, h, h, cfg_t.old_classes),
                 "pre_logits": t(B, h, h, 16)}
    for disjoint, con in ((True, 0.0), (False, None)):
        c = dataclasses.replace(cfg_c, icarl_disjoint=disjoint)
        terms = compute_train_losses(c, None, feats, labels, None,
                                     feats_old)
        if con is not None:
            assert float(terms["l_con"]) == con
        else:
            assert float(terms["l_con"]) > 0 and float(terms["l_icarl"]) > 0
