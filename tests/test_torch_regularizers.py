"""The EWC / PI / RW regularizers of the port (ucd_torch/ops/regularizers.py)
against the JAX package's (ucd_tpu/ops/regularizers.py), and composed
float64 train steps of the three presets against `make_train_step`.

- Functions, at float64 on parameters of a VOC 15-5s step-1 ResNet-18
  (body and head tensors and both classifiers; the new classifier absent
  from the donor and from the saved importance): `init_reg_state` from a
  seeded previous-step export, three `update`s (RW scoring every 2
  iterations), `penalty`, `penalty_grad`,
  `export_state` (RW's average over the names its saved score holds),
  `export_full` and `restore_full` onto a fresh state: every tensor within
  rtol 1e-12 / atol 1e-15 of the JAX value, counts exact.
- Steps: tests/test_torch_families.py's `run_composed` (two iterations from
  the JAX side's variables, its bounds) from a seeded previous-step export,
  so the penalty is on: loss terms including `l_reg` rtol 2e-5 / atol
  1e-9, every accumulator of the state per tensor 1e-5 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import run_composed
from test_torch_train_step import _cfgs, _flat_of
from torch_port_helpers import unflatten
from ucd_torch.models import make_model, state_dict_to_flax
from ucd_torch.ops import regularizers as TR
from ucd_tpu.ops import regularizers as JR
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _tree(d):
    """The port's name -> tensor dict as the JAX package's tree."""
    return unflatten({k[len("params/"):]: jnp.asarray(v) for k, v in
                      state_dict_to_flax(d).items()})


def _close(port, jax_tree, what):
    a = {k: v.astype(np.float64) for k, v in state_dict_to_flax(port).items()}
    b = _flat_of(jax_tree)
    assert set(a) == set(b), what
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-15,
                                   err_msg=f"{what} {k}")


def _param_sets(seed):
    """Shapes of a subset of the model's parameters (two body tensors, the
    head's last conv and norm, both classifiers), the donor's names among
    them, and a seeded draw."""
    cfg, _ = _cfgs(1, "MiB", "float64")
    every = dict(make_model(cfg).named_parameters())
    body = [k for k in every if k.startswith("body.")][:2]
    head = [k for k in every if k.startswith("head.")][-3:]
    names = {k: every[k].shape for k in body + head + [
        "cls_0.weight", "cls_0.bias", "cls_1.weight", "cls_1.bias"]}
    old = set(make_model(cfg, cfg.classes_per_step[:-1]).state_dict())
    rs = np.random.RandomState(seed)

    def draw(keys, scale=1.0, positive=False):
        out = {}
        for k in keys:
            v = rs.randn(*names[k]) * scale
            out[k] = torch.from_numpy(np.abs(v) if positive else v)
        return out
    old_keys = [k for k in names if k in old]
    return names, old_keys, draw


@pytest.mark.parametrize("kind,normalize", [
    ("ewc", True), ("pi", True), ("rw", True), ("rw", False)])
def test_regularizer_functions_match_jax(kind, normalize, x64):
    names, old_keys, draw = _param_sets(3)
    params = draw(names)
    old_params = draw(old_keys)
    saved = {key: draw(old_keys, 1e-2, positive=True) for key in
             {"ewc": ("fisher",), "pi": ("score", "delta"),
              "rw": ("fisher", "score")}[kind]}
    kw = dict(alpha=0.7, iterations=2, normalize=normalize)
    rs_t = TR.init_reg_state(kind, params, old_params, saved, **kw)
    rs_j = JR.init_reg_state(kind, _tree(params), _tree(old_params),
                             {k: _tree(v) for k, v in saved.items()}, **kw)
    assert rs_t.penalize and rs_j.penalize
    assert float(rs_t.penalty_w["cls_1.weight"].abs().sum()) == 0

    def check(what):
        assert int(rs_t.count) == int(rs_j.count), what
        for field in TR.MEMBER_FIELDS + ("penalty_w", "old_params"):
            if getattr(rs_j, field) is None:
                assert getattr(rs_t, field) is None, (what, field)
            else:
                _close(getattr(rs_t, field), getattr(rs_j, field),
                       f"{what} {field}")
    check("init")
    for i in range(3):
        params = {k: p + 1e-2 * torch.from_numpy(
            np.random.RandomState(10 + i).randn(*p.shape))
            for k, p in params.items()}
        grads = draw(names, 0.1)
        TR.update(rs_t, grads, params)
        rs_j = JR.update(rs_j, _tree(grads), _tree(params))
        check(f"update {i}")
    pj = JR.penalty(rs_j, _tree(params))
    np.testing.assert_allclose(float(TR.penalty(rs_t, params)), float(pj),
                               rtol=1e-12)
    value, grad = TR.penalty_and_grad(rs_t, params, 3.0)
    np.testing.assert_allclose(float(value), 3.0 * float(pj), rtol=1e-12)
    _close(grad, JR.penalty_grad(rs_j, _tree(params), 3.0), "penalty_grad")
    _close(TR.penalty_grad(rs_t, params, 3.0),
           JR.penalty_grad(rs_j, _tree(params), 3.0), "penalty_grad")
    ex_t, ex_j = TR.export_state(rs_t, params), \
        JR.export_state(rs_j, _tree(params))
    assert set(ex_t) == set(ex_j)
    for key in ex_j:
        _close(ex_t[key], ex_j[key], f"export {key}")
    # same-step snapshot onto a fresh state: the same accumulators
    full = TR.export_full(rs_t)
    fresh = TR.init_reg_state(kind, params, old_params, saved, **kw)
    assert TR.restore_full(fresh, full) is fresh
    for field in TR.MEMBER_FIELDS:
        if getattr(rs_t, field) is not None:
            for k, v in getattr(rs_t, field).items():
                assert torch.equal(getattr(fresh, field)[k], v), (field, k)
    assert int(fresh.count) == int(rs_t.count) == 3 * (kind != "ewc")
    with pytest.raises(ValueError, match="does not match"):
        TR.restore_full(TR.init_reg_state(kind, params), {
            "count": 1, "fisher": {"x": torch.zeros(1)}})
    # no saved importance: no penalty; no kind: no state
    assert not TR.init_reg_state(kind, params, old_params).penalize
    assert TR.penalty(TR.init_reg_state(kind, params), params) is None
    assert TR.init_reg_state(None, params) is None


@pytest.mark.parametrize("method,kw", [
    ("EWC", {}), ("PI", {}), ("RW", {"reg_iterations": 1})])
def test_composed_regularizer_steps_match_jax_at_float64(method, kw, x64):
    history = run_composed(method, reg_seed=5, **kw)
    assert history[0]["l_reg"] == 0.0  # the donor's parameters: no penalty
    assert history[1]["l_reg"] > 0
    for m in history:
        assert np.isfinite(m["loss_tot"])
        # the penalty is reported, not part of loss_tot (the JAX step's)
        assert abs(m["loss_tot"] - m["loss"]) <= 1e-12 * abs(m["loss"])
