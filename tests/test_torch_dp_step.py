"""The port's train step on two gloo ranks against the JAX package's step
on the global batch, at float64 with ResNet-18 (64x64 crops, global batch
2: one image a rank, so every train-mode BatchNorm, the ASPP pooling
branch's 1x1 one included, has statistics only over the global batch).

The JAX package runs one SPMD program over the global batch; the port's
two ranks each take their shard (tests/torch_dp_workers.py) and must
compute the same step: what the port's own one-process step computes on
the global batch, and what `ucd_tpu.engine.make_train_step` computes, up
to reduction order. Bounds, those of tests/test_torch_train_step.py: loss
terms rtol 2e-5 / atol 1e-9; per-leaf updates |e| <= 2e-4 |ref| + 3e-6
max|ref| and 1e-4 over all; BatchNorm running statistics rtol 1e-6 /
atol 1e-9; frozen leaves (`cls_0`) exactly unchanged. The two ranks hold
the same bits after the step.

This file: UCD step 1 with the contrastive term through the dense loss and
through the tiled stages' plain versions (`use_pallas_contrastive`), and a
2-slot bundle over two ranks against two eager two-rank steps, bit for
bit. tests/test_torch_dp_step_families.py runs MiB and LWF-MC,
tests/test_torch_dp_step_reg.py RW (a file each keeps each under a
minute on one worker).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from test_torch_families import _saved_reg, jax_step1_state
from test_torch_train_step import (_assert_updates_close, _batches, _cfgs,
                                   _flat_of)
from torch_port_helpers import free_tmp_path  # noqa: F401 (fixture)
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import random_flat_variables
from ucd_tpu import engine as JE
from ucd_tpu.models import make_model as jax_make_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

assert W.SIZE == 64


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def start(method, reg_seed=None, n_batches=1):
    """The step-1 start of tests/test_torch_families.py's `run_composed`
    and `n_batches` global batches: (spec for the port's ranks, JAX cfg,
    model, donor model, state, donor variables)."""
    cfg_t, cfg_j = _cfgs(1, method, "float64")
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    model0_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    flat0 = random_flat_variables(model0_j, (W.SIZE, W.SIZE), seed=11)
    saved_j = saved_t = None
    if cfg_t.regularizer is not None:
        saved_j, saved_t = _saved_reg(cfg_t, flat0, reg_seed)
    model_j = jax_make_model(cfg_j)
    state_j, old_j = jax_step1_state(cfg_j, model_j, flat0, saved_j)
    spec = {"method": method, "flat0": flat0,
            "before": _flat_of(state_j.params, state_j.batch_stats),
            "saved": saved_t,
            "batches": _batches(n_batches, cfg_t.tot_classes, seed=12)}
    return spec, cfg_j, model_j, model0_j, state_j, old_j


@functools.lru_cache(maxsize=None)
def jax_reference(method, reg_seed=None):
    """One JAX step on the global batch from `start`: (spec, JAX
    variables after, JAX metrics, JAX regularizer state)."""
    spec, cfg_j, model_j, model0_j, state_j, old_j = start(method, reg_seed)
    step_j = jax.jit(JE.make_train_step(cfg_j, model_j, model0_j,
                                        total_iters=W.TOTAL_ITERS))
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                    spec["batches"][0].items()}, old_j)
    return (spec, _flat_of(state_j.params, state_j.batch_stats),
            {k: float(v) for k, v in m_j.items()}, state_j.reg_state)


def one_rank_step(spec):
    """The port's one-process step on the global batch (no group)."""
    _, model, state, old, step, _ = W.build_port(spec)
    state, m = step(state, spec["batches"][0], old)
    return W.snapshot(model, state, m)


def two_rank_step(spec, tmp_path):
    torch.save(W.as_tensors(spec), tmp_path / "spec.pt")
    W.run_ranks(W.step_worker, 2, tmp_path, str(tmp_path / "spec.pt"),
                str(tmp_path))
    r0, r1 = (W.as_arrays(torch.load(tmp_path / f"step{r}.pt"))
              for r in (0, 1))
    # replicated: the two ranks hold the same bits after the step
    for key in r0:
        if isinstance(r0[key], dict) and "vars" in r0[key]:
            assert r0[key]["metrics"] == r1[key]["metrics"], key
            for k, v in r0[key]["vars"].items():
                np.testing.assert_array_equal(v, r1[key]["vars"][k],
                                              err_msg=k)
    return r0


def assert_step_close(got, before, after_j, m_j, what):
    """`got` (a snapshot) against the JAX step, under the bounds of
    tests/test_torch_train_step.py."""
    for key in W.TERMS:
        np.testing.assert_allclose(
            got["metrics"][key], m_j[key], rtol=2e-5, atol=1e-9,
            err_msg=f"{what}: loss term {key}")
    np.testing.assert_allclose(got["metrics"]["lr"], m_j["lr"], rtol=1e-6)
    after = got["vars"]
    assert set(after) == set(after_j) == set(before)
    _assert_updates_close(before, before, after, after_j, "params/cls_0/",
                          what)
    for k in after_j:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(after[k], after_j[k], rtol=1e-6,
                                       atol=1e-9, err_msg=f"{what}: {k}")
            assert not np.array_equal(after[k], before[k]), k


def check_method(method, tmp_path, kw=None, reg_seed=None):
    """Two ranks against the port's one-process step and the JAX step;
    returns (two-rank snapshot, JAX regularizer state)."""
    spec, after_j, m_j, reg_j = jax_reference(method, reg_seed)
    spec = {**spec, "kw": kw or {}}
    two = two_rank_step(spec, tmp_path)["step"]
    one = one_rank_step(spec)
    assert_step_close(two, spec["before"], after_j, m_j, "two ranks")
    assert_step_close(one, spec["before"], after_j, m_j, "one process")
    # two ranks against the port's one-process step, the same bounds
    assert_step_close(two, spec["before"], one["vars"], one["metrics"],
                      "two ranks vs one process")
    return two, reg_j


@pytest.mark.parametrize("kw", [{"use_pallas_contrastive": False}, {}],
                         ids=["dense", "tiled_plain"])
def test_ucd_two_ranks_match_the_global_batch_step(kw, free_tmp_path, x64):
    two, _ = check_method("UCD", free_tmp_path, kw)
    assert two["metrics"]["l_con"] > 0 and two["metrics"]["lkd"] > 0


def test_two_slot_bundle_equals_two_eager_steps_at_two_ranks(free_tmp_path,
                                                             x64):
    spec = {**start("UCD", n_batches=2)[0], "kw": {}, "bundle": True}
    got = two_rank_step(spec, free_tmp_path)
    assert got["bundle_rows"] == got["eager_rows"]
    for k, v in got["eager"]["vars"].items():
        np.testing.assert_array_equal(got["bundle"]["vars"][k], v,
                                      err_msg=k)
    assert all(r["l_con"] > 0 for r in got["eager_rows"])
