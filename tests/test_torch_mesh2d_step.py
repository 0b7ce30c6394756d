"""The port's train step on a 2 x 2 data x model mesh of four gloo ranks
against the JAX package's step on the global batch and the port's own
one-process step, at float64 with ResNet-18 (64x64 crops, global batch
2: one image a data rank), `min_size` 64, so that every width from 64 to
512 is sharded over the model axis (the classifiers, 16 and 1 outputs,
stay replicated).

JAX runs its unchanged step on channel-sharded state
(tests/test_sharding.py::test_2d_mesh_matches_single_device); the port's
ranks each hold a shard (tests/torch_mesh2d_workers.py) and the step's
collectives carry the model axis. The ranks' shards are put back
together (`unshard_state`) and held under tests/test_torch_dp_step.py's
bounds: loss terms rtol 2e-5 / atol 1e-9; per-leaf updates |e| <= 2e-4
|ref| + 3e-6 max|ref| and 1e-4 over all; BatchNorm running statistics
rtol 1e-6 / atol 1e-9; `cls_0` exactly unchanged. Bits across ranks:
every replicated tensor the same on each model group's ranks, every
shard the same on each data group's.

Two cases: FT at step 0 (the JAX test's own case) and UCD at step 1 with
the contrastive term through the tiled stages' plain versions (the main
path). tests/test_torch_mesh2d_step_mixed.py runs UCD at `min_size` 512,
tests/test_torch_mesh2d_proof.py holds the step's collectives and its
ranks' bytes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
import torch_mesh2d_workers as M
from test_torch_train_step import (_assert_updates_close, _batches, _cfgs,
                                   _flat_of, _tree)
from torch_port_helpers import free_tmp_path  # noqa: F401 (fixture)
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import random_flat_variables
from test_torch_families import jax_step1_state
from ucd_torch.engine.state import unshard_state
from ucd_torch.models import flax_to_state_dict, state_dict_to_flax
from ucd_tpu import engine as JE
from ucd_tpu.models import make_model as jax_make_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_DATA, N_MODEL, MIN_SIZE = 2, 2, 64


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@functools.lru_cache(maxsize=None)
def jax_reference(method, step):
    """The start of `method` at `step` (step 1: tests/test_torch_dp_step.py's
    `start`; step 0: one seeded tree) and one JAX step on the global batch
    from it: (spec for the port's ranks, JAX variables after, JAX
    metrics)."""
    cfg_t, cfg_j = _cfgs(step, method, "float64")
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    model_j = jax_make_model(cfg_j)
    if step:
        model0_j = jax_make_model(cfg_j,
                                  classes=cfg_j.classes_per_step[:-1])
        flat0 = random_flat_variables(model0_j, (W.SIZE, W.SIZE), seed=11)
        state_j, old_j = jax_step1_state(cfg_j, model_j, flat0, None)
    else:
        # the state of `flat`, as tests/test_torch_families.py's
        # `jax_step1_state` makes it (no eager flax init)
        from ucd_tpu.engine.train import TrainState
        model0_j = flat0 = old_j = None
        flat = random_flat_variables(model_j, (W.SIZE, W.SIZE), seed=11)
        params = _tree(flat, "params", jnp.float64)
        state_j = TrainState(
            params=params,
            batch_stats=_tree(flat, "batch_stats", jnp.float64),
            opt_state=jax.jit(JE.make_optimizer(cfg_j, W.TOTAL_ITERS).init)(
                params),
            reg_state=None, step=jnp.zeros((), jnp.int32))
    spec = {"method": method, "step": step, "flat0": flat0, "kw": {},
            "before": _flat_of(state_j.params, state_j.batch_stats),
            "batches": _batches(1, cfg_t.tot_classes, seed=12)}
    step_j = jax.jit(JE.make_train_step(cfg_j, model_j, model0_j,
                                        total_iters=W.TOTAL_ITERS))
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                    spec["batches"][0].items()}, old_j)
    return (spec, _flat_of(state_j.params, state_j.batch_stats),
            {k: float(v) for k, v in m_j.items()})


def assert_step_close(got, before, after_j, m_j, frozen, what):
    """`got` (a snapshot) against the reference step, under
    tests/test_torch_dp_step.py's bounds; `frozen` the prefix of the
    leaves that must not move (None at step 0)."""
    for key in W.TERMS:
        np.testing.assert_allclose(
            got["metrics"][key], m_j[key], rtol=2e-5, atol=1e-9,
            err_msg=f"{what}: loss term {key}")
    np.testing.assert_allclose(got["metrics"]["lr"], m_j["lr"], rtol=1e-6)
    after = got["vars"]
    assert set(after) == set(after_j) == set(before)
    _assert_updates_close(before, before, after, after_j, frozen, what)
    for k in after_j:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(after[k], after_j[k], rtol=1e-6,
                                       atol=1e-9, err_msg=f"{what}: {k}")
            assert not np.array_equal(after[k], before[k]), k


def one_process_step(spec):
    """The port's one-process step on the global batch (no group)."""
    _, model, state, old, step = M.build(spec)
    state, m = step(state, spec["batches"][0], old)
    return W.snapshot(model, state, m)


def run_mesh(spec, tmp_path, min_size):
    """The 2 x 2 step: every rank's saved result, by rank."""
    torch.save(W.as_tensors(spec), tmp_path / "spec.pt")
    W.run_ranks(M.step_worker, N_DATA * N_MODEL, tmp_path,
                str(tmp_path / "spec.pt"), str(tmp_path), N_DATA, N_MODEL,
                min_size)
    return [torch.load(tmp_path / f"mesh{r}.pt")
            for r in range(N_DATA * N_MODEL)]


def check_bits_across_ranks(ranks):
    """Replicated tensors bit-equal across each model group; shards
    bit-equal across each data group; the metrics equal everywhere."""
    by_place = {r["place"]: r for r in ranks}
    sharded = set(ranks[0]["sharded"])
    assert all(set(r["sharded"]) == sharded for r in ranks)
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        d, m = r["place"]
        for what in ("sd", "trace"):
            for k, v in r[what].items():
                other = by_place[(d, 0)] if k not in sharded \
                    else by_place[(0, m)]
                assert torch.equal(v, other[what][k]), (r["place"], what, k)
    return by_place


def unsharded_snapshot(ranks, like, min_size):
    """The model group of data row 0 put back together, as a `snapshot`."""
    by_place = {r["place"]: r for r in ranks}
    shards = [by_place[(0, m)]["sd"] for m in range(N_MODEL)]
    full = unshard_state(shards, like, min_size)
    return {"vars": {k: np.asarray(v, np.float64) for k, v in
                     state_dict_to_flax(full).items()},
            "metrics": ranks[0]["metrics"]}


def check_mesh_step(method, step, min_size, tmp_path):
    """The 2 x 2 step at `min_size` against the JAX step and the port's
    one-process step; returns (the ranks' results, the full state dict
    before the step)."""
    spec, after_j, m_j = jax_reference(method, step)
    like = flax_to_state_dict(spec["before"])
    ranks = run_mesh(spec, tmp_path, min_size)
    check_bits_across_ranks(ranks)
    got = unsharded_snapshot(ranks, like, min_size)
    one = one_process_step(spec)
    frozen = "params/cls_0/" if step else None
    assert_step_close(got, spec["before"], after_j, m_j, frozen,
                      "2 x 2 mesh")
    assert_step_close(one, spec["before"], after_j, m_j, frozen,
                      "one process")
    assert_step_close(got, spec["before"], one["vars"], one["metrics"],
                      frozen, "2 x 2 mesh vs one process")
    if method == "UCD":
        assert got["metrics"]["l_con"] > 0 and got["metrics"]["lkd"] > 0
    return ranks, like


@pytest.mark.parametrize("method,step", [("FT", 0), ("UCD", 1)],
                         ids=["ft_step0", "ucd_step1"])
def test_2x2_mesh_matches_the_global_batch_step(method, step, free_tmp_path,
                                                x64):
    ranks, like = check_mesh_step(method, step, MIN_SIZE, free_tmp_path)
    sharded = set(ranks[0]["sharded"])
    # every body and head width (64 .. 2048) shards at min_size 64; the
    # classifiers stay replicated
    assert not any(k.startswith("cls_") for k in sharded)
    assert all(k in sharded for k, v in like.items()
               if k.startswith(("body.", "head.")) and v.ndim >= 1)
