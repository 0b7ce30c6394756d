"""The method families of the port through `Experiment`, the checkpoint and
the CLI on the CPU.

- EWC / PI / RW across a three-step chain (VOC 15-5s steps 0 -> 1 -> 2),
  as tests/test_reg_crossstep.py drives the JAX package: the importance
  that step k exports into its checkpoint turns the penalty on at step
  k+1, a new classifier weighs 0, the step-1 export is re-accumulated, and
  the step-1 classifier is penalized at step 2.
- A same-step resume under RW (scoring every iteration) is bit-identical to
  the uninterrupted run: parameters, momentum and every accumulator.
- A JAX step checkpoint that holds regularizer state (RW after two
  accumulator updates) imports with its export and snapshot by parameter
  name, bit for bit, and the port's restore puts them in a fresh state.

ResNet-18 keeps the Experiments short: `Config.validate` admits only
resnet50/101, so the fixture of tests/test_torch_experiment_parity.py
patches it for the run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_experiment_parity import r18_configs  # noqa: F401
from test_torch_families import _saved_reg
from test_torch_train_step import (SIZE, TOTAL_ITERS, _cfgs, _flat_of,
                                   _tree)
from torch_port_helpers import random_flat_variables
from ucd_torch import config as TC
from ucd_torch.data import SyntheticSegmentation
from ucd_torch.engine import checkpoint as TK
from ucd_torch.engine.experiment import Experiment
from ucd_torch.engine.state import build_train_state
from ucd_torch.models import (flax_to_state_dict, make_model,
                              state_dict_to_flax)
from ucd_torch.ops import regularizers as TR
from ucd_tpu import engine as JE
from ucd_tpu.engine import checkpoint as JK
from ucd_tpu.models import make_model as jax_make_model
from ucd_tpu.ops import regularizers as JR
from torch_port_helpers import (free_tmp_path,  # noqa: F401 (fixtures)
                                one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "free_tmp_path")

CROP = 32


def _cfg(tmp_path, step, method, name="chain", **kw):
    base = dict(dataset="voc", task="15-5s", step=step, method=method,
                backbone="resnet18", crop_size=CROP, batch_size=4,
                dtype="float32", lr=0.01, epochs=1, overlap=True,
                pretrained=False, visualize=False, num_workers=1,
                logdir=str(tmp_path / "logs"),
                ckpt_dir=str(tmp_path / "ckpt"), name=name)
    base.update(kw)
    return TC.make_config(**base)


@pytest.mark.parametrize("method", ["EWC", "PI", "RW"])
def test_regularizer_carries_across_steps(tmp_path, method, r18_configs):
    bt = SyntheticSegmentation(n=8, size=CROP, n_classes=21, seed=0)
    bv = SyntheticSegmentation(n=4, size=CROP, n_classes=21, seed=1)
    key = "fisher" if method in ("EWC", "RW") else "score"

    exp0 = Experiment(_cfg(tmp_path, 0, method), base_train=bt,
                      base_val=bv, device="cpu")
    assert not exp0.state.reg_state.penalize  # nothing to anchor to yet
    exp0.run()
    exp0.close()
    saved0 = TK.load_reg_saved(exp0.cfg.ckpt_path())
    assert key in saved0 and "cls_1.weight" not in saved0[key]

    exp1 = Experiment(_cfg(tmp_path, 1, method), base_train=bt,
                      base_val=bv, device="cpu")
    rs = exp1.state.reg_state
    assert rs.penalize, "the penalty must be on at step 1"
    assert float(rs.penalty_w["cls_1.weight"].abs().sum()) == 0
    assert float(rs.penalty_w["cls_0.weight"].abs().sum()) > 0
    exp1.run()
    m1 = exp1.last_train_metrics
    assert np.isfinite(m1["l_reg"]) and m1["l_reg"] > 0  # 2nd iteration on
    exp1.close()
    saved1 = TK.load_reg_saved(exp1.cfg.ckpt_path())
    assert set(saved1[key]) == set(saved0[key]) | {"cls_1.weight",
                                                   "cls_1.bias"}
    leaf = next(k for k in saved0[key] if k.startswith("body."))
    assert not torch.equal(saved1[key][leaf], saved0[key][leaf]), \
        "step 1 must re-accumulate the importance, not carry step 0's"

    exp2 = Experiment(_cfg(tmp_path, 2, method), base_train=bt,
                      base_val=bv, device="cpu")
    rs2 = exp2.state.reg_state
    assert rs2.penalize
    assert float(rs2.penalty_w["cls_2.weight"].abs().sum()) == 0
    # the step-1 classifier trained at step 1: protected at step 2
    assert float(rs2.penalty_w["cls_1.weight"].abs().sum()) > 0
    _, m2 = exp2.train_step(exp2.state, next(exp2.train_loader.epoch(0)),
                            exp2.old_vars)
    assert np.isfinite(float(m2["l_reg"])) and float(m2["l_reg"]) == 0.0
    exp2.close()


def test_same_step_resume_with_regularizer_is_bit_identical(
        tmp_path, r18_configs):
    """RW scoring every iteration: 3 epochs uninterrupted against 2
    epochs, a checkpoint and a resumed third."""
    bt = SyntheticSegmentation(n=8, size=CROP, n_classes=21, seed=3)
    bv = SyntheticSegmentation(n=4, size=CROP, n_classes=21, seed=1)
    kw = dict(epochs=3, val_interval=5, reg_iterations=1)
    expA = Experiment(_cfg(tmp_path, 0, "RW", name="A", **kw),
                      base_train=bt, base_val=bv, device="cpu")
    expA.run()
    cfgB = _cfg(tmp_path, 0, "RW", name="B", **kw)
    expB = Experiment(cfgB, base_train=bt, base_val=bv, device="cpu")
    for ep in range(2):
        expB.train_epoch(ep)
        expB.cur_epoch += 1
    expB.save(1, 0.0)
    expB.close()
    expC = Experiment(dataclasses.replace(cfgB, ckpt=cfgB.ckpt_path()),
                      base_train=bt, base_val=bv, device="cpu")
    rsB, rsC = expB.state.reg_state, expC.state.reg_state
    assert int(rsC.count) == int(rsB.count) == 2 * len(expB.train_loader)
    expC.run()
    rsA, rsC = expA.state.reg_state, expC.state.reg_state
    assert int(rsA.count) == int(rsC.count) == 3 * len(expA.train_loader)
    for field in TR.MEMBER_FIELDS:
        a, c = getattr(rsA, field), getattr(rsC, field)
        assert (a is None) == (c is None), field
        for k in a or {}:
            assert torch.equal(a[k], c[k]), (field, k)
    assert float(rsA.score["cls_0.weight"].abs().sum()) > 0
    sa, sc = expA.model.state_dict(), expC.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    for k, v in expA.state.opt_state["trace"].items():
        assert torch.equal(v, expC.state.opt_state["trace"][k]), k
    for exp in (expA, expC):
        exp.close()


def test_jax_checkpoint_with_regularizer_state_imports(tmp_path):
    """A JAX RW state at VOC 15-5s step 1 from a seeded export, after two
    accumulator updates, saved by orbax with its export and snapshot:
    `import_jax_checkpoint` and the bridge script carry both over by
    parameter name, bit for bit, and `restore_full` copies the snapshot
    into the port's fresh state."""
    import types
    from test_torch_checkpoint import _bridge

    cfg_t, cfg_j = _cfgs(1, "RW", "float32", reg_iterations=1)
    model0_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    flat0 = random_flat_variables(model0_j, (SIZE, SIZE), seed=11)
    flat1 = random_flat_variables(jax_make_model(cfg_j), (SIZE, SIZE),
                                  seed=12)
    saved_j, saved_t = _saved_reg(cfg_t, flat0, 7)
    saved_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                     saved_j)
    saved_t = {k: {n: v.float() for n, v in d.items()}
               for k, d in saved_t.items()}
    params = _tree(flat1, "params", jnp.float32)
    # the JAX functions under jit: eager, each op compiles per shape
    rs_j = jax.jit(lambda p, o, s: JR.init_reg_state(
        "rw", p, o, s, iterations=1))(params, _tree(flat0, "params",
                                                    jnp.float32), saved_j)
    # two iterations' accumulator updates, with seeded gradients and moved
    # parameters (what a train step hands the regularizer)
    rs = np.random.RandomState(13)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rs.randn(*p.shape), jnp.float32), params)
    moved = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(1e-2 * rs.randn(*p.shape), jnp.float32),
        params)
    update = jax.jit(JR.update)
    rs_j = update(update(rs_j, grads, params), grads, moved)
    export_j = jax.jit(JR.export_state)(rs_j, moved)
    state_j = types.SimpleNamespace(
        params=moved, batch_stats=_tree(flat1, "batch_stats", jnp.float32),
        opt_state=jax.jit(JE.make_optimizer(cfg_j, TOTAL_ITERS).init)(moved),
        step=jnp.asarray(2))
    ckpt_dir = str(tmp_path / "jax_rw")
    JK.save_checkpoint(ckpt_dir, state_j, epoch=0, best_score=0.0,
                       reg_saved=export_j, reg_full=JR.export_full(rs_j))

    def assert_equal(port, jax_tree, what):
        got, want = state_dict_to_flax(port), _flat_of(jax_tree)
        assert set(got) == set(want), what
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=what + k)

    ck = TK.import_jax_checkpoint(JK.load_checkpoint(ckpt_dir))
    ts = ck["trainer_state"]
    assert ts["regularizer_full"]["count"] == int(rs_j.count) == 2
    for field in ("fisher", "score", "prev_params", "saved_score"):
        assert_equal(ts["regularizer_full"][field], getattr(rs_j, field),
                     field)
    for field in ("fisher", "score"):
        assert_equal(ts["regularizer"][field], export_j[field], field)

    # the bridge writes them into the port's file; a resume restores them
    out = str(tmp_path / "port_ck")
    _bridge().convert(ckpt_dir, out)
    loaded = TK.load_checkpoint(out)
    state_t, _ = build_train_state(
        cfg_t, make_model(cfg_t), torch.Generator().manual_seed(1),
        TOTAL_ITERS, prev_model_state=flax_to_state_dict(flat0),
        prev_reg_saved=saved_t, device="cpu")
    TR.restore_full(state_t.reg_state, TK.load_reg_full(loaded))
    assert int(state_t.reg_state.count) == 2
    for field in ("fisher", "score", "prev_params", "saved_score"):
        assert_equal(getattr(state_t.reg_state, field), getattr(rs_j, field),
                     field)
    for field in ("fisher", "score"):
        assert_equal(TK.load_reg_saved(out)[field], export_j[field], field)
