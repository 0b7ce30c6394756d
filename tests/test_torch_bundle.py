"""K train steps per call (`make_train_bundle`, `--steps_per_call`) and the
device-resident optimizer state it needs, on the CPU.

- The schedule computed on the device from a count tensor, poly and step,
  against the JAX package's `make_lr_schedule`: rtol 1e-6 in f32 (its `pow`
  may round 1 ulp apart), 1e-12 in f64.
- `nan_guard`'s select on the device against optax.apply_if_finite over a
  run of skips, a reset, and 101 non-finite updates in a row (the 101st is
  applied): parameters rtol 1e-6 / atol 1e-7 (NaN where optax has NaN), the
  skip count and the schedule's count exact.
- `make_train_bundle(k=3)` against the JAX package's `make_train_bundle` at
  float64 from one seeded numpy tree (FT step 0, ResNet-18, 64x64, batch
  4): the stacked metrics within tests/test_bundle.py's rtol 1e-6 / atol
  1e-9; the three steps' parameter updates within the f64 step test's
  bounds (tests/test_torch_train_step.py: per tensor |e| <= 2e-4 |ref| +
  3e-6 max|ref|, 1e-4 over all), since the JAX losses round through f32
  and the gradients carry that rounding.
- A bundled `Experiment` epoch against the per-step epoch (3 batches at K
  = 2: one bundle and the per-step tail; then a loader that yields a short
  batch mid-epoch), bit for bit: on the CPU the bundle runs the very step
  the per-step path runs.

The capture itself (CUDA graphs) runs only on the card: `chip_smoke.py`
holds 12 bundled full-width UCD steps against 12 eager ones bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train_step import (_assert_updates_close, _cfgs,
                                   _flat_of, _jax_state)
from torch_port_helpers import random_flat_variables
from ucd_torch import config as TC
from ucd_torch.data import SyntheticSegmentation
from ucd_torch.engine import make_train_bundle
from ucd_torch.engine.experiment import Experiment
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import make_lr_schedule, make_optimizer
from ucd_torch.models import load_flax_variables, make_model, module_to_flax
from ucd_tpu import engine as JE
from ucd_tpu.models import make_model as jax_make_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOTAL = 16


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("policy", ["poly", "step"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_schedule_matches_jax(policy, dtype):
    cfg_t, cfg_j = _cfgs(0, "FT", "float32", lr_policy=policy,
                         lr_decay_step=3, lr_power=0.9)
    tdt = getattr(torch, dtype)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        st = make_lr_schedule(cfg_t, 10)
        sj = jax.jit(JE.make_lr_schedule(cfg_j, 10))
        for count in (0, 1, 2, 5, 9, 10, 12, 31):
            got = st(torch.tensor(count), tdt)
            want = np.asarray(sj(jnp.asarray(count)))
            assert got.dtype == tdt and got.ndim == 0
            assert want.dtype == np.dtype(dtype)
            np.testing.assert_allclose(
                got.numpy(), want, atol=0,
                rtol=1e-6 if dtype == "float32" else 1e-12,
                err_msg=f"{policy} {dtype} count {count}")
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_nan_guard_select_matches_optax_over_101_in_a_row():
    cfg_t, cfg_j = _cfgs(0, "FT", "float32", nan_guard=True)
    rs = np.random.RandomState(7)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2, 2)}
    p0 = {k: rs.randn(*sh).astype(np.float32) for k, sh in shapes.items()}
    # finite, 3 skips, finite (resets), then 101 non-finite in a row (the
    # last one applied: NaN from there on, on both sides), then finite
    kinds = ["ok"] + ["inf"] * 3 + ["ok"] + ["nan"] * 101 + ["ok"]
    grads = []
    for kind in kinds:
        g = {k: rs.randn(*sh).astype(np.float32) for k, sh in
             shapes.items()}
        if kind == "inf":
            g["c"][0, 1, 0, 1] = -np.inf
        elif kind == "nan":
            g["a"][2, 1] = np.nan
        grads.append(g)
    tx_j = JE.make_optimizer(cfg_j, 200)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_j = tx_j.init(params_j)

    @jax.jit
    def upd(g, opt, params):
        u, opt = tx_j.update(g, opt, params)
        return optax.apply_updates(params, u), opt

    tx_t = make_optimizer(cfg_t, 200)
    params_t = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt_t = tx_t.init(params_t)
    for i, (kind, g) in enumerate(zip(kinds, grads)):
        params_j, opt_j = upd({k: jnp.asarray(v) for k, v in g.items()},
                              opt_j, params_j)
        before = {k: v.clone() for k, v in params_t.items()}
        tx_t.update(params_t, {k: torch.from_numpy(v) for k, v in
                               g.items()}, opt_t)
        for k in shapes:
            np.testing.assert_allclose(params_t[k].numpy(),
                                       np.asarray(params_j[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} update {i}")
        assert int(opt_t["nonfinite"]) == int(opt_j.notfinite_count), i
        assert int(opt_t["count"]) == int(opt_j.inner_state[1][1].count), i
        skipped = kind != "ok" and int(opt_j.notfinite_count) <= 100
        assert all(torch.equal(before[k], params_t[k]) for k in shapes) \
            == skipped, i
    # 2 + 1 (the 101st non-finite, applied) + 1 = 4 applied updates
    assert int(opt_t["count"]) == 4
    assert not bool(torch.isfinite(params_t["a"]).all())


def test_bundle_matches_jax_bundle_at_float64(x64):
    b, size, k = 4, 64, 3
    cfg_t, cfg_j = _cfgs(0, "FT", "float64", batch_size=b)
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False)
    model_j = jax_make_model(cfg_j)
    flat = random_flat_variables(model_j, (size, size), seed=41)
    state_j = _jax_state(cfg_j, model_j, flat, jnp.float64)
    state_j = state_j.replace(opt_state=JE.make_optimizer(
        cfg_j, TOTAL).init(state_j.params))
    rs = np.random.RandomState(42)
    batches = {
        "image": rs.randint(0, 256, (k, b, size, size, 3)).astype(np.uint8),
        "label": rs.randint(0, cfg_t.tot_classes,
                            (k, b, size, size)).astype(np.uint8)}
    batches["label"][:, 0, :8, :8] = 255
    bundle_j = jax.jit(JE.make_train_bundle(cfg_j, model_j, None, TOTAL,
                                            k=k))
    state_j, m_j = bundle_j(state_j, {key: jnp.asarray(v) for key, v in
                                      batches.items()})

    model_t = make_model(cfg_t)
    state_t, _ = build_train_state(cfg_t, model_t,
                                   torch.Generator().manual_seed(0), TOTAL,
                                   device="cpu")
    load_flax_variables(model_t, flat)
    bundle_t = make_train_bundle(cfg_t, model_t, None, TOTAL, k=k,
                                 device="cpu")
    state_t, m_t = bundle_t(state_t, batches)
    assert bundle_t.capture is None  # the CPU runs the step K times

    assert set(m_t) == set(m_j)
    for key, v in m_t.items():
        assert v.shape == (k,), key
        np.testing.assert_allclose(v.numpy(), np.asarray(m_j[key]),
                                   rtol=1e-6, atol=1e-9, err_msg=key)
    assert float(m_t["lr"][2]) < float(m_t["lr"][0]) == cfg_t.lr
    assert int(state_t.step) == int(state_j.step) == k
    assert int(state_t.opt_state["count"]) == k
    start = {key: v.astype(np.float64) for key, v in flat.items()
             if key.startswith("params/")}
    _assert_updates_close(start, start, module_to_flax(model_t),
                          _flat_of(state_j.params), None, k)
    with pytest.raises(ValueError, match="expected 3 stacked batches"):
        bundle_t(state_t, {key: v[:2] for key, v in batches.items()})


SIZE, B = 32, 4


def _experiment(tmp_path, tag, spc, n=12):
    cfg = TC.make_config(
        dataset="voc", task="19-1", step=0, method="FT", epochs=1,
        batch_size=B, crop_size=SIZE, backbone="resnet50", dtype="float32",
        pretrained=False, overlap=True, lr=0.01, steps_per_call=spc,
        print_interval=2, num_workers=1, logdir=str(tmp_path / f"log{tag}"),
        ckpt_dir=str(tmp_path / f"ck{tag}"), name=f"bundle{tag}")
    tr = SyntheticSegmentation(n=n, size=SIZE, n_classes=21, seed=0)
    va = SyntheticSegmentation(n=B, size=SIZE, n_classes=21, seed=1)
    return Experiment(cfg, base_train=tr, base_val=va, device="cpu")


def _assert_same_run(exp1, m1, exp2, m2):
    for key in ("loss_tot", "loss", "lr", "l_reg"):
        assert m1[key] == m2[key], (key, m1[key], m2[key])
    s1, s2 = exp1.model.state_dict(), exp2.model.state_dict()
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key
    for key, v in exp1.state.opt_state["trace"].items():
        assert torch.equal(v, exp2.state.opt_state["trace"][key]), key
    assert int(exp1.state.step) == int(exp2.state.step)
    assert int(exp1.state.opt_state["count"]) == \
        int(exp2.state.opt_state["count"])


def test_bundled_experiment_epoch_equals_per_step(tmp_path, monkeypatch):
    """12 images at batch 4 = 3 steps: at K = 2 one bundle of two steps,
    then the tail of one through the per-step path; the same bits as
    steps_per_call = 1."""
    exp1 = _experiment(tmp_path, "a", 1)
    assert exp1.train_bundle is None
    m1 = exp1.train_epoch(0)
    exp2 = _experiment(tmp_path, "b", 2)
    calls = []
    bundle = exp2.train_bundle

    def counting(state, batches, old_vars=None):
        calls.append(tuple(batches["label"].shape))
        return bundle(state, batches, old_vars)
    monkeypatch.setattr(exp2, "train_bundle", counting)
    m2 = exp2.train_epoch(0)
    assert calls == [(2, B, SIZE, SIZE)]
    _assert_same_run(exp1, m1, exp2, m2)
    assert int(exp2.state.step) == 3
    for exp in (exp1, exp2):
        exp.close()


def test_bundled_epoch_keeps_a_short_batch_in_order(tmp_path):
    """A loader that yields [full, short, full, full] at K = 2: the
    buffered full batch is trained before the short one, then one bundle;
    the trajectory is the per-step one, bit for bit."""
    rs = np.random.RandomState(5)
    seq = [{"image": rs.randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8),
            "label": rs.randint(0, 20, (n, SIZE, SIZE)).astype(np.uint8)}
           for n in (B, 2, B, B)]

    class SeqLoader:
        batch_size = B

        def __len__(self):
            return len(seq)

        def epoch(self, epoch):
            return iter([dict(b) for b in seq])

        def close(self):
            pass

    runs = []
    for tag, spc in (("a", 1), ("b", 2)):
        exp = _experiment(tmp_path, tag, spc)
        exp.train_loader = SeqLoader()
        runs.append((exp, exp.train_epoch(0)))
    (exp1, m1), (exp2, m2) = runs
    _assert_same_run(exp1, m1, exp2, m2)
    assert int(exp2.state.step) == 4
    for exp, _ in runs:
        exp.close()
