"""The port's step checkpoints: exact save/load round trips (sync and
async), the JAX package's schema error, the import of a JAX step checkpoint
(one further float64 train step then agrees with JAX's to the bounds of
tests/test_torch_train_step.py), the bridge script, and `export_inference`
from an imported checkpoint against the JAX package's export, bit for bit.

ResNet-18 at 64x64 keeps the file in tier-1 time; `Config.validate` admits
only resnet50/101, so the backbone is set after `make_config` on both
sides, as in tests/test_torch_train_step.py."""

import dataclasses
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (B, SIZE, TOTAL_ITERS, _assert_updates_close,
                                   _batches, _cfgs, _flat_of, _jax_state,
                                   _tree)
from torch_port_helpers import random_flat_variables
from ucd_torch.engine import checkpoint as TK
from ucd_torch.engine.export import export_inference, load_inference
from ucd_torch.engine.predictor import Predictor
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import make_train_step
from ucd_torch.models import (flax_to_state_dict, make_model,
                              module_to_flax, state_dict_to_flax)
from ucd_tpu import engine as JE
from ucd_tpu.engine import checkpoint as JK
from ucd_tpu.engine import export as JX
from ucd_tpu.models import make_model as jax_make_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _port_state(seed=0, step=0, method="FT"):
    cfg, _ = _cfgs(step, method, "float32")
    model = make_model(cfg)
    state, _ = build_train_state(cfg, model,
                                 torch.Generator().manual_seed(seed),
                                 TOTAL_ITERS, device="cpu")
    return cfg, model, state


def _trained_port_state():
    """A state after one train step: non-zero momentum, count 1, step 1,
    moved BN statistics and counters."""
    cfg, model, state = _port_state()
    step = make_train_step(cfg, model, None, TOTAL_ITERS, device="cpu")
    batch = _batches(1, cfg.tot_classes, seed=3, uint8=True)[0]
    state, _ = step(state, batch)
    return cfg, model, state


def _assert_tree_equal(a, b, what=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), what
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b.to(a.device)), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("async_write", [False, True])
def test_save_load_round_trip_is_exact(tmp_path, async_write):
    cfg, model, state = _trained_port_state()
    assert state.opt_state["count"] == 1 and state.step == 1
    path = str(tmp_path / "ck" / "step0")
    TK.save_checkpoint(path, state, epoch=3, best_score=0.25,
                       async_write=async_write)
    # the snapshot is the state at the call: later updates are not saved
    saved = {k: v.clone() for k, v in state.params.items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ck = TK.load_checkpoint(path)  # waits for an in-flight write
    TK.check_schema(ck, path)
    assert (ck["epoch"], ck["best_score"], ck["step"]) == (3, 0.25, 1)
    _assert_tree_equal(ck["model_state"]["params"], saved, "params")
    _assert_tree_equal(ck["model_state"]["batch_stats"],
                       dict(model.named_buffers()), "batch_stats")
    _assert_tree_equal(ck["optimizer_state"], state.opt_state, "opt")
    assert "trainer_state" not in ck
    assert any(int(v) > 0 for k, v in ck["model_state"]["batch_stats"].items()
               if k.endswith("num_batches_tracked"))
    # restore_like puts the loaded optimizer state in the template's layout
    back = TK.restore_like(state.opt_state, ck["optimizer_state"])
    _assert_tree_equal(back, state.opt_state, "restored opt")
    for k, t in back["trace"].items():
        assert t.stride() == state.opt_state["trace"][k].stride(), k
    assert TK.load_model_state(path)["params"].keys() == saved.keys()
    assert TK.load_reg_saved(path) is None and TK.load_reg_full(ck) is None
    assert TK.load_checkpoint(str(tmp_path / "missing")) is None


def test_failed_async_write_reraises_on_next_save(tmp_path, monkeypatch):
    _, _, state = _port_state()
    real = TK._write

    def broken(path, payload):
        raise OSError("disk full")
    monkeypatch.setattr(TK, "_write", broken)
    TK.save_checkpoint(str(tmp_path / "a"), state, 0, 0.0, async_write=True)
    monkeypatch.setattr(TK, "_write", real)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        TK.save_checkpoint(str(tmp_path / "b"), state, 0, 0.0)
    assert not os.path.exists(tmp_path / "a")
    assert not os.path.exists(tmp_path / "b")
    TK.save_checkpoint(str(tmp_path / "b"), state, 0, 0.0)  # error consumed
    assert TK.load_checkpoint(str(tmp_path / "b"))["step"] == 0
    TK.wait_pending()


def test_schema_errors_match_jax(tmp_path):
    for bad in ({"model_state": {"params": {}}},
                {"epoch": 0, "best_score": 0, "model_state": {"params": {}},
                 "optimizer_state": {}, "step": 0},
                {"epoch": 0}):
        with pytest.raises(ValueError, match="schema") as et:
            TK.check_schema(bad, "/x/ck")
        with pytest.raises(ValueError) as ej:
            JK.check_schema(bad, "/x/ck")
        assert str(et.value) == str(ej.value)
    _, _, state = _port_state()
    with pytest.raises(ValueError, match="expected dict keys"):
        TK.restore_like(state.opt_state, {"trace": {}, "count": 0})
    trace = {k: torch.zeros(1) for k in state.opt_state["trace"]}
    with pytest.raises(ValueError, match="leaf shape"):
        TK.restore_like(state.opt_state, {"trace": trace, "count": 0,
                                          "nonfinite": 0})
    # an orbax directory is refused, naming the bridge (never None: a
    # step would then train without its donor)
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(ValueError, match="jax_ckpt_to_torch.py"):
        TK.load_checkpoint(str(tmp_path / "orbax_dir"))


def _jax_step1_checkpoint(tmp_path, dtype, nan_guard=False):
    """JAX side: UCD step 1 of VOC 15-5s from a seeded step-0 tree, one
    train step, then its orbax checkpoint. Returns (cfgs, jax state, donor
    variables, step fn, step-0 tree, batches, checkpoint dir)."""
    cfg_t, cfg_j = _cfgs(1, "UCD", dtype, nan_guard=nan_guard)
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    model0_j = jax_make_model(cfg_j, classes=cfg_j.classes_per_step[:-1])
    flat0 = random_flat_variables(model0_j, (SIZE, SIZE), seed=11)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    prev = {"params": _tree(flat0, "params", jdt),
            "batch_stats": _tree(flat0, "batch_stats", jdt)}
    model_j = jax_make_model(cfg_j)
    state_j, old_j = JE.build_train_state(
        cfg_j, model_j, jax.random.key(1), total_iters=TOTAL_ITERS,
        prev_model_state=prev, input_shape=(1, SIZE, SIZE, 3))
    state_j = state_j.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jdt), state_j.batch_stats))
    step_j = jax.jit(JE.make_train_step(cfg_j, model_j, model0_j,
                                        total_iters=TOTAL_ITERS))
    batches = _batches(2, cfg_t.tot_classes, seed=12)
    state_j, _ = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                  batches[0].items()}, old_j)
    ckpt_dir = str(tmp_path / "jax_ckpt")
    JK.save_checkpoint(ckpt_dir, state_j, epoch=0, best_score=0.125)
    return (cfg_t, cfg_j), state_j, old_j, step_j, flat0, batches, ckpt_dir


def test_imported_jax_checkpoint_trains_on_as_jax_does(tmp_path, x64):
    """A JAX UCD step-1 state after one f64 train step, saved by orbax and
    imported: the port's parameters, statistics and momentum equal JAX's
    exactly, count / step / epoch carry over, and one further train step
    on each side agrees to the f64 step test's bounds (loss terms rtol
    2e-5; per-leaf updates |e| <= 2e-4 |ref| + 3e-6 max|ref|, global 1e-4;
    cls_0 frozen; BN statistics rtol 1e-6)."""
    (cfg_t, _), state_j, old_j, step_j, flat0, batches, ckpt_dir = \
        _jax_step1_checkpoint(tmp_path, "float64")
    ck = TK.import_jax_checkpoint(JK.load_checkpoint(ckpt_dir))
    assert (ck["epoch"], ck["best_score"], ck["step"]) == (0, 0.125, 1)
    assert ck["optimizer_state"]["count"] == 1
    assert ck["optimizer_state"]["nonfinite"] == 0

    model_t = make_model(cfg_t)
    model_old_t = make_model(cfg_t, cfg_t.classes_per_step[:-1])
    state_t, old_t = build_train_state(
        cfg_t, model_t, torch.Generator().manual_seed(1), TOTAL_ITERS,
        prev_model_state=flax_to_state_dict(flat0), device="cpu")
    # the port's own file, then the same-step restore Experiment does
    path = str(tmp_path / "port_ckpt")
    TK.save_checkpoint(path, types.SimpleNamespace(
        params=ck["model_state"]["params"],
        batch_stats=ck["model_state"]["batch_stats"],
        opt_state=ck["optimizer_state"], step=ck["step"]), 0, 0.125)
    loaded = TK.load_checkpoint(path)
    model_t.load_state_dict(TK.state_dict_of(loaded["model_state"]))
    state_t.opt_state = TK.restore_like(state_t.opt_state,
                                        loaded["optimizer_state"])
    state_t.step.fill_(loaded["step"])

    before = _flat_of(state_j.params, state_j.batch_stats)
    start_t = module_to_flax(model_t)
    assert set(start_t) == set(before)
    for k, v in before.items():
        np.testing.assert_array_equal(start_t[k], v, err_msg=k)
    trace_j = _flat_of(state_j.opt_state[1][0].trace)
    trace_t = state_dict_to_flax(state_t.opt_state["trace"])
    assert set(trace_t) == set(trace_j)
    for k, v in trace_j.items():
        np.testing.assert_array_equal(trace_t[k], v, err_msg=k)
    assert state_t.opt_state["count"] == int(state_j.opt_state[1][1].count)

    step_t = make_train_step(cfg_t, model_t, model_old_t, TOTAL_ITERS,
                             device="cpu")
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in
                                    batches[1].items()}, old_j)
    state_t, m_t = step_t(state_t, batches[1], old_t)
    for key in ("loss", "lkd", "lde", "l_con", "l_icarl", "l_reg",
                "loss_tot"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=2e-5, atol=1e-9, err_msg=key)
    # the schedule's position carried over: the rate of the step at index 1
    np.testing.assert_allclose(m_t["lr"], float(m_j["lr"]), rtol=1e-6)
    assert m_t["lr"] < cfg_t.lr and float(m_t["l_con"]) > 0
    after_j = _flat_of(state_j.params, state_j.batch_stats)
    after_t = module_to_flax(model_t)
    _assert_updates_close(before, start_t, after_t, after_j,
                          "params/cls_0/", 1)
    for k in after_j:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(after_t[k], after_j[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    assert state_t.step == int(state_j.step) == 2
    assert state_t.opt_state["count"] == 2


def _bridge():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts",
                                          "jax_ckpt_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_f32_checkpoint(tmp_path, nan_guard):
    """A seeded f32 ResNet-18 VOC 15-5s step-1 state of the JAX package
    (no train step), saved by orbax."""
    _, cfg_j = _cfgs(1, "MiB", "float32", nan_guard=nan_guard)
    model_j = jax_make_model(cfg_j)
    flat = random_flat_variables(model_j, (SIZE, SIZE), seed=31)
    state_j = _jax_state(cfg_j, model_j, flat, jnp.float32)
    ckpt_dir = str(tmp_path / "jax_f32")
    JK.save_checkpoint(ckpt_dir, state_j, epoch=2, best_score=0.5)
    return cfg_j, model_j, flat, ckpt_dir


def test_bridge_script_converts_a_jax_checkpoint(tmp_path, capsys):
    """scripts/jax_ckpt_to_torch.py, under --nan_guard (optax's
    apply_if_finite wraps the optimizer state): the port reads the file it
    writes, and the variables are the JAX checkpoint's."""
    _, _, flat, ckpt_dir = _jax_f32_checkpoint(tmp_path, nan_guard=True)
    out = str(tmp_path / "port" / "ck")
    assert _bridge().main([ckpt_dir, out]) == 0
    assert "heads ['cls_0', 'cls_1']" in capsys.readouterr().out
    ck = TK.check_schema(TK.load_checkpoint(out), out)
    assert (ck["epoch"], ck["best_score"], ck["step"]) == (2, 0.5, 0)
    assert ck["optimizer_state"]["count"] == 0
    assert ck["optimizer_state"]["nonfinite"] == 0
    got = state_dict_to_flax(TK.state_dict_of(ck["model_state"]))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(FileNotFoundError):
        _bridge().convert(str(tmp_path / "nothing"), out)


def test_export_from_imported_checkpoint_matches_jax_export(tmp_path):
    """The JAX checkpoint exported by both packages (the port's from the
    imported file): the same keys, f32 arrays and bf16 bit patterns equal,
    the same meta header; the port serves the JAX-written npz with the same
    predictions as the model restored from its own checkpoint."""
    cfg_j, model_j, flat, ckpt_dir = _jax_f32_checkpoint(tmp_path, False)
    cfg_t, _ = _cfgs(1, "MiB", "float32")
    port_ckpt = str(tmp_path / "port_ck")
    _bridge().convert(ckpt_dir, port_ckpt)
    images = np.random.RandomState(5).randint(
        0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    for dtype in ("float32", "bfloat16"):
        mj = JX.export_inference(ckpt_dir, str(tmp_path / f"j_{dtype}"),
                                 cfg_j, dtype)
        mt = export_inference(port_ckpt, str(tmp_path / f"t_{dtype}"),
                              cfg_t, dtype)
        assert mt["path"].endswith(".npz")
        with np.load(mj["path"]) as zj, np.load(mt["path"]) as zt:
            assert set(zj.files) == set(zt.files)
            for k in zj.files:
                assert zt[k].dtype == zj[k].dtype, k
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
            meta = json.loads(bytes(zt["__ucd_tpu_meta__"]).decode())
        assert meta == {k: v for k, v in mj.items() if k != "path"}
        assert meta["classes"] == [16, 1] and meta["dtype"] == dtype
        served, _ = load_inference(mj["path"], device="cpu")
        got = Predictor(served, device="cpu").predict_labels(images)
        if dtype == "float32":
            ck = TK.load_checkpoint(port_ckpt)
            own = make_model(cfg_t)
            own.load_state_dict(TK.state_dict_of(ck["model_state"]))
            want = Predictor(own, device="cpu").predict_labels(images)
        else:
            ported, _ = load_inference(mt["path"], device="cpu")
            want = Predictor(ported, device="cpu").predict_labels(images)
        assert torch.equal(got, want)
    # the class list comes from the checkpoint's heads, not the flags
    cfg_other, _ = _cfgs(0, "FT", "float32")
    meta = export_inference(port_ckpt, str(tmp_path / "o.npz"), cfg_other,
                            "float32")
    assert meta["classes"] == [16, 1]
    with pytest.raises(FileNotFoundError):
        export_inference(str(tmp_path / "none"), str(tmp_path / "x.npz"),
                         cfg_t)
