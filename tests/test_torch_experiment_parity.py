"""A step-1 UCD `Experiment` of the port against the JAX package's at
float64, from one shared step-0 checkpoint (written by JAX, imported into
the port): one epoch of two iterations, then the final test.

It runs at ResNet-18 as the step tests do: `Config.validate` admits only
resnet50/101, so both packages' `validate` is patched here to check a
resnet101 copy of the config instead. Batch 4: at batch 2 the ASPP
pooling branch's BatchNorm normalizes two values per channel, and the
second step's update then amplifies the first step's rounding beyond the
f64 step test's bounds (tests/test_torch_train_step.py compares every step
from a common start for that reason)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _assert_updates_close, _flat_of, _tree
from torch_port_helpers import random_flat_variables
from ucd_torch import config as TC
from ucd_torch.engine import checkpoint as TK
from ucd_torch.engine.experiment import Experiment
from ucd_torch.models import module_to_flax
from ucd_torch.models.segmentation import resize_bilinear

# ---------------------------------------------------------------------------

R18 = 64


@pytest.fixture
def r18_configs(monkeypatch):
    """Both packages' `validate` check a resnet101 copy of a resnet18
    config (the backbone assert is the only check it fails)."""
    from ucd_tpu import config as JC
    for mod in (TC, JC):
        orig = mod.Config.validate

        def validate(self, orig=orig):
            orig(dataclasses.replace(self, backbone="resnet101")
                 if self.backbone == "resnet18" else self)
            return self
        monkeypatch.setattr(mod.Config, "validate", validate)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_step1_experiment_matches_jax_at_float64(tmp_path, r18_configs):
    """One step-0 checkpoint (a seeded tree written by the JAX package,
    imported into the port), then VOC 15-5s step 1 under --method UCD
    (MiB imprinting: cls_1 is deterministic) for one epoch of two
    iterations and the final test, in both packages. Bounds, those of the
    f64 step test: the epoch's mean losses rtol 2e-5 / atol 1e-9 (the JAX
    losses round through f32); the epoch's parameter updates per leaf
    |e| <= 2e-4 |ref| + 3e-6 max|ref| and 1e-4 over all leaves, and the
    BN statistics' changes per leaf at the same bound; the
    final confusion matrices equal up to pixels whose top-2 upsampled logits
    are within 1e-4, the final mIoU within 1e-6."""
    from ucd_tpu import config as JC
    from ucd_tpu.data import SyntheticSegmentation as JSynth
    from ucd_tpu.engine import checkpoint as JK
    from ucd_tpu.engine import experiment as JX
    from ucd_tpu.engine import train as JT
    from ucd_tpu.models import make_model as jax_make_model

    common = dict(dataset="voc", task="15-5s", crop_size=R18, batch_size=4,
                  dtype="float64", lr=0.01, epochs=1, print_interval=1,
                  pretrained=False, overlap=True, num_workers=1,
                  visualize=False, random_seed=3)
    cfgs = {}
    for name, M in (("t", TC), ("j", JC)):
        for step in (0, 1):
            cfg = M.make_config(
                step=step, method="FT" if step == 0 else "UCD",
                logdir=str(tmp_path / name / "logs"),
                ckpt_dir=str(tmp_path / name / "ckpt"), **common)
            cfgs[name, step] = dataclasses.replace(cfg, backbone="resnet18")
    cfgs["j", 1] = dataclasses.replace(cfgs["j", 1], fused_loss=False,
                                       use_pallas_contrastive=False)
    assert cfgs["t", 1].init_balanced and cfgs["t", 1].contrastive

    # the shared step-0 checkpoint: a seeded tree, one orbax file
    model0_j = jax_make_model(cfgs["j", 0])
    flat0 = random_flat_variables(model0_j, (R18, R18), seed=11)
    params = _tree(flat0, "params", jnp.float64)
    state0 = JT.TrainState(
        params=params, batch_stats=_tree(flat0, "batch_stats", jnp.float64),
        opt_state=JT.make_optimizer(cfgs["j", 0], 10).init(params),
        reg_state=None, step=jnp.zeros((), jnp.int32))
    JK.save_checkpoint(cfgs["j", 0].ckpt_path(), state0, 0, 0.0)
    ck = TK.import_jax_checkpoint(JK.load_checkpoint(cfgs["j", 0].ckpt_path()))
    TK.save_checkpoint(cfgs["t", 0].ckpt_path(), _ns(ck), 0, 0.0)

    # synthetic bases: every train image holds the new class 16
    base_train = JSynth(n=8, size=R18, n_classes=17, seed=5)
    base_train.labels[:, :6, :6] = 16
    base_val = JSynth(n=3, size=R18, n_classes=17, seed=6)

    exp_j = JX.Experiment(cfgs["j", 1], base_train=base_train,
                          base_val=base_val)
    exp_t = Experiment(cfgs["t", 1], base_train=base_train,
                       base_val=base_val, device="cpu")
    assert len(exp_t.train_loader) == len(exp_j.train_loader) == 2
    before_t = module_to_flax(exp_t.model)
    before_j = _flat_of(exp_j.state.params, exp_j.state.batch_stats)
    for k, v in before_j.items():  # the imprint included (its log is
        # rounded to f32 on the JAX side: ROADMAP §C)
        np.testing.assert_allclose(before_t[k], v, rtol=1e-6, atol=0,
                                   err_msg=k)
    exp_j.run()
    exp_t.run()
    m_t, m_j = exp_t.last_train_metrics, exp_j.last_train_metrics
    for key in ("loss", "lkd", "lde", "l_con", "l_icarl", "l_reg",
                "loss_tot"):
        np.testing.assert_allclose(m_t[key], m_j[key], rtol=2e-5, atol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(m_t["lr"], m_j["lr"], rtol=1e-6)
    assert m_t["l_con"] > 0
    after_t = module_to_flax(exp_t.model)
    after_j = _flat_of(exp_j.state.params, exp_j.state.batch_stats)
    assert set(after_t) == set(after_j)
    # the epoch's parameter updates (two steps), at the f64 step test's
    # update bounds; cls_0 frozen
    _assert_updates_close(before_j, before_t, after_t, after_j,
                          "params/cls_0/", "epoch")
    # the statistics' changes over the epoch, at the same bounds (after
    # the first step the two runs' parameters differ by rounding, and the
    # second step's batch statistics see that)
    stats = [k for k in after_j if k.startswith("batch_stats/")]
    scale = max(np.linalg.norm(after_j[k] - before_j[k]) for k in stats)
    for k in stats:
        d_t, d_j = after_t[k] - before_t[k], after_j[k] - before_j[k]
        err, ref = np.linalg.norm(d_t - d_j), np.linalg.norm(d_j)
        assert ref > 0 and err <= 2e-4 * ref + 3e-6 * scale, (k, err, ref)
    assert exp_t.state.step == int(exp_j.state.step) == 2

    score_t, score_j = exp_t.final_test(), exp_j.final_test()
    exp_t.close()
    exp_j.close()
    diff = np.abs(exp_t.last_confusion - exp_j.last_confusion).sum()
    if diff:
        assert diff <= 2 * _near_ties(exp_t), diff
    assert exp_t.last_confusion.sum() == exp_j.last_confusion.sum()
    assert abs(score_t["Mean IoU"] - score_j["Mean IoU"]) <= 1e-6
    assert score_t["Total samples"] == score_j["Total samples"] == 3


def _ns(ck):
    return types.SimpleNamespace(
        params=ck["model_state"]["params"],
        batch_stats=ck["model_state"]["batch_stats"],
        opt_state=ck["optimizer_state"], step=ck["step"])


def _near_ties(exp, gap_tol=1e-4) -> int:
    """Test pixels whose top-2 upsampled logits (the port's model) are
    within `gap_tol`: where the two packages' argmax may differ."""
    n = 0
    with torch.no_grad():
        exp.model.eval()
        for i in range(len(exp.test_dst)):
            img, _ = exp.test_dst.get(i)
            x = torch.as_tensor(img[None]).permute(0, 3, 1, 2)
            sem = exp.model.forward_sem(x)
            up = resize_bilinear(sem, x.shape[2:])
            top2 = up.topk(2, dim=1).values
            n += int(((top2[:, 0] - top2[:, 1]) < gap_tol).sum())
    return n
