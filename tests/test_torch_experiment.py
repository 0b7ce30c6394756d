"""The port's `Experiment` on the CPU: the two-step incremental flow (step 0
FT, then step 1 UCD with the step-0 checkpoint as its donor), same-step
resume bit-identical to an uninterrupted run, and the refusals. The step-1
comparison with the JAX package's `Experiment` is
tests/test_torch_experiment_parity.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ucd_torch import config as TC
from ucd_torch.data import SyntheticSegmentation
from ucd_torch.engine import checkpoint as TK
from ucd_torch.engine.experiment import (Experiment, get_datasets,
                                         pad_batch, pad_to_bucket)

SIZE = 32


def make_cfg(tmp_path, step=0, method="FT", **kw):
    base = dict(dataset="voc", task="19-1", step=step, method=method,
                backbone="resnet50", crop_size=SIZE, batch_size=4,
                dtype="float32", lr=0.01, epochs=1, print_interval=2,
                logdir=str(tmp_path / "logs"),
                ckpt_dir=str(tmp_path / "ckpt"), pretrained=False,
                contrastive_capacity=32, num_workers=2)
    base.update(kw)
    return TC.make_config(**base)


@pytest.fixture
def bases():
    return (SyntheticSegmentation(n=16, size=SIZE, n_classes=20, seed=0),
            SyntheticSegmentation(n=6, size=SIZE, n_classes=20, seed=1))


def test_two_step_experiment(tmp_path, bases):
    base_train, base_val = bases
    cfg0 = make_cfg(tmp_path, step=0)
    exp0 = Experiment(cfg0, base_train=base_train, base_val=base_val,
                      device="cpu")
    exp0.run()
    score0 = exp0.final_test()
    exp0.close()
    assert 0.0 <= score0["Mean IoU"] <= 1.0
    assert os.path.isfile(cfg0.ckpt_path())
    logdir = os.path.join(cfg0.logdir, cfg0.task_name, cfg0.name)
    records = [json.loads(line) for line in
               open(os.path.join(logdir, "metrics.jsonl"))]
    tags = {r["tag"] for r in records}
    assert {"Loss/0", "E-Loss/0", "Val_MeanIoU/0", "T_MeanIoU/0"} <= tags
    m0 = exp0.last_train_metrics
    assert m0["images_per_s"] > 0 and m0["data_wait_s"] >= 0
    assert m0["l_con"] == 0.0 and m0["lkd"] == 0.0

    # step 1: UCD picks up the step-0 checkpoint as its donor
    base_train1 = SyntheticSegmentation(n=16, size=SIZE, n_classes=21,
                                        seed=2)
    cfg1 = make_cfg(tmp_path, step=1, method="UCD")
    assert cfg1.contrastive and cfg1.use_pallas_contrastive
    exp1 = Experiment(cfg1, base_train=base_train1, base_val=base_val,
                      device="cpu")
    assert exp1.old_vars is not None and hasattr(exp1.model, "cls_1")
    donor = TK.state_dict_of(TK.load_model_state(cfg0.ckpt_path()))
    assert set(donor) == set(exp1.old_vars)
    assert all(torch.equal(donor[k], exp1.old_vars[k]) for k in donor)
    exp1.run()
    m1 = exp1.last_train_metrics
    assert m1["l_con"] != 0.0 and m1["lkd"] != 0.0
    assert np.isfinite(m1["loss_tot"])
    score1 = exp1.final_test()
    assert np.isfinite(score1["Mean IoU"])
    # the eval views through the Predictor: one view equals final_test's
    # argmax path; a flipped two-scale pyramid runs too
    assert exp1.predict_test()["Total samples"] == score1["Total samples"]
    exp1.cfg = dataclasses.replace(cfg1, test_flip=True,
                                   test_scales=(0.75, 1.0))
    assert np.isfinite(exp1.predict_test()["Mean IoU"])
    out = str(tmp_path / "panels")
    assert exp1.visualize(out, max_images=3) == 3
    for suffix in ("_panel.png", "_attention.png", "pre.png", "gt_clo.jpg",
                   "rgb.jpg"):
        assert os.path.exists(os.path.join(out, "0002" + suffix)), suffix
    exp1.close()
    assert os.path.exists(os.path.join(
        logdir, "confusion_matrix_step1.png"))
    # cls_0 stayed frozen through step 1
    ck1 = TK.load_model_state(cfg1.ckpt_path())
    assert torch.equal(ck1["params"]["cls_0.weight"], donor["cls_0.weight"])


def test_missing_donor_raises(tmp_path, bases):
    _, base_val = bases
    base_train = SyntheticSegmentation(n=8, size=SIZE, n_classes=21, seed=2)
    cfg1 = make_cfg(tmp_path, step=1, method="UCD")
    with pytest.raises(FileNotFoundError):
        Experiment(cfg1, base_train=base_train, base_val=base_val,
                   device="cpu")
    # an orbax directory where the donor should be names the bridge
    os.makedirs(cfg1.ckpt_path(0))
    with pytest.raises(ValueError, match="jax_ckpt_to_torch"):
        Experiment(cfg1, base_train=base_train, base_val=base_val,
                   device="cpu")


def test_refusals_and_missing_pretrained(tmp_path, bases):
    """K steps a call and the regularizers are taken (ported with the
    CUDA-graph bundle and ops/regularizers.py); a missing pretrained body
    and a missing card are refused."""
    base_train, base_val = bases
    exp = Experiment(make_cfg(tmp_path, steps_per_call=2),
                     base_train=base_train, base_val=base_val, device="cpu")
    assert exp.train_bundle is not None and exp.state.reg_state is None
    exp.close()
    exp = Experiment(make_cfg(tmp_path, method="EWC"),
                     base_train=base_train, base_val=base_val, device="cpu")
    assert exp.train_bundle is None
    assert exp.state.reg_state.kind == "ewc"
    assert not exp.state.reg_state.penalize  # step 0: nothing saved yet
    exp.close()
    # the JAX package's text for a missing pretrained body
    cfg = make_cfg(tmp_path, pretrained=True,
                   pretrained_path=str(tmp_path / "none.pth.tar"))
    with pytest.raises(FileNotFoundError, match="--no_pretrained"):
        Experiment(cfg, base_train=base_train, base_val=base_val,
                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Experiment(make_cfg(tmp_path), base_train=base_train,
                       base_val=base_val)


def test_same_step_resume_is_bit_identical(tmp_path, bases):
    """A 3-epoch run against 2 epochs + save + a resumed third: the same
    parameters, statistics and optimizer state, bit for bit."""
    _, base_val = bases
    base_train = SyntheticSegmentation(n=8, size=SIZE, n_classes=20, seed=3)
    kw = dict(method="MiB", epochs=3, val_interval=5)
    expA = Experiment(make_cfg(tmp_path, name="A", **kw),
                      base_train=base_train, base_val=base_val, device="cpu")
    expA.run()
    cfgB = make_cfg(tmp_path, name="B", async_ckpt=True, **kw)
    expB = Experiment(cfgB, base_train=base_train, base_val=base_val,
                      device="cpu")
    for ep in range(2):
        expB.train_epoch(ep)
        expB.cur_epoch += 1
    expB.save(1, 0.0)
    expB.close()  # waits for the async write
    expC = Experiment(dataclasses.replace(cfgB, ckpt=cfgB.ckpt_path()),
                      base_train=base_train, base_val=base_val, device="cpu")
    assert expC.cur_epoch == 2 and expC.state.step == expB.state.step
    assert expC.state.opt_state["count"] == expB.state.opt_state["count"]
    for k, v in expB.state.opt_state["trace"].items():
        assert torch.equal(v, expC.state.opt_state["trace"][k]), k
    expC.run()
    sa, sc = expA.model.state_dict(), expC.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    for k, v in expA.state.opt_state["trace"].items():
        assert torch.equal(v, expC.state.opt_state["trace"][k]), k
    assert expA.state.step == expC.state.step == 3 * len(expA.train_loader)
    # eval-only from the same checkpoint restores the variables only
    expT = Experiment(dataclasses.replace(cfgB, ckpt=cfgB.ckpt_path(),
                                          test_only=True),
                      base_train=base_train, base_val=base_val, device="cpu")
    assert expT.run() == {}
    assert expT.state.opt_state["count"] == 0
    # restored from the checkpoint file (B's epoch 1, which C overwrote
    # with epoch 2)
    ckB = TK.load_model_state(cfgB.ckpt_path())
    assert torch.equal(expT.model.cls_0.weight,
                       ckB["params"]["cls_0.weight"])


def test_resume_schema_error(tmp_path, bases):
    base_train, base_val = bases
    bad = str(tmp_path / "bad_ckpt")
    torch.save({"model_state": {"params": {}}}, bad)
    cfg = make_cfg(tmp_path, ckpt=bad)
    with pytest.raises(ValueError, match="schema"):
        Experiment(cfg, base_train=base_train, base_val=base_val,
                   device="cpu")


def test_get_datasets_and_padding_match_jax(bases):
    from ucd_tpu import config as JC
    from ucd_tpu.engine import experiment as JX
    base_train, base_val = bases
    for cross_val in (False, True):
        kw = dict(dataset="voc", task="19-1", step=0, crop_size=SIZE,
                  cross_val=cross_val)
        dt = get_datasets(TC.make_config(**kw), base_train, base_val)
        dj = JX.get_datasets(JC.make_config(**kw), base_train, base_val)
        assert dt[3] == dj[3] == 21
        for a, b in zip(dt[:3], dj[:3]):
            assert a.indices == b.indices and len(a) > 0
            for i in range(len(a)):
                ia, ib = a.get(i, np.random.default_rng(i)), \
                    b.get(i, np.random.default_rng(i))
                np.testing.assert_array_equal(ia[0], ib[0])
                np.testing.assert_array_equal(ia[1], ib[1])
    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (3, 20, 37, 3)).astype(np.uint8),
             "label": rs.randint(0, 21, (3, 20, 37)).astype(np.uint8)}
    for got, want in ((pad_to_bucket(batch, 16), JX.pad_to_bucket(batch, 16)),
                      (pad_batch(batch, 5), None)):
        if want is not None:
            for k in batch:
                np.testing.assert_array_equal(got[k], want[k])
    padded = pad_batch(batch, 5)
    assert padded["image"].shape[0] == 5 and (padded["label"][3:] == 255).all()
    assert pad_batch(batch, 3) is batch
