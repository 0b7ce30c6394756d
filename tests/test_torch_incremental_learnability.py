"""The core functional claim, tested end-to-end on the port: a model
trained incrementally (step 0: classes 1,2 -> step 1: class 3) with
KD + contrastive distillation from the frozen donor RETAINS
the old classes while learning the new one, on a learnable color-coded
task.

Mirrors tests/test_incremental_learnability.py:24-135
(`test_ucd_incremental_retains_old_classes`): the same configuration,
seeds, data sizes, epoch counts and bars, built through the port's public
API on the CPU. The JAX file calibrated its bars on the JAX package's
8-virtual-device CPU backend and kept >= 0.10 of margin to its measured
values (0.22/0.38 old, 0.40 new); the port's trajectory is its own, since
training at these sizes is chaotic. The module-level constants and
helpers keep the JAX file's names: tests/test_torch_capacity_accuracy.py
imports them, and `chip_smoke.py` phase 3i runs `run_incremental` on the
card with the contrastive kernels on."""

import pytest
import torch

from ucd_torch import config
from ucd_torch.data import (DataLoader, LearnableSynthetic,
                            make_incremental_dataset)
from ucd_torch.data.transforms import train_transform, val_transform
from ucd_torch.engine import (build_train_state, empty_confusion,
                              make_eval_step, make_train_step,
                              results_from_confusion)
from ucd_torch.models import make_model

# heavy end-to-end file, as its JAX original: excluded from the default
# selection (pytest.ini); run with -m slow
pytestmark = pytest.mark.slow

SIZE = 64
N_CLS = 4  # bkg + classes 1,2 (step 0) + class 3 (step 1)
EPOCHS = 25
STEP1_EPOCHS = 15
STEP1_KD = 20.0


def _train(cfg, model, state, loader, step_fn, old_vars=None, epochs=EPOCHS):
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            state, m = step_fn(state, batch, old_vars)
    return state, m


def _loader(labels, labels_old, seed, train=True):
    base = LearnableSynthetic(n=24, size=SIZE, n_classes=N_CLS, seed=seed)
    dst = make_incremental_dataset(
        "voc", "data", train=train,
        transform=(train_transform(SIZE) if train else val_transform(SIZE)),
        labels=labels, labels_old=labels_old, idxs_path=None,
        masking=True, overlap=True, base=base)
    return DataLoader(dst, 8, seed=0, shuffle=train, drop_last=train)


def _eval_class_iou(cfg, model, state, device="cpu"):
    ev = make_eval_step(cfg, model, device=device)
    hist = empty_confusion(cfg.tot_classes, device)
    base = LearnableSynthetic(n=8, size=SIZE, n_classes=N_CLS, seed=99)
    dst = make_incremental_dataset(
        "voc", "data", train=False, transform=val_transform(SIZE),
        labels=[1, 2, 3], labels_old=None, idxs_path=None,
        masking=True, overlap=True, base=base)
    for batch in DataLoader(dst, 8, shuffle=False, drop_last=False,
                            seed=0).epoch(0):
        hist, _, _ = ev(None, batch, hist, None)
    return results_from_confusion(hist)["Class IoU"]


def base_kw(**kw) -> dict:
    """The configuration both steps share (the JAX file's `base_kw`)."""
    return dict(dataset="voc", task="offline", backbone="resnet50",
                crop_size=SIZE, batch_size=8, dtype="float32",
                output_stride=8, pretrained=False,
                num_classes_override=N_CLS, **kw)


def train_step0(kw: dict, device="cpu"):
    """Step 0: FT on classes {1,2} for EPOCHS; returns (model0, its class
    IoU)."""
    cfg0 = config.make_config(step=0, method="FT", lr=0.1, **kw)
    model0 = make_model(cfg0, classes=[3])
    loader0 = _loader([1, 2], [], seed=0)
    n0 = EPOCHS * len(loader0)
    state0, _ = build_train_state(cfg0, model0,
                                  torch.Generator().manual_seed(0),
                                  total_iters=n0, device=device)
    step0 = make_train_step(cfg0, model0, None, total_iters=n0, step_idx=0,
                            device=device)
    state0, _ = _train(cfg0, model0, state0, loader0, step0)
    return model0, _eval_class_iou(cfg0, model0, state0, device)


def train_step1(kw: dict, model0, device="cpu"):
    """Step 1: add class {3} with the step-0 model as the donor, KD x
    STEP1_KD and the contrastive term, for STEP1_EPOCHS; returns (the last
    iteration's metrics as floats, the class IoU)."""
    # explicit loss flags instead of the UCD preset: the custom [3]+[1]
    # class split bypasses the task registry, so registry-derived fields
    # (old_classes for unbiased CE, new_classes for imprinting) don't
    # apply; KD + contrastive distillation are the donor-coupled paths
    cfg1 = config.make_config(step=0, method=None, lr=0.02,
                              loss_kd=STEP1_KD, contrastive=True, **kw)
    model1 = make_model(cfg1, classes=[3, 1])
    model_old = make_model(cfg1, classes=[3])
    prev = {k: v.detach().cpu() for k, v in model0.state_dict().items()}
    loader1 = _loader([3], [1, 2], seed=5)
    n1 = STEP1_EPOCHS * len(loader1)
    state1, old_vars = build_train_state(cfg1, model1,
                                         torch.Generator().manual_seed(1),
                                         total_iters=n1,
                                         prev_model_state=prev,
                                         device=device)
    step1 = make_train_step(cfg1, model1, model_old, total_iters=n1,
                            step_idx=1, device=device)
    state1, m1 = _train(cfg1, model1, state1, loader1, step1,
                        old_vars=old_vars, epochs=STEP1_EPOCHS)
    return ({k: float(v) for k, v in m1.items()},
            _eval_class_iou(cfg1, model1, state1, device))


def check_step0(iou0) -> None:
    assert iou0[1] > 0.3 and iou0[2] > 0.3, f"step-0 didn't learn: {iou0}"


def check_retained(iou1, iou0=None, tag="") -> None:
    """Old classes retained through distillation (FT measures 0.000 on
    both in the JAX package, BASELINE.md), new class learned."""
    old_mean = (iou1[1] + iou1[2]) / 2
    assert old_mean > 0.2 and min(iou1[1], iou1[2]) > 0.1, \
        f"{tag}catastrophic forgetting: step0 {iou0} -> step1 {iou1}"
    assert iou1[3] > 0.25, f"{tag}new class not learned: {iou1}"


def run_incremental(device="cpu", use_pallas_contrastive=False) -> dict:
    """Both steps at capacity 128; the JAX test takes the dense
    contrastive oracle (`use_pallas_contrastive=False`)."""
    kw = base_kw(use_pallas_contrastive=use_pallas_contrastive,
                 contrastive_capacity=128)
    model0, iou0 = train_step0(kw, device)
    m1, iou1 = train_step1(kw, model0, device)
    return {"iou0": {c: float(iou0[c]) for c in (1, 2)},
            "iou1": {c: float(iou1[c]) for c in (1, 2, 3)},
            "lkd": m1["lkd"], "l_con": m1["l_con"]}


def check_incremental(r: dict) -> None:
    """The JAX test's bars (tests/test_incremental_learnability.py:101,
    :124, :131-135)."""
    check_step0(r["iou0"])
    assert r["lkd"] != 0.0 and r["l_con"] != 0.0, r
    check_retained(r["iou1"], r["iou0"])


def test_ucd_incremental_retains_old_classes():
    r = run_incremental("cpu")
    print("INCREMENTAL", r)
    check_incremental(r)
