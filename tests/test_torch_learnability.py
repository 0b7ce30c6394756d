"""Functional learning test of the port: the end-to-end stack (data
pipeline -> train step -> validate step -> metrics) must LEARN a
color-separable segmentation task, not merely run.

Mirrors tests/test_learnability.py:29-81 (`test_ft_learns_color_task`):
the same configuration, seeds, data sizes, epoch count and bars, built
through the port's public API on the CPU. `run_learnability(device)` is
also what `chip_smoke.py` phase 3i runs on the card, held to the same
bars by `check_learnability`."""

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
N_CLS = 4  # bkg + 3 paint classes
EPOCHS = 20


def run_learnability(device="cpu") -> dict:
    """FT, ResNet-50, 64x64, os 8, lr 0.1, 20 epochs of 32 images; returns
    the first and last epoch's last loss and the held-out mIoU."""
    cfg = config.make_config(
        dataset="voc", task="offline", step=0, method="FT",
        backbone="resnet50", crop_size=SIZE, batch_size=8, dtype="float32",
        output_stride=8, lr=0.1, pretrained=False,
        num_classes_override=N_CLS)

    base = LearnableSynthetic(n=32, size=SIZE, n_classes=N_CLS, seed=0)
    dst = make_incremental_dataset(
        "voc", "data", train=True, transform=train_transform(SIZE),
        labels=list(range(1, N_CLS)), labels_old=[], idxs_path=None,
        masking=False, overlap=True, base=base)
    loader = DataLoader(dst, 8, seed=0)

    model = make_model(cfg, classes=[N_CLS])
    n_iters = EPOCHS * len(loader)
    state, _ = build_train_state(cfg, model,
                                 torch.Generator().manual_seed(0),
                                 total_iters=n_iters, device=device)
    step = make_train_step(cfg, model, None, total_iters=n_iters,
                           device=device)

    first = None
    for epoch in range(EPOCHS):
        for batch in loader.epoch(epoch):
            state, m = step(state, batch, None)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])

    # eval mIoU on held-out samples of the same distribution
    val_base = LearnableSynthetic(n=8, size=SIZE, n_classes=N_CLS, seed=7)
    val = make_incremental_dataset(
        "voc", "data", train=False, transform=val_transform(SIZE),
        labels=list(range(1, N_CLS)), labels_old=[], idxs_path=None,
        masking=False, overlap=True, base=val_base)
    ev = make_eval_step(cfg, model, device=device)
    # the validate step bins over cfg.tot_classes; predictions occupy rows
    # 0..3 and absent classes are masked out of the mean
    hist = empty_confusion(cfg.tot_classes, device)
    for batch in DataLoader(val, 8, shuffle=False, drop_last=False,
                            seed=0).epoch(0):
        hist, _, _ = ev(None, batch, hist, None)
    res = results_from_confusion(hist)
    return {"first_loss": first, "last_loss": last,
            "miou": float(res["Mean IoU"])}


def check_learnability(r: dict) -> None:
    """The JAX test's bars (tests/test_learnability.py:64, :81)."""
    assert r["last_loss"] < 0.3 * r["first_loss"], (
        f"loss did not learn: {r['first_loss']} -> {r['last_loss']}")
    assert r["miou"] > 0.6, f"mIoU too low: {r['miou']}"


def test_ft_learns_color_task():
    r = run_learnability("cpu")
    print("LEARNABILITY", r)
    check_learnability(r)
