"""bf16 dtype-policy guard of the port: six UCD steps of the production
bf16 policy (bf16 compute, f32 masters) against the same six steps at
float64, from the same weights on the same batches; the per-step
loss_tot relative divergence and the per-step global update-norm ratio
must stay inside the JAX test's band.

Mirrors tests/test_bf16_trajectory.py:53-121
(`test_bf16_trajectory_stays_in_band`): the same task, sizes, seeds,
batches and band (step 1: loss relerr <= 0.02, update-norm ratio in
(0.85, 1.18); every step: <= 0.10 and (0.4, 2.5)). Two differences, both
of which make the comparison tighter, not looser: the float64 run starts
from the bf16 run's f32 weights cast to f64 (torch draws another init in
f64 than in f32), and the test is parametrised over `bf16_norm`. Under
`bf16_norm=True` every ABN of the bf16 run rounds its output to bf16,
held to the plain float64 run in the same band. From this start the
first step's update-norm ratio is set by the ASPP pooling branch's
two-value BatchNorm at batch 2, in the JAX package's bf16 step as in the
port's: tests/test_torch_bf16_step_breakdown.py shows where."""

import numpy as np
import pytest
import torch

from ucd_torch import config
from ucd_torch.engine import build_train_state, make_train_step
from ucd_torch.models import make_model

pytestmark = pytest.mark.slow

SIZE = 48
B = 2
N_STEPS = 6


def _configs(dtype, bf16_norm=False):
    common = dict(dataset="voc", task="19-1", backbone="resnet50",
                  crop_size=SIZE, batch_size=B, dtype=dtype,
                  use_pallas_contrastive=False, fused_loss=False,
                  bf16_norm=bf16_norm)
    cfg0 = config.make_config(step=0, method="FT", **common)
    cfg = config.make_config(step=1, method="UCD", contrastive_capacity=128,
                             **common)
    return cfg0, cfg


def _params64(state) -> dict:
    return {k: v.detach().to(torch.float64).clone()
            for k, v in state.params.items()}


def _trajectory(dtype, batches, bf16_norm=False, start=None):
    """N UCD steps at the model dtype `dtype`; returns (losses,
    update_norms, start), `start` the (step-1 state_dict, donor variables)
    the steps began from. A given `start` replaces the seeded init."""
    cfg0, cfg = _configs(dtype, bf16_norm)
    model_old = make_model(cfg, classes=cfg.classes_per_step[:-1])
    build_train_state(cfg0, model_old, torch.Generator().manual_seed(0),
                      total_iters=N_STEPS, device="cpu")
    prev = {k: v.detach().clone() for k, v in model_old.state_dict().items()}
    if start is not None:
        prev = start[1]
    model = make_model(cfg)
    state, old_vars = build_train_state(cfg, model,
                                        torch.Generator().manual_seed(1),
                                        total_iters=N_STEPS,
                                        prev_model_state=prev, device="cpu")
    if start is not None:
        model.load_state_dict(start[0])
    here = ({k: v.detach().clone() for k, v in model.state_dict().items()},
            prev)
    step = make_train_step(cfg, model, model_old, total_iters=N_STEPS,
                           device="cpu")
    losses, unorms = [], []
    params_prev = _params64(state)
    for batch in batches:
        state, m = step(state, batch, old_vars)
        losses.append(float(m["loss_tot"]))
        params_now = _params64(state)
        unorms.append(float(torch.sqrt(sum(
            torch.sum((params_now[k] - params_prev[k]) ** 2)
            for k in params_now))))
        params_prev = params_now
    return np.asarray(losses), np.asarray(unorms), here


@pytest.mark.parametrize("bf16_norm", [False, True],
                         ids=["plain", "bf16_norm"])
def test_bf16_trajectory_stays_in_band(rng, bf16_norm):
    batches = []
    for _ in range(N_STEPS):
        img = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
        lab = rng.randint(0, 21, size=(B, SIZE, SIZE)).astype(np.int32)
        batches.append({"image": img, "label": lab})

    loss_bf, un_bf, start = _trajectory("bfloat16", batches, bf16_norm)
    start64 = tuple({k: v.to(torch.float64) if v.is_floating_point() else v
                     for k, v in sd.items()} for sd in start)
    loss_64, un_64, _ = _trajectory("float64", batches, start=start64)

    assert np.all(np.isfinite(loss_bf)) and np.all(np.isfinite(un_bf))
    rel_loss = np.abs(loss_bf - loss_64) / np.abs(loss_64)
    ratio = un_bf / un_64
    print(f"BF16_TRAJECTORY bf16_norm={bf16_norm} relerr "
          f"{rel_loss.tolist()} ratio {ratio.tolist()}")
    # first step: no chaotic compounding, the tight band
    assert rel_loss[0] <= 0.02, f"step-1 bf16 loss relerr {rel_loss[0]:.4f}"
    assert 0.85 < ratio[0] < 1.18, f"step-1 update-norm ratio {ratio[0]:.4f}"
    # the whole trajectory: the loose tripwire over the chaotic excursion
    assert rel_loss.max() <= 0.10, (
        f"bf16 loss trajectory diverged: per-step relerr {rel_loss}")
    assert np.all((ratio > 0.4) & (ratio < 2.5)), (
        f"bf16 update-norm trajectory diverged: ratios {ratio}")
