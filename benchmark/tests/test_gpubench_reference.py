"""The plain reference against the program's CPU path at a tiny size and
float64, where the two must agree to rounding; and the yardstick's FLOP
count against torch's own counter."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.drivers import train_job as TJ
from benchmark.reference import model as RM
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,patch", [
    ("voc15-5s.ucd.b24.eager", {}),
    ("voc15-5s.ucd.b24.eager", {"steps_per_call": 2, "pool": 4}),
    ("ade100-50.ucd.b24.k4", {"steps_per_call": 1, "check_steps": 1,
                              "pool": 2}),
])
def test_train_step_matches_the_program(cell, patch):
    ctx = tiny.context(cell, dtype="float64", **patch)
    prep = TJ.Prepared(ctx)
    got = TJ.Program(ctx, prep).checked(prep)
    ref = TJ.reference_checked(prep)
    found = {c["name"]: c["value"] for c in TJ.checks(got, ref)}
    assert found["loss_gap"] < 1e-9, found
    assert found["grad_gap"] < 1e-9, found
    assert found["change_gap"] < 1e-8, found
    assert len(ref[0]) == prep.n_steps and all(
        r["l_con"] > 0 and r["lkd"] > 0 for r in ref[0])


@pytest.mark.parametrize("train", [True, False])
def test_forward_flops_match_torch_counter(train):
    arch = {"backbone": "resnet50", "output_stride": 16,
            "head_channels": 256, "pooling": 32, "classes": [16, 1]}
    sd = RM.init_state(arch, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(2, 3, 96, 64)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        RM.forward(sd, x, arch, train=train)
    assert fc.get_total_flops() == 2 * flops.forward_flops(arch, 96, 64,
                                                           train)
