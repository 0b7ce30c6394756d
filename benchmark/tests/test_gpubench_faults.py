"""Whole runs on the CPU at a tiny size with the timed path broken
underneath, each of the faults a cell can have: `correct` must come out
false. The same runs unbroken come out true, and so must not the
reference put in the program's place at fp8 (the control)."""

from __future__ import annotations

import pytest
import torch

from benchmark import readings
from benchmark.tests import tiny

TRAIN = ("voc15-5s.ucd.b24.eager", "ade100-50.ucd.b24.k4")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(cell, **kw):
    out = tiny.context(cell, dtype=kw.pop("dtype", "float64"), seconds=0.5,
                       **kw).run()
    return out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_is_correct(cell):
    ok, checks = _correct(cell)
    assert ok, checks


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, monkeypatch):
    from ucd_torch.engine import train as T

    monkeypatch.setattr(T.Optimizer, "update", lambda self, *a, **k: None)
    ok, checks = _correct(cell)
    assert not ok, checks


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_left_out(cell, monkeypatch):
    from ucd_torch.engine import train as T

    batch = T._batch
    monkeypatch.setattr(T, "_batch", lambda b, dev: batch(
        {k: torch.as_tensor(v)[: len(v) // 2] for k, v in b.items()}, dev))
    call = T._Bundle.__call__
    monkeypatch.setattr(T._Bundle, "__call__", lambda self, st, b, old=None:
                        call(self, st, {k: torch.as_tensor(v)[:, : v.shape[1]
                                                             // 2]
                                        for k, v in b.items()}, old))
    ok, checks = _correct(cell, batch=4)
    assert not ok, checks


@pytest.mark.parametrize("cell", TRAIN)
def test_fp8_control_is_not_correct(cell):
    ctx = tiny.context(cell, dtype="float32")
    found = readings.train_reading(ctx, "control")
    limits = ctx.limits["checks"]
    assert any(c["value"] > limits[c["name"]] for c in found), found

