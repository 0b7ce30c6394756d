"""The reducer of the program's spans (benchmark/lib/spans.py) on the CPU:
over a profiled tiny step of each train cell, with the program's tracing
off and on, and over a hand-made timeline whose numbers are known. Where
nothing is found a number is left out, never 0."""

from __future__ import annotations

import sys
from types import SimpleNamespace as NS

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drivers import train_job as TJ
from benchmark.lib.spans import reduce_spans
from benchmark.tests import tiny

TRAIN = ("voc15-5s.ucd.b24.eager", "ade100-50.ucd.b24.k4")
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", TRAIN)
def test_profiled_tiny_step(cell):
    """Tracing off: nothing. On, on the CPU: the upload ranges' host ms,
    and no device number (there is no device), not a 0."""
    from ucd_torch.utils import tracing

    ctx = tiny.context(cell)
    prep = TJ.Prepared(ctx)
    prog = TJ.Program(ctx, prep)
    for i, on in enumerate((False, True)):
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                tracing.enabled(on):
            prog(i)
        got = reduce_spans(prof.events(), 1.0, prep.K,
                           tracing.phase_ms(prog.fn.phases.steps))
        if not on:
            assert got == {}
    assert set(got) == {"host.upload_ms_per_step"}
    assert got["host.upload_ms_per_step"] > 0


def _ev(name, a, b, parent=None, device=CPU, kernels=(), id=0,
        annotation=False):
    return NS(name=name, device_type=device, time_range=NS(start=a, end=b),
              cpu_parent=parent, sequence_nr=-1, thread=1, fwd_thread=0,
              kernels=[NS(name=k, duration=d) for k, d in kernels], id=id,
              is_user_annotation=annotation)


def _timeline(tag="ucd"):
    """Host: upload 0-10, forward 10-40 with an ABN range 12-20 whose
    operator launched a 6 us kernel and a copy; device busy 5-8, 14-20,
    25-38 (us). The ranges are named `<tag>.*`; the forward's also lies
    on the device's row as a user annotation (14-38), and a lazy-loading
    record repeats the ABN operator's kernels under its id."""
    up = _ev(f"{tag}.step.upload", 0, 10)
    fw = _ev(f"{tag}.step.forward", 10, 40)
    abn = _ev(f"{tag}.abn", 12, 20, fw)
    bn = [("bn_fw", 6.0), ("Memcpy HtoD", 3.0)]
    op = _ev("aten::batch_norm", 13, 19, abn, kernels=bn, id=7)
    load = _ev("Lazy Function Loading", 13, 14, op, kernels=bn, id=7)
    conv = _ev("aten::convolution", 22, 30, fw, kernels=[("conv", 13.0)],
               id=8)
    dev = [_ev(k, a, b, device=CUDA)
           for k, a, b in (("copy", 5, 8), ("bn_fw", 14, 20),
                           ("conv", 25, 38))]
    note = _ev(fw.name, 14, 38, device=CUDA, annotation=True)
    return [up, fw, abn, op, load, conv, *dev, note]


def test_hand_made_timeline():
    got = reduce_spans(_timeline(), 40e-6, 2,
                       {"forward": 3.0, "upload": 1.0, "unknown": 9.0})
    assert got["step.forward_ms"] == 3.0 and got["step.upload_ms"] == 1.0
    assert "step.unknown_ms" not in got
    assert got["host.upload_ms_per_step"] == pytest.approx(10e-3 / 2)
    assert got["abn.span_ms_per_step"] == pytest.approx(6e-3 / 2)
    # idle 0-5, 8-14, 20-25, 38-40: 7 us inside upload, 11 in forward
    assert got["device.idle_pct.upload"] == pytest.approx(100 * 7 / 40)
    assert got["device.idle_pct.forward"] == pytest.approx(100 * 11 / 40)
    assert "device.idle_pct.backward" not in got


def test_nothing_found_is_left_out(monkeypatch):
    """No steps, no events, no spans, or a program without the tracing
    module (an older one): no number, and never a 0."""
    assert reduce_spans(_timeline(), 40e-6, 0) == {}
    assert reduce_spans([], 1.0, 2) == {}
    assert reduce_spans(_timeline("other"), 40e-6, 2) == {}
    monkeypatch.setitem(sys.modules, "ucd_torch.utils.tracing", None)
    got = reduce_spans(_timeline(), 40e-6, 2)
    assert "abn.span_ms_per_step" not in got and got
