"""The port's tracing (ucd_torch/utils/tracing.py) on the CPU, on one tiny
UCD step-1 model (ResNet-18, 32 x 32, batch 2, float32) and its donor:

- tracing off: no `ucd.` range in a CPU profile, no CUDA event made, and
  the caller's `mark` names as they were;
- tracing on: the `ucd.step.*` spans in the step's order, for
  `make_train_step` and for `make_train_bundle`'s CPU path; one `ucd.abn`
  span per ABN module and forward pass, the donor's included;
- the ABN's backward by sequence numbers (`span_ops`): every backward node
  of an ABN and no other node, a no-op cast at the span's end included;
- a step with tracing on leaves the state bit-equal to one with it off.

The timing events of the phases, and their external form under CUDA-graph
capture, run only on the card; here a stand-in event class checks which
events a mark makes and how `phase_ms` pairs them.
"""

import collections
import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ucd_torch import config as TC
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import make_train_bundle, make_train_step
from ucd_torch.models import make_model
from ucd_torch.models.layers import ABN
from ucd_torch.utils import tracing

SIZE, B, TOTAL = 32, 2, 10
MARKS = ["start", "upload", "donor_forward", "forward", "losses",
         "backward", "optimizer"]
PHASES = MARKS[2:]


def _cfg():
    return dataclasses.replace(
        TC.make_config(dataset="voc", task="15-5s", step=1, method="UCD",
                       dtype="float32", crop_size=SIZE, batch_size=B),
        backbone="resnet18")


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            "label": rs.randint(0, 17, (B, SIZE, SIZE)).astype(np.uint8)}


@pytest.fixture(scope="module")
def built():
    """(cfg, model, donor shell, state, donor variables), never stepped."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = _cfg()
    donor = make_model(cfg, cfg.classes_per_step[:-1])
    donor.init_weights(torch.Generator().manual_seed(1))
    model = make_model(cfg)
    model_old = make_model(cfg, cfg.classes_per_step[:-1])
    state, old_vars = build_train_state(
        cfg, model, torch.Generator().manual_seed(0), TOTAL,
        prev_model_state=donor.state_dict(), device="cpu")
    yield cfg, model, model_old, state, old_vars
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(built):
    """A copy that the span tests share (they check no values)."""
    return copy.deepcopy(built)


def _names(prof):
    return [e.name for e in prof.events() if e.name.startswith("ucd.")]


def _n_abn(*models):
    return sum(isinstance(m, ABN) for model in models
               for m in model.modules())


@pytest.mark.parametrize("kind", ["step", "bundle"])
@pytest.mark.parametrize("on", [False, True])
def test_spans_only_with_tracing_on(tiny, kind, on):
    """Off: no `ucd.` range, the caller's marks unchanged. On: the phases'
    spans in order (the bundle's upload of its K batches first), one
    `ucd.abn` a forward of each ABN, donor's included."""
    cfg, model, model_old, state, old_vars = tiny
    marks = []
    if kind == "step":
        fn = make_train_step(cfg, model, model_old, TOTAL, device="cpu",
                             mark=marks.append)
        feed, k = _batch(2), 1
        want = ["ucd.step.upload", *(f"ucd.step.{p}" for p in PHASES)]
    else:
        fn = make_train_bundle(cfg, model, model_old, TOTAL, 2,
                               device="cpu")
        b = [_batch(2), _batch(3)]
        feed, k = {key: np.stack([x[key] for x in b]) for key in b[0]}, 2
        want = ["ucd.step.upload",
                *[f"ucd.step.{p}" for p in PHASES] * 2]
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.enabled(on):
        fn(state, feed, old_vars)
    names = _names(prof)
    if kind == "step":
        assert marks == MARKS
    if not on:
        assert names == []
        return
    assert [n for n in names if n != "ucd.abn"] == want
    assert names.count("ucd.abn") == k * _n_abn(model, model_old)
    assert list(fn.phases.steps) == []   # no CUDA event on the CPU


class _Event:
    """Stands in for torch.cuda.Event: records the clock's next tick."""

    made = []
    clock = [0.0]

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        self.external, self.t = external, None
        _Event.made.append(self)

    def record(self):
        _Event.clock[0] += 1.0 + len(_Event.made) / 10
        self.t = _Event.clock[0]

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.mark.parametrize("capturing", [False, True])
def test_phase_events(monkeypatch, capturing):
    """Off, a CUDA step's mark makes no event; on, one a mark, external
    under capture; `phase_ms` names each interval by the mark that ends
    it and averages over the steps held. In a process group "backward" is
    followed by "all_reduce"."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    _Event.made.clear()
    mark = tracing.PhaseMark(cuda=True)
    for name in MARKS:
        mark(name)
    assert _Event.made == [] and list(mark.steps) == []
    with tracing.enabled():
        for _ in range(2):
            for name in MARKS[:-1]:
                mark(name, "all_reduce" if name == "backward" else None)
            mark("all_reduce")
            mark("optimizer")
        # a step's core with no "start" mark before it begins one itself
        mark.begin()
        mark.begin()
        for name in PHASES:
            mark(name)
    assert len(_Event.made) == 2 * 8 + 6
    assert all(e.external == capturing for e in _Event.made)
    assert [[n for n, _ in s] for s in mark.steps] == \
        [MARKS[:-1] + ["all_reduce", "optimizer"]] * 2 + \
        [["start"] + PHASES]
    got = tracing.phase_ms(mark.steps)
    want = {}
    for s in mark.steps:
        for (_, a), (n, b) in zip(s, s[1:]):
            want[n] = want.get(n, 0.0) + (b.t - a.t) / 3
    assert set(got) == set(want) and got["upload"] == want["upload"]
    assert all(abs(got[n] - want[n]) < 1e-12 for n in got)
    assert tracing.phase_ms([]) == {}


class _Tiny(torch.nn.Module):
    """conv -> ABN -> an operator after the span, and a BatchNorm outside
    any ABN, so that names alone would misattribute."""

    def __init__(self, dtype):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, dtype=torch.float32)
        self.abn = ABN(4, dtype=dtype)
        self.bn = torch.nn.BatchNorm2d(4)
        self.dtype = dtype

    def forward(self, x):
        y = self.conv(x).to(self.dtype)
        y = self.abn(y)
        return (y.float().sum() + self.bn(y.float()).square().mean()
                + F.leaky_relu(y.float(), 0.1).mean())


ABN_NODES = {"NativeBatchNormBackward0", "LeakyReluBackward1"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["noop_cast", "bf16_casts"])
def test_span_ops_gives_the_abn_its_backward_nodes(dtype):
    """At float32 the ABN's last cast is a no-op that carries the number
    of the `sum` after the span: SumBackward0 must stay outside. At bf16
    both casts are real and their ToCopyBackward0 nodes belong to it."""
    torch.manual_seed(0)
    m = _Tiny(dtype)
    x = torch.randn(2, 3, 8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.enabled():
        m(x).backward()
    events = prof.events()
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function: ")]
    got = collections.Counter(
        e.name.split(": ")[1] for e in tracing.span_ops(events, "ucd.abn")
        if e in nodes)
    want = collections.Counter(ABN_NODES)
    if dtype == torch.bfloat16:
        want["ToCopyBackward0"] = 2
    assert got == want
    every = collections.Counter(e.name.split(": ")[1] for e in nodes)
    # the BatchNorm and the casts outside make nodes of the same names
    assert every["NativeBatchNormBackward0"] == 2 and every["SumBackward0"]
    assert every["ToCopyBackward0"] == (6 if dtype == torch.bfloat16 else 0)


def test_abn_backward_of_the_step(tiny):
    """In a traced train step every BatchNorm node belongs to an ABN (the
    model has no other), so each of the trained model's ABNs gives one."""
    cfg, model, model_old, state, old_vars = tiny
    fn = make_train_step(cfg, model, model_old, TOTAL, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.enabled():
        fn(state, _batch(4), old_vars)
    events = prof.events()
    pre = "autograd::engine::evaluate_function: "
    ops = tracing.span_ops(events, "ucd.abn")
    got = [e.name[len(pre):] for e in ops if e.name.startswith(pre)]
    bn = [e for e in events if e.name == pre + "NativeBatchNormBackward0"]
    assert got.count("NativeBatchNormBackward0") == len(bn) \
        == _n_abn(model)
    assert set(got) <= ABN_NODES | {"ToCopyBackward0"}


def test_tracing_leaves_the_state_bit_equal(built):
    """The same step from the same state, off and on under a profiler:
    parameters, statistics, momentum and metrics bit for bit."""
    out = []
    for on in (False, True):
        cfg, model, model_old, state, old_vars = copy.deepcopy(built)
        fn = make_train_step(cfg, model, model_old, TOTAL, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]), \
                tracing.enabled(on):
            _, m = fn(state, _batch(5), old_vars)
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    {k: v.clone()
                     for k, v in state.opt_state["trace"].items()}, m))
    (sd0, tr0, m0), (sd1, tr1, m1) = out
    for a, b in ((sd0, sd1), (tr0, tr1), (m0, m1)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
