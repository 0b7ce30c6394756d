"""Spans of the train step's phases and of the ABN on a profiler's
timeline, and device times of the phases from timing events.

Tracing has one switch, `enabled()`, a context manager; `ON` says whether
it is on. Off (the default) a call site tests `ON` and does nothing more:
no profiler range, no CUDA event, no autograd node.

On, while a torch.profiler records, the program opens
`torch.profiler.record_function` ranges, on the clock of the profiler's
device timeline:

    ucd.step.<phase>  one phase of a train step, from the mark that ends
                      the phase before it to the mark named <phase>:
                      upload, donor_forward, forward, losses, backward,
                      all_reduce (in a process group), optimizer.
                      `make_train_bundle` spans its upload of the K
                      batches and each replay's staging copy as upload.
    ucd.abn           the forward of an ABN (models/layers.py), its casts
                      included. Its backward is the autograd nodes made by
                      the operators inside the span (`span_ops`).

On, on CUDA, each phase mark also records a timing event on the current
stream, with or without a profiler, and `phase_ms` reads the device ms of
each phase from them. Under CUDA-graph capture the events are external
ones, which the graph records again at every replay. So a captured step
has phase events only if tracing was on when it was captured, and then
has them at every replay.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, Iterable, List, Optional

import torch

ON = False
KEEP = 16   # steps of events a PhaseMark holds

# the phase that follows each mark's, named by the mark that ends it; in a
# process group "backward" is followed by "all_reduce" (`then`)
_NEXT = {"start": "upload", "upload": "donor_forward",
         "donor_forward": "forward", "forward": "losses",
         "losses": "backward", "backward": "optimizer",
         "all_reduce": "optimizer"}
_BACKWARD = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def enabled(on: bool = True):
    """Tracing on (or off) inside the block."""
    global ON
    was, ON = ON, on
    try:
        yield
    finally:
        ON = was


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A profiler range `name` over the block while tracing is on and a
    profiler records; otherwise a no-op context."""
    if ON and _profiling():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class PhaseMark:
    """A train step's `mark(name)`, called at the step's start ("start")
    and after each phase with the phase's name. The caller's own `mark`,
    if given, is called first with the same names. With tracing on, a
    mark closes the span of the phase it ends, records a timing event
    (`cuda`) and opens the span of the next phase.

    `steps` holds the events of the last `KEEP` completed steps, each a
    list of (name, event) from "start" to "optimizer"."""

    def __init__(self, mark: Optional[Callable[[str], None]] = None,
                 cuda: bool = False):
        self.mark, self.cuda = mark, cuda
        self.steps: collections.deque = collections.deque(maxlen=KEEP)
        self._step: Optional[list] = None   # the step in progress
        self._span = None

    def __call__(self, name: str, then: Optional[str] = None) -> None:
        if self.mark is not None:
            self.mark(name)
        if ON:
            self._end(name, then or _NEXT.get(name))

    def begin(self) -> None:
        """The start of a step's core: starts a step unless the caller's
        "start" mark has (the bundle's steps have none), so that the
        donor forward has a beginning."""
        if ON and self._step is None:
            self._end("start", "donor_forward")

    def _end(self, name: str, following: Optional[str]) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if name == "start":
            self._step = []
        if self.cuda and self._step is not None:
            event = torch.cuda.Event(
                enable_timing=True,
                external=torch.cuda.is_current_stream_capturing())
            event.record()
            self._step.append((name, event))
        if following is None:
            if self._step:
                self.steps.append(self._step)
            self._step = None
        elif _profiling():
            self._span = torch.profiler.record_function(
                f"ucd.step.{following}")
            self._span.__enter__()


def phase_ms(steps: Iterable[list]) -> Dict[str, float]:
    """Mean device ms of each phase over `steps` (a `PhaseMark`'s), each
    phase named by the mark that ends it; {} without events. Waits for the
    last step's events."""
    steps = [s for s in steps if len(s) > 1]
    out: Dict[str, float] = {}
    if not steps:
        return out
    steps[-1][-1][1].synchronize()
    for s in steps:
        for (_, a), (name, b) in zip(s, s[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / len(steps)
    return out


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def span_ops(events, name: str) -> List:
    """The host operators of a profile (`prof.events()`) that belong to the
    ranges named `name`: those inside one, and the backward of every
    autograd node that an operator inside one made. A node carries its
    forward operator's sequence number. An operator that makes no node
    carries the number of the next node (a no-op `.to()` at a span's end
    carries the number of the operator after the span), so a number
    belongs to the last forward operator, in time order, that carries it."""
    cuda = torch.autograd.DeviceType.CUDA
    host = sorted((e for e in events if e.device_type != cuda),
                  key=lambda e: e.time_range.start)

    def node(e):
        for a in _ancestors(e):
            if a.name.startswith(_BACKWARD):
                return a
        return None

    inside = {id(e) for e in host
              if any(a.name == name for a in _ancestors(e))}
    maker = {}
    for e in host:
        if e.sequence_nr >= 0 and node(e) is None:
            maker[(e.thread, e.sequence_nr)] = id(e) in inside
    out = []
    for e in host:
        n = node(e)
        if id(e) in inside or (n is not None and maker.get(
                (n.fwd_thread, n.sequence_nr), False)):
            out.append(e)
    return out
