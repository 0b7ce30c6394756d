"""The program's own spans in a traced stretch (ucd_torch/utils/tracing.py),
reduced to the numbers of single layers they give:

    step.<phase>_ms          device ms a step of each phase of the train
                             step, from the step's own timing events
                             (`phase_ms`, read from the program)
    host.upload_ms_per_step  host ms of the `ucd.step.upload` ranges over
                             the traced steps (a bundle's call counts K)
    abn.span_ms_per_step     device ms a step of the kernels that the
                             operators of `ucd.abn` launched, the backward
                             of its autograd nodes included (`span_ops`)
    device.idle_pct.<phase>  the device's idle time inside the phase's
                             host ranges, % of the traced stretch

A number is left out where nothing was found, never 0: a program without
these spans (an older one) gives an empty dict.

Each range also appears on the device's rows as a user annotation from its
first kernel to its last: `busy_spans` leaves those out, or they would
fill the device's gaps (lib/trace.py's busy time counts them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .trace import COPIES, _union

PHASES = ("upload", "donor_forward", "forward", "losses", "backward",
          "all_reduce", "optimizer")

Spans = List[Tuple[float, float]]


def _overlap(a: Spans, b: Spans) -> float:
    """Length of the intersection of two sorted lists of disjoint spans."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy_spans(events) -> Spans:
    """The union of the device's operations, user annotations left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return _union([(e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)])


def _idle(events, busy: Spans) -> Spans:
    """The gaps between the device's busy spans, within the profile."""
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    edges = [lo] + [x for s in busy for x in s] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _abn_s(events) -> Optional[float]:
    try:
        from ucd_torch.utils.tracing import span_ops
    except ImportError:
        return None
    # an operator's kernels are listed again on profiler records that share
    # its correlation id (lazy module loading): each id counts once
    ops = {e.id: e for e in reversed(span_ops(events, "ucd.abn"))
           if getattr(e, "kernels", ())}
    s = sum(k.duration for e in ops.values() for k in e.kernels
            if not k.name.startswith(COPIES))
    return s * 1e-6 if s > 0 else None


def reduce_spans(events, window_s: float, traced_steps: int,
                 phase_ms: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
    """The numbers above from a profile's events (`prof.events()`), the
    traced stretch's seconds and steps, and the program's phase readings
    over those steps."""
    out: Dict[str, float] = {}
    if traced_steps <= 0 or not events:
        return out
    for p in PHASES:
        if (phase_ms or {}).get(p) is not None:
            out[f"step.{p}_ms"] = float(phase_ms[p])
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {p: _union([(e.time_range.start, e.time_range.end)
                         for e in events if e.device_type != cuda
                         and e.name == f"ucd.step.{p}"]) for p in PHASES}
    if ranges["upload"]:
        out["host.upload_ms_per_step"] = 1e-3 * sum(
            b - a for a, b in ranges["upload"]) / traced_steps
    abn = _abn_s(events)
    if abn is not None:
        out["abn.span_ms_per_step"] = 1e3 * abn / traced_steps
    busy = busy_spans(events)
    if busy and window_s > 0:
        idle = _idle(events, busy)
        for p, r in ranges.items():
            if r:
                out[f"device.idle_pct.{p}"] = \
                    1e-4 * _overlap(idle, r) / window_s
    return out
