"""Helpers of the per-layer readers (benchmark/metrics/*.py): device time
from the traced stretch by kernel or operator name, a roofline share, and
another metric's reader. A reader that finds nothing returns None, never
0."""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

from .spec import load_module


def kernel_s(records: dict, pattern: str) -> Optional[float]:
    """Device seconds of the kernels whose names match `pattern`, or None
    without a trace or a match."""
    trace = records.get("trace")
    if not trace:
        return None
    rx = re.compile(pattern)
    hits = [s for name, (s, _) in trace["kernels"].items() if rx.search(name)]
    return sum(hits) if hits else None


def op_s(records: dict, pattern: str) -> Optional[float]:
    """Device seconds of the kernels launched by host operators whose names
    match `pattern` (copies left out), or None."""
    trace = records.get("trace")
    if not trace:
        return None
    rx = re.compile(pattern)
    hits = [s for name, s in trace["ops"].items() if rx.search(name)]
    return sum(hits) if hits else None


def share_pct(bound_s: float, device_s: Optional[float]) -> Optional[float]:
    if not device_s or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def per_step_ms(records: dict, seconds: Optional[float]) -> Optional[float]:
    steps = records.get("traced_steps") or 0
    if seconds is None or steps <= 0:
        return None
    return 1e3 * seconds / steps


def idle_pct(records: dict) -> Optional[float]:
    trace = records.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def same_as(here: str, name: str) -> Callable[[dict], Optional[float]]:
    """The `read` of the per-layer metric `name`, whose file lies beside the
    reader at `here`: one quantity read in other cells, where it moves
    another end-to-end metric, under a name of its own."""
    return load_module(os.path.join(os.path.dirname(here), name + ".py"),
                       "benchmark_metric_" + re.sub(r"\W", "_", name)).read
