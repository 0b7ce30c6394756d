"""The traced part of a run: a torch.profiler window over a steady stretch
of the measured window, reduced to what the per-layer readers take.

    kernels   device seconds and launches of each device operation, by name
    ops       device seconds of the kernels each host operator launched
              itself, by operator name (copies between host and device
              left out)
    busy_s    seconds in which some operation ran on the device (the union
              of their intervals), window_s the traced window's length
    gaps      the longest idle stretches, each named by the host operator
              that was running when it began
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

COPIES = ("Memcpy", "Memset")
NAME_CHARS = 160   # of a kernel's name in the breakdown


class Traced:
    """`with Traced() as t:` profiles the block; the card is synchronized
    at both ends, so nothing queued before or after runs inside."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        return reduce_events(self.prof.events(), self.window_s)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events, window_s: float) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda]
    host = [e for e in events if e.device_type != cuda]
    kernels: Dict[str, list] = {}
    for e in device:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) * 1e-6
        k[1] += 1
    ops: Dict[str, float] = {}
    for e in host:
        for k in getattr(e, "kernels", ()):
            if not k.name.startswith(COPIES):
                ops[e.name] = ops.get(e.name, 0.0) + k.duration * 1e-6
    spans = _union([(e.time_range.start, e.time_range.end) for e in device])
    busy_s = sum(b - a for a, b in spans) * 1e-6
    gaps = []
    if spans:
        starts = [e.time_range.start for e in events]
        lo = min(starts)
        hi = max(e.time_range.end for e in events)
        edges = [lo] + [x for s in spans for x in s] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
    named = []
    for length, at in gaps:
        # the host operator entered last before the device went idle
        name, best = "idle", None
        for e in host:
            if e.time_range.start <= at and (best is None
                                             or e.time_range.start > best):
                name, best = e.name, e.time_range.start
        named.append([name[:NAME_CHARS], length * 1e-6])
    top = sorted(((v[0], n[:NAME_CHARS]) for n, v in kernels.items()),
                 reverse=True)[:10]
    return {"window_s": window_s, "busy_s": busy_s, "kernels": kernels,
            "ops": ops, "device_ops": [[n, s] for s, n in top],
            "idle_gaps": named}
