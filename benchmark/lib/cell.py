"""One run of one cell: the cell's files found by name, its driver run, the
compared numbers held to the cell's limits, and the result line's
contents assembled."""

from __future__ import annotations

import math
import sys
import time
from typing import Optional

from .spec import Benchmark


class Context:
    """What a driver gets: the cell (`cell`, `config`, `traffic`,
    `limits`), the run's `seed`, `seconds`, `trace`, `device` and
    `t_start` (perf_counter at the process's start). A test may hand it
    a `config` and a `traffic` of its own."""

    def __init__(self, bench: Benchmark, cell: dict, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None):
        self.bench, self.cell = bench, cell
        self.config = config or bench.config(cell["config"])
        self.traffic = traffic or bench.traffic(cell["traffic"])
        self.limits = bench.limits(cell["name"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device, self.t_start = device, t_start

    def log(self, *a) -> None:
        print(f"[{time.perf_counter() - self.t_start:8.2f}s]", *a,
              file=sys.stderr, flush=True)

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start

    def run(self) -> dict:
        driver = self.bench.driver(self.traffic["driver"])
        out = driver.run(self)
        checks = [dict(c, limit=self.limits["checks"][c["name"]])
                  for c in out["checks"]]
        correct = bool(out.get("ok", True)) and bool(checks) and all(
            c["value"] is not None and math.isfinite(c["value"])
            and c["value"] <= c["limit"] for c in checks)
        result = {"correct": correct, "attempted": int(out["attempted"]),
                  "failed": int(out["failed"])}
        if self.trace:
            records = dict(out["records"], trace=out["trace"])
            result["metrics"] = self.bench.read_per_layer(self.cell["name"],
                                                          records)
        else:
            result["metrics"] = {}
            for m in self.bench.end_to_end(self.cell["name"]):
                v = self.bench.e2e_value(m["name"], out["e2e"])
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v),
                                                    "unit": m["unit"]}
        result["device"] = out["device"]
        if self.trace and out["trace"] is not None:
            result["breakdown"] = {
                "device_ops": out["trace"]["device_ops"],
                "idle_gaps": out["trace"]["idle_gaps"]}
        return {"result": result, "checks": checks}
