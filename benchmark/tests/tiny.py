"""Tiny configurations and traffic mixes of the benchmark's cells, for
driving a whole run on the CPU: ResNet-50 at 64 x 64, a batch of 2,
float32 (float64 where the test compares the reference with the program
exactly)."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from benchmark.lib.cell import Context
from benchmark.lib.spec import HERE, ROOT, Benchmark


def config(name: str, dtype: str = "float32") -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cf = json.load(f)
    cf = copy.deepcopy(cf)
    cf.update(backbone="resnet50", crop_size=64)
    cf["program"].update(backbone="resnet50", crop_size=64, dtype=dtype)
    return cf


def traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        tr = json.load(f)
    tr.update(batch=2, pool=2 * tr["steps_per_call"],
              check_steps=min(tr["check_steps"], 2), calibration_batch=2,
              ignore_band=1)
    return tr


def context(cell: str, seed: int = 2 ** 33 + 7, seconds: float = 1.0,
            dtype: str = "float32", **patch) -> Context:
    bench = Benchmark.load(ROOT, HERE)
    w = bench.workload(cell)
    tr = dict(traffic(w["traffic"]), **patch)
    return Context(bench, w, seed=seed, seconds=seconds, trace=False,
                   device=torch.device("cpu"), t_start=time.perf_counter(),
                   config=config(w["config"], dtype), traffic=tr)
