"""A configuration, a traffic mix and a per-layer metric are added as files
alone (and entries in BENCHMARK.json), in a copy of the benchmark, and the
harness finds and runs them without an edit to any file it has."""

from __future__ import annotations

import json
import os
import shutil
import time

import torch

from benchmark.lib.cell import Context
from benchmark.lib.spec import HERE, ROOT, Benchmark
from benchmark.tests import tiny

NEW_METRIC = '''"""The longest host call of the window (a test's metric)."""


def read(records):
    d = records.get("dispatch_s") or []
    return 1e3 * max(d) if d else None
'''

CELL = "voc15-5s-r50.ucd.b2.eager"


def test_added_files_are_found(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: open(os.path.join(base, p), "rb").read()
              for p in _files(base)}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

    cfg = tiny.config("voc15-5s-r101-os16")
    cfg["name"] = "voc15-5s-r50-os16"
    (base / "configs" / "voc15-5s-r50-os16.json").write_text(json.dumps(cfg))
    tr = tiny.traffic("ucd.b24.eager")
    (base / "traffic" / "ucd.b2.eager.json").write_text(json.dumps(tr))
    (base / "limits" / (CELL + ".json")).write_text(json.dumps(
        json.load(open(base / "limits" / "voc15-5s.ucd.b24.eager.json"))))
    (base / "metrics" / "host.dispatch_ms_max.py").write_text(NEW_METRIC)
    spec["configs"].append({"name": "voc15-5s-r50-os16", "source": "a test",
                            "file": "benchmark/configs/voc15-5s-r50-os16.json",
                            "reduced": ["backbone", "crop_size"],
                            "why": "a test"})
    spec["workloads"].append({"name": CELL, "config": "voc15-5s-r50-os16",
                              "traffic": "ucd.b2.eager", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("train_img_per_s", "train_peak_mem_gb"):
            m["workloads"].append(CELL)
    spec["per_layer"].append({
        "name": "host.dispatch_ms_max", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "train step, host side",
        "moves": "train_img_per_s", "workloads": [CELL]})

    bench = Benchmark(spec, str(base))
    cell = bench.workload(CELL)
    assert bench.config(cell["config"])["backbone"] == "resnet50"
    assert bench.traffic(cell["traffic"])["batch"] == 2
    assert [m["name"] for m in bench.per_layer(CELL)] \
        == ["host.dispatch_ms_max"]
    got = bench.read_per_layer(CELL, {"dispatch_s": [0.001, 0.003]})
    assert got == {"host.dispatch_ms_max": {"value": 3.0, "unit": "ms"}}

    # the added cell runs through its driver, from the added files alone
    ctx = Context(bench, cell, seed=11, seconds=0.5, trace=False,
                  device=torch.device("cpu"), t_start=time.perf_counter())
    out = ctx.run()
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {
        "train_img_per_s", "train_peak_mem_gb", "setup_s"}

    for p, data in before.items():
        assert open(os.path.join(base, p), "rb").read() == data, p


def _files(base):
    for root, _, files in os.walk(base):
        for f in files:
            if "__pycache__" not in root:
                yield os.path.relpath(os.path.join(root, f), base)
