"""BENCHMARK.json against the benchmark's contract, and the result line a
run prints."""

from __future__ import annotations

import io
import json
import math
import os
import re
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark.lib import report
from benchmark.lib.spec import (ROOT, Benchmark, SpecError, check_name,
                                check_unit, path_of)
from benchmark.tests import tiny

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/") \
            and ".." not in word
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_run_seconds_fits_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_entries_have_only_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
        assert c["file"] == "benchmark/configs/" + c["name"] + ".json"
        assert len(c["reduced"]) <= 16
        for text in (c["source"], c["why"]):
            assert LINE.match(text)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w[k] for w in SPEC["workloads"]
              for k in ("name", "config", "traffic")]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names:
        check_name(n, "name")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        check_unit(m["unit"], m["name"])
    for bad in ("a b", "a,b", "a/b", ".x", "", "x" * 65, "µs"):
        with pytest.raises(SpecError):
            check_name(bad, "name")
    for bad in ("tokens per second", "", "x" * 17, "µs"):
        with pytest.raises(SpecError):
            check_unit(bad, "unit")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    bench = Benchmark.load()
    assert [m["name"] for m in SPEC["end_to_end"]
            if m["name"] == "setup_s"] == ["setup_s"]
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in bench.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.per_layer(w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)


def test_every_named_file_exists():
    bench = Benchmark.load()
    for w in SPEC["workloads"]:
        tr = bench.traffic(w["traffic"])
        assert os.path.isfile(path_of("drivers", tr["driver"]))
        assert os.path.isfile(path_of("limits", w["name"]))
        bench.config(w["config"])
    for m in SPEC["per_layer"]:
        assert os.path.isfile(path_of("metrics", m["name"]))


def test_shares_are_named_for_the_contract():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_result_line(tmp_path):
    """A whole run on the CPU at a tiny size prints the result line last,
    with its keys, and the compared numbers last on stderr."""
    ctx = tiny.context("voc15-5s.ucd.b24.eager", dtype="float32",
                       seconds=1.0)
    out = ctx.run()
    result = dict(out["result"], device=dict(out["result"]["device"]))
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        report.emit(result, out["checks"])
    last = json.loads(so.getvalue().strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(last)
    assert last["correct"] is True and last["attempted"] > 0
    assert last["failed"] == 0
    assert set(last["metrics"]) == {"train_img_per_s.eager",
                                    "train_peak_mem_gb", "setup_s"}
    for v in last["metrics"].values():
        assert math.isfinite(v["value"]) and v["value"] >= 0
    assert last["metrics"]["train_img_per_s.eager"]["value"] > 0
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert [c for c in last["checks"]] == ["loss_gap", "grad_gap",
                                           "change_gap"]
    assert all(c["limit"] > 0 for c in last["checks"].values())
    assert se.getvalue().strip().splitlines()[-1].startswith(
        "check change_gap")
