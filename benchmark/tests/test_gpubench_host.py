"""The run's host record (lib/host.py): the cpulist it prints, the card's
NUMA node as sysfs gives it or why there is none, the line itself, and in
a tiny run of the train driver the line logged once the window has closed;
and the end-to-end metric named `<name>.<part>` that reports the driver's
`<name>` (lib/spec.py), with the per-layer readers that read one quantity
under the names of such cells."""

from __future__ import annotations

import re

import pytest
import torch

from benchmark.lib import host
from benchmark.lib.spec import Benchmark
from benchmark.tests import tiny

ADDRESS = "0000:19:00.0"


@pytest.mark.parametrize("cpus, text", [
    ({0, 1, 2, 3, 8, 10, 11}, "0-3,8,10-11"),
    ({5}, "5"),
    ({7, 6, 0}, "0,6-7"),
])
def test_cpulist_is_formatted_shortest(cpus, text):
    assert host.format_cpulist(cpus) == text


@pytest.mark.parametrize("case, node, want", [
    ("node read", "1\n", "node 1"),
    ("node -1", "-1\n", "no NUMA node (-1)"),
    ("no numa_node file", None, "no NUMA node (FileNotFoundError)"),
    ("unreadable", "x\n", "no NUMA node (ValueError)"),
])
def test_card_node_from_sysfs(tmp_path, case, node, want):
    dev = tmp_path / ADDRESS
    dev.mkdir()
    if node is not None:
        (dev / "numa_node").write_text(node)
    assert host.card_node(ADDRESS, str(tmp_path)) == want, case
    assert host.card_node(None, str(tmp_path)) == "no card"


def test_host_line_names_cpus_card_load_and_dispatch(tmp_path, monkeypatch):
    monkeypatch.setattr(host.os, "sched_getaffinity",
                        lambda pid: {0, 1, 2, 3, 4, 5, 6, 7})
    (tmp_path / ADDRESS).mkdir()
    (tmp_path / ADDRESS / "numa_node").write_text("0\n")
    load = [(0.5, 0.25, 0.125), (1.0, 0.5, 0.25)]
    text = host.line(ADDRESS, load, 8, [0.150, 0.210, 0.120], str(tmp_path))
    assert text == (f"host: CPUs 0-7 (card {ADDRESS}, node 0); torch "
                    f"threads 8; load 0.50 0.25 0.12 -> 1.00 0.50 0.25; "
                    f"dispatch mean 160.00 ms, max 210.00 ms over 3 calls")
    assert host.line(None, load, 1, []).endswith(
        "; dispatch not timed")


def test_a_run_logs_its_host_record(capsys):
    """In a tiny run of the driver the host record comes once, after the
    window, with the window's dispatch times."""
    ctx = tiny.context("voc15-5s.ucd.b24.eager", seconds=0.3)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = ctx.run()
    finally:
        torch.set_num_threads(n)
    assert out["result"]["correct"], out["checks"]
    err = capsys.readouterr().err
    found = re.findall(r"host: CPUs [0-9,\-]+ \(no card\); torch threads 2; "
                       r"load [0-9. ]+ -> [0-9. ]+; dispatch mean [0-9.]+ "
                       r"ms, max [0-9.]+ ms over \d+ calls", err)
    assert len(found) == 1, err
    assert err.index("host: ") > err.index("set-up ")


@pytest.mark.parametrize("name, want", [
    ("train_img_per_s", 10.0),
    ("train_img_per_s.eager", 10.0),
    ("train_img_per_s.eager.b24", 10.0),
    ("setup_s", 3.0),
    ("step_mfu", None),
    ("step_mfu.eager", None),
])
def test_a_suffixed_metric_reports_the_drivers_value(name, want):
    values = {"train_img_per_s": 10.0, "setup_s": 3.0,
              "train_img_per_s.b2": 7.0}
    assert Benchmark.e2e_value(name, values) == want
    assert Benchmark.e2e_value("train_img_per_s.b2", values) == 7.0


@pytest.mark.parametrize("name", ["contrastive_roofline",
                                  "fused_loss_roofline", "step.mfu_pct",
                                  "device.idle_pct.train"])
def test_an_eager_reader_reads_what_its_original_reads(name):
    bench = Benchmark.load()
    eager = {m["name"] for m in bench.per_layer("voc15-5s.ucd.b24.eager")}
    assert name + ".eager" in eager and name not in eager
    p, b, h = 24 * 32 * 32, 24, 32
    records = {
        "steps": 40, "window_s": 20.0, "step_flops": 4e13, "batch": b,
        "traced_steps": 2, "dispatch_s": [0.1, 0.2], "steps_per_call": 1,
        "launches": {"contrastive.launches_pass1": 2,
                     "fused_ce_kd.launches_fwd": 2,
                     "fused_ce_kd.launches_bwd": 2},
        "contrastive": {"P": p, "M": 2 * p, "D": 256, "C": 16, "bf16": True},
        "fused_loss": {"B": b, "h": h, "w": h, "C": 17, "Co": 16, "H": 512,
                       "W": 512, "old_cl": 16},
        "trace": {"window_s": 2.0, "busy_s": 1.5, "ops": {},
                  "kernels": {"contrastive_pass1_mma_kernel": (0.01, 2),
                              "fused_loss_fwd_kernel": (0.002, 2)}}}
    ade = bench.read_per_layer("ade100-50.ucd.b24.k4", records)
    voc = bench.read_per_layer("voc15-5s.ucd.b24.eager", records)
    assert ade[name]["value"] > 0
    assert voc[name + ".eager"] == ade[name]
