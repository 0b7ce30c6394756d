"""The import guard: no module of JAX or of the JAX package in a run, and
nothing of the benchmark reads the JAX package's old benchmark files."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.lib import report
from benchmark.lib.spec import HERE, ROOT

OLD = ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE")


def test_forbidden_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax.linen": 1,
            "ucd_tpu.ops": 1, "ucd_torch": 1, "ucd_torch.ops": 1,
            "jaxtyping": 1, "ucd_tpu_extra": 1, "benchmark": 1}
    assert report.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "ucd_tpu.ops"]


def _sources():
    for root, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and "__pycache__" not in root:
                yield os.path.join(root, f)


def test_sources_import_no_jax_and_read_no_old_benchmark():
    for path in _sources():
        text = open(path).read()
        tree = ast.parse(text, path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in report.FORBIDDEN, (path, n)
        if os.path.basename(path) != "test_gpubench_guard.py":
            for word in OLD:
                assert word not in text, (path, word)


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU in a fresh interpreter, then its
    sys.modules."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.lib import report\n"
        "out = tiny.context('voc15-5s.ucd.b24.eager', seconds=0.5).run()\n"
        "assert out['result']['correct'], out\n"
        "print('FOUND', report.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "FOUND []"


def test_run_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "voc15-5s.ucd.b24.eager", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr
