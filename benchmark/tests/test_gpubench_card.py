"""On a CUDA card: one short run of a cell through the command the driver
runs, and the same command in a directory that holds only BENCHMARK.json
and the benchmark's folder, which must fail without a result. Run there
with `python3 -m pytest benchmark/tests -m gpu`; here they skip."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.lib.spec import HERE, ROOT

CMD = ["benchmark/run.py", "--workload", "voc15-5s.ucd.b24.eager",
       "--seed", str(2 ** 32 + 17), "--seconds", "3", "--trace", "0"]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_cell_runs_and_is_correct():
    _card()
    res = subprocess.run([sys.executable, *CMD], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_only_the_benchmark_gives_no_result(tmp_path):
    _card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, *CMD], cwd=tmp_path,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode != 0 and res.stdout.strip() == ""
