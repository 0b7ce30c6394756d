"""Every method family of the port through `run-task` on the CPU: two
steps of VOC 19-1 (ResNet-50, crop 32, batch 4, 10 synthetic images a
step) under LWF-MC in both iCaRL modes, `--bce`, EWC, PI and RW (RW also K
= 2 steps a call), as tests/test_cli_runtask.py drives the JAX CLI: a JSON
line a step with a finite mIoU, and each step's checkpoint, holding the
regularizer's export and snapshot under EWC / PI / RW."""

import json

import numpy as np
import pytest

from ucd_torch import cli as TCLI
from ucd_torch.engine import checkpoint as TK
from torch_port_helpers import (free_tmp_path,  # noqa: F401 (fixtures)
                                one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "free_tmp_path")

CASES = {
    "icarl_combined": ["--method", "LWF-MC"],
    "icarl_disjoint": ["--method", "LWF-MC", "--icarl_disjoint"],
    "bce": ["--bce"],
    "ewc": ["--method", "EWC"],
    "pi": ["--method", "PI"],
    "rw_bundled": ["--method", "RW", "--steps_per_call", "2"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_task_trains_the_family(tmp_path, capsys, case):
    ck, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    assert TCLI.main([
        "run-task", "--dataset", "voc", "--task", "19-1", "--step", "0",
        "--backbone", "resnet50", "--crop_size", "32", "--batch_size", "4",
        "--epochs", "1", "--lr", "0.01", "--dtype", "float32",
        "--no_pretrained", "--synthetic", "10", "--logdir", logs,
        "--ckpt_dir", ck, "--device", "cpu", *CASES[case]]) == 0
    steps = [json.loads(line) for line in capsys.readouterr().out
             .splitlines() if line.startswith("{")]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(np.isfinite(s["mean_iou"]) for s in steps)
    regularized = case in ("ewc", "pi", "rw_bundled")
    for step in (0, 1):
        saved = TK.load_checkpoint(f"{ck}/19-1-voc_Experiment_{step}")
        assert ("trainer_state" in saved) == regularized
        if regularized:
            assert set(saved["trainer_state"]) == {"regularizer",
                                                   "regularizer_full"}
