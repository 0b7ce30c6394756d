"""`python -m ucd_torch.cli train` on two CPU processes (gloo, a `file://`
rendezvous, --coordinator/--num_processes/--process_id) against the
one-process run of the same command: the port's counterpart of
tests/test_multiprocess.py.

VOC 19-1 step 0, FT, ResNet-50 at 32x32, float32, 8 synthetic train
images = one global batch of 8 (4 a process), so both runs take the same
single step; 4 val images (2 a process, each padded to its local batch).

- one checkpoint, written by process 0 alone, equal to the one-process
  run's up to float32 rounding: the BatchNorm running statistics (the
  forward over the global batch) |e| <= 1e-3 max|ref| a tensor; the first
  gradient (the momentum buffer) within 10 % overall and 15 % a tensor,
  because float32 rounding alone moves this model's first gradient by a
  few percent (its train-mode BatchNorms at 2x2 maps are
  cancellation-dominated; tests/test_torch_dp_step.py holds the two-rank
  step to the global-batch step at float64); and the parameters differ by
  exactly what the two gradients do, |e| <= 1e-6 (the same start and the
  same update rule);
- the same mIoU (|e| < 1e-5, as tests/test_multiprocess.py bounds the JAX
  runs) from the all-reduced confusion matrix, and the global sample
  count (4) in the validate and final-test reports;
- `--crop_val` (full-size eval) refused in a two-process run.
"""

import json
import os
import re
import subprocess
import sys

import torch

from torch_port_helpers import free_tmp_path  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(tmp_path, tag, n, extra=()):
    argv = [sys.executable, "-m", "ucd_torch.cli", "train",
            "--dataset", "voc", "--task", "19-1", "--step", "0",
            "--method", "FT", "--backbone", "resnet50", "--crop_size", "32",
            "--batch_size", "8", "--epochs", "1", "--dtype", "float32",
            "--no_pretrained", "--synthetic", "8", "--num_workers", "1",
            "--device", "cpu", "--logdir", str(tmp_path / tag / "logs"),
            "--ckpt_dir", str(tmp_path / tag / "ckpt"), *extra]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if n == 1:
        return [subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)]
    rdzv = f"file://{tmp_path}/rdzv_{tag}"
    return [subprocess.Popen(
        argv + ["--coordinator", rdzv, "--num_processes", str(n),
                "--process_id", str(i)], env=env, cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(n)]


def _logs(procs):
    out = [p.communicate(timeout=600)[0] for p in procs]
    return [(p.returncode, log) for p, log in zip(procs, out)]


def _ckpt(tmp_path, tag):
    d = tmp_path / tag / "ckpt"
    files = sorted(p.name for p in d.iterdir())
    assert len(files) == 1, files  # one file, no torn temporaries
    return torch.load(d / files[0], weights_only=True)


def test_two_process_train_matches_one_process(free_tmp_path):
    runs = {"two": _launch(free_tmp_path, "two", 2),
            "one": _launch(free_tmp_path, "one", 1),
            "guard": _launch(free_tmp_path, "guard", 2, ["--crop_val"])}
    logs = {k: _logs(v) for k, v in runs.items()}
    for tag in ("two", "one"):
        for rc, log in logs[tag]:
            assert rc == 0, f"{tag} run failed:\n{log[-4000:]}"
    # full-size eval is refused up front in both processes of a
    # two-process run
    for rc, log in logs["guard"]:
        assert rc != 0 and "crop_val=False (full-size eval) is not " \
            "supported in multi-process runs" in log, log[-3000:]

    def miou(log):
        return [json.loads(x) for x in log.splitlines()
                if x.startswith("{") and "mean_iou" in x]

    # process 0 reports, process 1 prints no result
    (_, log0), (_, log1) = logs["two"]
    (_, log_one), = logs["one"]
    assert miou(log1) == [] and "Total samples" not in log1
    (two,), (one,) = miou(log0), miou(log_one)
    assert abs(two["mean_iou"] - one["mean_iou"]) < 1e-5, (two, one)
    # the validate and final-test reports count the global samples
    assert re.findall(r"Total samples: (\d+)", log0) == ["4", "4"]
    assert re.findall(r"Total samples: (\d+)", log_one) == ["4", "4"]

    a, b = _ckpt(free_tmp_path, "two"), _ckpt(free_tmp_path, "one")
    assert a["step"] == b["step"] == 1 and a["epoch"] == b["epoch"] == 0
    # the running statistics: the forward over the global batch
    stats_a, stats_b = (c["model_state"]["batch_stats"] for c in (a, b))
    assert set(stats_a) == set(stats_b)
    for k, v in stats_b.items():
        if v.is_floating_point():
            err = float((stats_a[k] - v).abs().max())
            assert err <= 1e-3 * float(v.abs().max()), (k, err)
        else:
            assert torch.equal(stats_a[k], v), k
    # the first step's gradient (its momentum buffer), overall and per
    # tensor
    ta, tb = a["optimizer_state"]["trace"], b["optimizer_state"]["trace"]
    assert set(ta) == set(tb) == set(b["model_state"]["params"])
    num = den = 0.0
    for k, v in tb.items():
        err, ref = float((ta[k] - v).norm()), float(v.norm())
        assert err <= 0.15 * ref, (k, err, ref)
        num, den = num + err ** 2, den + ref ** 2
    assert num ** 0.5 <= 0.1 * den ** 0.5, (num ** 0.5, den ** 0.5)
    # both runs started from the same parameters and applied the same
    # rule: the parameters differ by exactly what the gradients do
    # (nesterov's first update is lr * (1 + momentum) * the buffer)
    pa, pb = a["model_state"]["params"], b["model_state"]["params"]
    for k, v in pb.items():
        torch.testing.assert_close(pa[k] - v, -0.007 * 1.9 * (ta[k] - tb[k]),
                                   rtol=0, atol=1e-6, msg=k)
