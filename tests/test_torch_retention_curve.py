"""Six-step VOC 15-5s retention curve through the port's CLI.

`python -m ucd_torch.cli run-task` runs all six steps of VOC 15-5s in one
process (restore from the previous step's checkpoint, grow the
classifier, MiB imprinting, the donor chain) on the learnable
color-coded synthetic task (--synthetic_learnable), for UCD and for
plain FT. The per-step report must show UCD keeping the first 15 classes
better than FT, which forgets them.

Mirrors tests/test_retention_curve.py:24-105
(`test_six_step_15_5s_ucd_beats_ft`): the JAX file's argument list
verbatim (`--no_pallas` and `--contrastive_capacity 256` included) plus
`--device cpu`, the same bars, and the `RETENTION` line. `chip_smoke.py`
phase 3i runs the same list on the card without `--no_pallas` (the
contrastive kernels on)."""

import csv
import json
import os

import pytest

# heavy end-to-end file, as its JAX original: excluded from the default
# selection (pytest.ini); run with -m slow
pytestmark = pytest.mark.slow

N_IMAGES = 48
EPOCHS = 25


def run_task_args(method: str, logdir: str, ckpt_dir: str) -> list:
    """The JAX test's `run-task` argument list
    (tests/test_retention_curve.py:33-44)."""
    return [
        "run-task", "--dataset", "voc", "--task", "15-5s", "--step", "0",
        "--method", method, "--backbone", "resnet50", "--crop_size", "64",
        "--output_stride", "8", "--batch_size", "8",
        "--epochs", str(EPOCHS), "--lr", "0.1", "--overlap",
        "--dtype", "float32", "--no_pretrained",
        "--synthetic_learnable", str(N_IMAGES),
        "--no_pallas", "--contrastive_capacity", "256",
        "--logdir", logdir, "--ckpt_dir", ckpt_dir,
    ]


def csv_path(logdir: str) -> str:
    return os.path.join(logdir, "15-5s-voc", "Experiment", "results.csv")


def _run_task(tmp_path, method):
    from ucd_torch.cli import main

    logdir = str(tmp_path / f"logs_{method}")
    rc = main(run_task_args(method, logdir, str(tmp_path / f"ckpt_{method}"))
              + ["--device", "cpu"])
    assert rc == 0
    path = csv_path(logdir)
    assert os.path.exists(path)
    return path


def _per_step_breakdown(path):
    """[(step, old_1_15, new_16_20, all)] per CSV row, 'X' -> absent."""
    with open(path) as f:
        rows = list(csv.reader(f))
    out = []
    for row in rows[1:]:
        step = int(row[0])
        vals = row[1:]

        def mean(sl):
            nums = [float(v) for v in sl
                    if v not in ("X", "") and v is not None]
            return sum(nums) / len(nums) if nums else float("nan")

        out.append((step, mean(vals[1:16]), mean(vals[16:21]), mean(vals)))
    return out


def retention_table(ucd, ft) -> str:
    lines = ["step |        UCD old/new/all        |        FT old/new/all"]
    for (s, uo, un, ua), (_, fo, fn_, fa) in zip(ucd, ft):
        lines.append(f"  {s}  | {uo:.3f} / {un:.3f} / {ua:.3f} | "
                     f"{fo:.3f} / {fn_:.3f} / {fa:.3f}")
    return "\n".join(lines)


def retention_bars(ucd, ft) -> dict:
    """Each value the JAX test's bars judge, with its margin to its bar."""
    ucd_avg_old = sum(r[1] for r in ucd[1:]) / 5
    ft_avg_old = sum(r[1] for r in ft[1:]) / 5
    final = ucd[-1][1] - ft[-1][1]
    return {"step0_old": {"value": ucd[0][1], "margin": ucd[0][1] - 0.3},
            "final_old_ucd_minus_ft": {"value": final,
                                       "margin": final - 0.05},
            "avg_old_ucd_minus_ft": {"value": ucd_avg_old - ft_avg_old,
                                     "margin": ucd_avg_old - ft_avg_old}}


def check_retention(ucd, ft) -> None:
    """The JAX test's bars (tests/test_retention_curve.py:81-95)."""
    assert [r[0] for r in ucd] == list(range(6))
    assert [r[0] for r in ft] == list(range(6))
    # step 0 must actually learn the first 15 classes (same config for both)
    assert ucd[0][1] > 0.3, f"step 0 didn't learn: {ucd[0]}"
    # final step: UCD retains the first-15 classes; FT forgets them
    ucd_final_old, ft_final_old = ucd[-1][1], ft[-1][1]
    assert ucd_final_old > ft_final_old + 0.05, (
        f"UCD old-class retention {ucd_final_old:.3f} does not beat "
        f"FT {ft_final_old:.3f}")
    # all-step average over the old classes: UCD above FT as well
    ucd_avg_old = sum(r[1] for r in ucd[1:]) / 5
    ft_avg_old = sum(r[1] for r in ft[1:]) / 5
    assert ucd_avg_old > ft_avg_old, (ucd_avg_old, ft_avg_old)


def retention_record(ucd, ft) -> dict:
    return {"ucd": [(r[0], round(r[1], 4), round(r[2], 4), round(r[3], 4))
                    for r in ucd],
            "ft": [(r[0], round(r[1], 4), round(r[2], 4), round(r[3], 4))
                   for r in ft]}


def test_six_step_15_5s_ucd_beats_ft(tmp_path):
    ucd = _per_step_breakdown(_run_task(tmp_path, "UCD"))
    ft = _per_step_breakdown(_run_task(tmp_path, "FT"))
    print(retention_table(ucd, ft))
    # the machine-readable datum, printed before the bars are judged
    print("RETENTION " + json.dumps(retention_record(ucd, ft)))
    print("RETENTION_BARS " + json.dumps(retention_bars(ucd, ft)))
    check_retention(ucd, ft)
