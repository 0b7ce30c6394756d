"""Multi-step result aggregation.

The port's own copy of ucd_tpu/utils/reporting.py: the per-step class-IoU
CSV that `run-task` appends to, and its aggregation into the final mIoU,
the all-step average and the first-classes / last-classes breakdown (e.g.
VOC 15-5s: classes 1-15 against 16-20)."""

from __future__ import annotations

import csv
import os
from typing import Sequence


def write_step_csv(path: str, step: int, class_iou: dict) -> None:
    """Append one row per step: step, then per-class IoU ('X' if absent)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["step"] + [f"class_{k}" for k in class_iou])
        w.writerow([step] + [class_iou[k] for k in class_iou])


def _safe_mean(vals: Sequence) -> float:
    nums = [float(v) for v in vals if _is_float(v)]
    return sum(nums) / len(nums) if nums else float("nan")


def _is_float(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def aggregate_csv(path: str, first_classes: int) -> dict:
    """Final / average mIoU and the old-against-new breakdown: 'first' =
    classes [1, first_classes], 'last' = the rest; the background counts in
    'all'."""
    with open(path) as f:
        rows = list(csv.reader(f))
    data = rows[1:]
    per_step_miou = [_safe_mean(row[1:]) for row in data]
    final_row = data[-1][1:]
    # class_0 is background; first/last split over classes 1..C
    first = final_row[1:1 + first_classes]
    last = final_row[1 + first_classes:]
    return {
        "final_miou": _safe_mean(final_row),
        "avg_miou": sum(per_step_miou) / len(per_step_miou),
        "first_classes_miou": _safe_mean(first),
        "last_classes_miou": _safe_mean(last),
        "per_step_miou": per_step_miou,
    }


def format_report(agg: dict) -> str:
    return ("Final mIoU: {final_miou:.4f}\n"
            "All-step average mIoU: {avg_miou:.4f}\n"
            "First-classes mIoU: {first_classes_miou:.4f}\n"
            "Last-classes mIoU: {last_classes_miou:.4f}".format(**agg))
