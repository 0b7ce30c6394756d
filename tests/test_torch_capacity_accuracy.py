"""Accuracy check of the port's `--contrastive_capacity` knob: the
bounded-anchor path must keep the method's learnability, not just its
throughput. Trains step 0 once, then runs the SAME step-1 distillation
twice, on the full pixel set (capacity 0, the reference semantics) and on
a bounded anchor budget (64 of the 512 anchor slots of a batch at 64x64,
os 8), with identical data and seeds; both must retain the old classes,
and the bounded run's old-class retention must stay within 0.10 of the
full run's.

Mirrors tests/test_capacity_accuracy.py:33-100
(`test_bounded_capacity_preserves_retention`), built through the port's
public API on the CPU, with the helpers and constants of
tests/test_torch_incremental_learnability.py."""

import pytest

# tests/ is not a package; pytest puts this directory on sys.path
from test_torch_incremental_learnability import (
    base_kw, check_retained, check_step0, train_step0, train_step1)

pytestmark = pytest.mark.slow


def test_bounded_capacity_preserves_retention():
    kw = base_kw(use_pallas_contrastive=False)

    # ---- step 0 (shared): classes {1,2} ----
    model0, iou0 = train_step0({**kw, "contrastive_capacity": 0})
    check_step0(iou0)

    # ---- step 1 twice: full pixel set vs bounded anchor budget ----
    ious = {}
    for capacity in (0, 64):
        m1, ious[capacity] = train_step1(
            {**kw, "contrastive_capacity": capacity}, model0)
        assert m1["l_con"] != 0.0, (capacity, m1)
    print("CAPACITY", {"step0": {c: float(iou0[c]) for c in (1, 2)},
                       **{f"capacity_{cap}": {c: float(iou[c])
                                              for c in (1, 2, 3)}
                          for cap, iou in ious.items()}})

    iou_full, iou_cap = ious[0], ious[64]
    for iou, tag in ((iou_full, "full: "), (iou_cap, "capacity=64: ")):
        check_retained(iou, iou0, tag)

    old_full = (iou_full[1] + iou_full[2]) / 2
    old_cap = (iou_cap[1] + iou_cap[2]) / 2
    assert old_cap > old_full - 0.10, (
        f"bounded capacity degraded old-class retention: "
        f"full={old_full:.3f} cap64={old_cap:.3f}")
