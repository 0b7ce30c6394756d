"""Diff a finished parity run of the PyTorch/CUDA port against the
reference's published table.

Reads the run's per-step results.csv (utils/reporting.py layout), aggregates
it the reference average_csv.py way, and prints the measured old/new/all
mIoU next to the TPAMI Table-1 row transcribed in BASELINE.md (MiB+UCD,
which is the `--method UCD` configuration). Exit code 0 iff the all-classes
mIoU is within the seed-variance band (+-0.5) of the published number, or no
expectation exists for the task.

Usage: python scripts/parity_report_torch.py CSV_PATH DATASET TASK [--overlap]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ucd_torch import tasks as task_registry
from ucd_torch.utils.reporting import aggregate_csv, format_report

# BASELINE.md TPAMI Table 1, MiB+UCD rows: (old, new, all) mIoU in percent.
EXPECTED = {
    ("voc", "19-1", True): (73.7, 34.0, 71.7),
    ("voc", "19-1", False): (74.3, 28.4, 72.0),
    ("voc", "15-5", True): (78.5, 50.7, 71.5),
    ("voc", "15-5", False): (73.0, 46.2, 66.3),
    ("voc", "15-5s", True): (51.9, 13.1, 42.2),
    ("voc", "15-5s", False): (53.3, 14.4, 43.5),
}

TOLERANCE = 0.5  # BASELINE.md: match within ~+-0.5 given seed variance


def main(argv):
    if len(argv) < 3:
        print(__doc__)
        return 2
    csv_path, dataset, task = argv[0], argv[1], argv[2]
    overlap = "--overlap" in argv
    first = len(task_registry.get_task_dict(dataset, task)[0]) - 1
    agg = aggregate_csv(csv_path, first)
    print(format_report(agg))

    key = (dataset, task, overlap)
    exp = EXPECTED.get(key)
    if exp is None:
        print(f"[parity] no published reference row for {key}; "
              "recorded, not judged")
        return 0
    got = (100 * agg["first_classes_miou"], 100 * agg["last_classes_miou"],
           100 * agg["final_miou"])
    names = ("old-classes", "new-classes", "all-classes")
    print(f"[parity] reference (TPAMI Table 1, MiB+UCD, "
          f"{task}{'-ov' if overlap else ''}):")
    ok = True
    for name, g, e in zip(names, got, exp):
        delta = g - e
        print(f"  {name:12s} measured {g:6.2f}  published {e:6.2f}  "
              f"delta {delta:+.2f}")
        if name == "all-classes" and abs(delta) > TOLERANCE:
            ok = False
    print(f"[parity] all-classes mIoU within +-{TOLERANCE}: "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
