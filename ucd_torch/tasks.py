"""Incremental-task registry: task name -> {step -> class-id list}.

The port's own copy of ucd_tpu/tasks.py (the port imports nothing of the JAX
package). Pure data: the experiment grid for class-incremental semantic
segmentation on VOC / ADE20k / Cityscapes.

`get_task_labels(dataset, name, step)` returns the (new_labels, old_labels,
index-cache path stem) triple, and `get_per_task_classes` the per-step
classifier widths.
"""

from __future__ import annotations

TASKS_VOC = {
    "offline": {0: list(range(21))},
    "19-1": {
        0: list(range(20)),
        1: [20],
    },
    "19-1b": {
        0: [0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20],
        1: [5],
    },
    "15-5": {
        0: list(range(16)),
        1: [16, 17, 18, 19, 20],
    },
    "15-5s": {
        0: list(range(16)),
        1: [16], 2: [17], 3: [18], 4: [19], 5: [20],
    },
    "10-10": {
        0: list(range(11)),
        1: [11, 12, 13, 14, 15, 16, 17, 18, 19, 20],
    },
    "10-10s": {
        0: list(range(11)),
        1: [11], 2: [12], 3: [13], 4: [14], 5: [15],
        6: [16], 7: [17], 8: [18], 9: [19], 10: [20],
    },
    "10-5-5": {
        0: list(range(11)),
        1: [11, 12, 13, 14, 15],
        2: [16, 17, 18, 19, 20],
    },
}

TASKS_CITY = {
    "offline": {0: list(range(20))},
    "17-2": {
        0: list(range(18)),
        1: [18, 19],
    },
    "13-6": {
        0: list(range(14)),
        1: [14, 15, 16, 17, 18, 19],
    },
    "13-6s": {
        0: list(range(14)),
        1: [14], 2: [15], 3: [16], 4: [17], 5: [18], 6: [19],
    },
}

TASKS_ADE = {
    "offline": {0: list(range(151))},
    "100-50": {
        0: list(range(0, 101)),
        1: list(range(101, 151)),
    },
    "100-50b": {
        0: [0, 1, 3, 5, 6, 8, 9, 10, 12, 13, 14, 18, 19, 21, 22, 23, 24, 25, 26, 27,
            28, 29, 31, 32, 33, 34, 36, 38, 39, 40, 42, 43, 44, 45, 46, 47, 48, 49,
            53, 54, 55, 56, 57, 58, 60, 61, 62, 63, 69, 70, 71, 74, 75, 76, 77, 80,
            81, 82, 84, 86, 87, 90, 91, 93, 95, 96, 99, 100, 101, 103, 104, 105, 106,
            107, 109, 113, 116, 117, 119, 120, 121, 123, 125, 126, 128, 129, 130,
            131, 132, 133, 134, 135, 136, 140, 142, 143, 144, 147, 148, 149, 150],
        1: [2, 4, 7, 11, 15, 16, 17, 20, 30, 35, 37, 41, 50, 51, 52, 59, 64, 65, 66,
            67, 68, 72, 73, 78, 79, 83, 85, 88, 89, 92, 94, 97, 98, 102, 108, 110,
            111, 112, 114, 115, 118, 122, 124, 127, 137, 138, 139, 141, 145, 146],
    },
    "100-50c": {
        0: [0, 1, 5, 6, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 20, 23, 24, 25, 26, 27,
            28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 40, 41, 43, 44, 45, 46, 48, 50,
            52, 54, 56, 57, 61, 63, 65, 66, 67, 68, 69, 70, 71, 74, 76, 77, 78, 79,
            81, 82, 83, 84, 85, 86, 87, 90, 94, 95, 96, 97, 98, 99, 102, 105, 106,
            109, 110, 111, 112, 114, 115, 118, 119, 120, 121, 123, 124, 126, 128,
            129, 132, 133, 134, 135, 136, 138, 139, 142, 143, 144, 146, 147, 149],
        1: [2, 3, 4, 7, 15, 18, 21, 22, 38, 39, 42, 47, 49, 51, 53, 55, 58, 59, 60,
            62, 64, 72, 73, 75, 80, 88, 89, 91, 92, 93, 100, 101, 103, 104, 107, 108,
            113, 116, 117, 122, 125, 127, 130, 131, 137, 140, 141, 145, 148, 150],
    },
    "100-10": {
        0: list(range(0, 101)),
        1: list(range(101, 111)),
        2: list(range(111, 121)),
        3: list(range(121, 131)),
        4: list(range(131, 141)),
        5: list(range(141, 151)),
    },
    "100-10b": {
        0: [0, 1, 3, 5, 6, 8, 9, 10, 12, 13, 14, 18, 19, 21, 22, 23, 24, 25,
            26, 27, 28, 29, 31, 32, 33, 34, 36, 38, 39, 40, 42, 43, 44, 45,
            46, 47, 48, 49, 53, 54, 55, 56, 57, 58, 60, 61, 62, 63, 69, 70, 71,
            74, 75, 76, 77, 80, 81, 82, 84, 86, 87, 90, 91, 93, 95, 96, 99, 100,
            101, 103, 104, 105, 106, 107, 109, 113, 116, 117, 119, 120, 121,
            123, 125, 126, 128, 129, 130, 131, 132, 133, 134, 135, 136, 140,
            142, 143, 144, 147, 148, 149, 150],
        1: [11, 16, 50, 64, 66, 73, 89, 92, 145, 146],
        2: [30, 37, 51, 52, 72, 85, 98, 114, 115, 138],
        3: [2, 35, 65, 97, 110, 111, 112, 118, 124, 141],
        4: [4, 7, 15, 41, 67, 78, 79, 88, 108, 139],
        5: [17, 20, 59, 68, 83, 94, 102, 122, 127, 137],
    },
    "100-10c": {
        0: [0, 1, 5, 6, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 20, 23, 24, 25, 26,
            27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 40, 41, 43, 44, 45, 46,
            48, 50, 52, 54, 56, 57, 61, 63, 65, 66, 67, 68, 69, 70, 71, 74, 76,
            77, 78, 79, 81, 82, 83, 84, 85, 86, 87, 90, 94, 95, 96, 97, 98, 99,
            102, 105, 106, 109, 110, 111, 112, 114, 115, 118, 119, 120, 121, 123,
            124, 126, 128, 129, 132, 133, 134, 135, 136, 138, 139, 142, 143, 144,
            146, 147, 149],
        1: [3, 4, 7, 18, 39, 64, 73, 101, 113, 137],
        2: [47, 51, 55, 60, 62, 80, 116, 127, 140, 148],
        3: [22, 42, 49, 58, 59, 89, 91, 92, 108, 125],
        4: [2, 38, 53, 100, 104, 117, 130, 131, 141, 145],
        5: [15, 21, 72, 75, 88, 93, 103, 107, 122, 150],
    },
    "50": {
        0: list(range(0, 51)),
        1: list(range(51, 101)),
        2: list(range(101, 151)),
    },
    "50b": {
        0: [0, 1, 9, 14, 18, 22, 24, 25, 27, 28, 29, 32, 38, 42, 45, 46, 47, 48, 49,
            54, 56, 58, 61, 62, 63, 69, 74, 75, 76, 77, 81, 82, 84, 90, 93, 96, 100,
            103, 104, 109, 117, 119, 121, 123, 128, 129, 130, 134, 135, 136, 144],
        1: [3, 5, 6, 8, 10, 12, 13, 19, 21, 23, 26, 31, 33, 34, 36, 39, 40, 43, 44,
            53, 55, 57, 60, 70, 71, 80, 86, 87, 91, 95, 99, 101, 105, 106, 107, 113,
            116, 120, 125, 126, 131, 132, 133, 140, 142, 143, 147, 148, 149, 150],
        2: [2, 4, 7, 11, 15, 16, 17, 20, 30, 35, 37, 41, 50, 51, 52, 59, 64, 65, 66,
            67, 68, 72, 73, 78, 79, 83, 85, 88, 89, 92, 94, 97, 98, 102, 108, 110,
            111, 112, 114, 115, 118, 122, 124, 127, 137, 138, 139, 141, 145, 146],
    },
    "50c": {
        0: [0, 5, 10, 11, 12, 13, 16, 17, 19, 20, 23, 27, 28, 30, 31, 32, 33, 37, 43,
            46, 52, 56, 57, 65, 66, 69, 70, 74, 76, 77, 79, 82, 83, 86, 87, 105, 109,
            110, 111, 119, 128, 129, 132, 133, 134, 138, 142, 143, 144, 146, 147],
        1: [1, 6, 8, 9, 14, 24, 25, 26, 29, 34, 35, 36, 40, 41, 44, 45, 48, 50, 54,
            61, 63, 67, 68, 71, 78, 81, 84, 85, 90, 94, 95, 96, 97, 98, 99, 102, 106,
            112, 114, 115, 118, 120, 121, 123, 124, 126, 135, 136, 139, 149],
        2: [2, 3, 4, 7, 15, 18, 21, 22, 38, 39, 42, 47, 49, 51, 53, 55, 58, 59, 60,
            62, 64, 72, 73, 75, 80, 88, 89, 91, 92, 93, 100, 101, 103, 104, 107, 108,
            113, 116, 117, 122, 125, 127, 130, 131, 137, 140, 141, 145, 148, 150],
    },
}

# Domain-incremental Cityscapes: steps are CITIES (domain ids 0..20), classes
# are the fixed 19 train-ids every step. The reference ships the dataset class
# (dataset/cityscapes_domain.py:79-193) but never registered tasks for it
# (unreachable from run.py — SURVEY.md §2.5); these tables follow the standard
# 11-5 / 11-1 / 1-1 domain splits over the 21 cities.
TASKS_CITY_DOMAIN = {
    "offline": {0: list(range(21))},
    "11-5": {
        0: list(range(11)),
        1: list(range(11, 16)),
        2: list(range(16, 21)),
    },
    "11-1": {0: list(range(11)),
             **{i + 1: [11 + i] for i in range(10)}},
    "1-1": {i: [i] for i in range(21)},
}

_DATASET_TASKS = {"voc": TASKS_VOC, "ade": TASKS_ADE, "city": TASKS_CITY,
                  "city_domain": TASKS_CITY_DOMAIN}


def get_task_dict(dataset: str, name: str) -> dict[int, list[int]]:
    try:
        tasks = _DATASET_TASKS[dataset]
    except KeyError:
        raise NotImplementedError(f"unknown dataset {dataset!r}") from None
    if name not in tasks:
        raise KeyError(f"unknown task {name!r} for dataset {dataset!r}")
    return tasks[name]


def get_task_list() -> list[str]:
    """All valid task names (union over datasets)."""
    seen: list[str] = []
    for tasks in _DATASET_TASKS.values():
        for name in tasks:
            if name not in seen:
                seen.append(name)
    return seen


def get_task_labels(dataset: str, name: str, step: int):
    """(new labels, cumulative old labels, idx-cache path stem).

    Mirrors reference tasks.py:182-195 including the `data/{ds}/{name}` path
    convention so the shipped split caches load unchanged.
    """
    task_dict = get_task_dict(dataset, name)
    assert step in task_dict, f"step {step} out of range for task {name}"
    labels = list(task_dict[step])
    labels_old = [lab for s in range(step) for lab in task_dict[s]]
    return labels, labels_old, f"data/{dataset}/{name}"


def get_per_task_classes(dataset: str, name: str, step: int) -> list[int]:
    """Per-step classifier widths up to `step`."""
    task_dict = get_task_dict(dataset, name)
    assert step in task_dict, f"step {step} out of range for task {name}"
    return [len(task_dict[s]) for s in range(step + 1)]


def num_steps(dataset: str, name: str) -> int:
    return len(get_task_dict(dataset, name))
