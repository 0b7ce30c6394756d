"""Incremental-dataset machinery: image filtering, label remapping, subsets.

The port's own copy of ucd_tpu/data/incremental.py: which images a step
keeps (overlap / disjoint), the per-dataset label remaps as one 256-entry
LUT gather per mask, and the index subset that applies the transform and
the remap.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def strip_zero(labels: list[int]) -> list[int]:
    return [l for l in labels if l != 0]


def filter_images(masks, labels, labels_old=None, overlap=True):
    """Keep image i if it contains >=1 new-class pixel (overlap mode) and —
    in disjoint mode — only {new ∪ old ∪ bkg ∪ 255} pixels
    (reference dataset/utils.py:19-42). `masks` is an iterable of label
    arrays (or of callables returning them)."""
    labels = strip_zero(list(labels))
    labels_old = list(labels_old or [])
    label_set = set(labels)
    cum_set = set(labels) | set(labels_old) | {0, 255}

    idxs = []
    for i, m in enumerate(masks):
        arr = np.asarray(m() if callable(m) else m)
        cls = np.unique(arr)
        has_new = any(int(x) in label_set for x in cls)
        if overlap:
            keep = has_new
        else:
            keep = has_new and all(int(x) in cum_set for x in cls)
        if keep:
            idxs.append(i)
    return idxs


def group_images(masks, labels):
    """Group image indices by contained label, keeping only images whose
    classes are a subset of labels ∪ {0, 255}
    (reference dataset/utils.py:5-16)."""
    idxs = {lab: [] for lab in labels}
    label_set = set(labels)
    cum = label_set | {0, 255}
    for i, m in enumerate(masks):
        cls = np.unique(np.asarray(m() if callable(m) else m))
        if all(int(x) in cum for x in cls):
            for x in cls:
                if int(x) in label_set:
                    idxs[int(x)].append(i)
    return idxs


def load_or_compute_idxs(idxs_path: Optional[str], compute_fn):
    """Reuse the shipped .npy split caches verbatim
    (reference dataset/voc.py:158-163; path convention tasks.py:195)."""
    if idxs_path is not None and os.path.exists(idxs_path):
        return np.load(idxs_path).astype(np.int64).tolist()
    idxs = compute_fn()
    if idxs_path is not None:
        os.makedirs(os.path.dirname(idxs_path), exist_ok=True)
        np.save(idxs_path, np.array(idxs, dtype=np.int64))
    return idxs


def build_remap_lut(order: Sequence[int], keep: Sequence[int],
                    masking_value: int, ignore_mapping: Optional[int] = None,
                    table_size: int = 256) -> np.ndarray:
    """LUT with lut[x] = index of x in `order` when x in `keep`, else
    masking_value; lut[255] = ignore_mapping if given.

    Equivalent to the reference's inverted_order + masking lambda
    (dataset/voc.py:182-207) as one vectorized gather."""
    lut = np.full(table_size, masking_value, np.int32)
    inverted = {lab: i for i, lab in enumerate(order)}
    for lab in keep:
        if lab == 255:
            continue
        if lab in inverted:
            lut[lab] = inverted[lab]
    if ignore_mapping is not None:
        lut[255] = ignore_mapping
    return lut


def voc_remap_lut(labels, labels_old, masking: bool = True,
                  data_masking: str = "current") -> np.ndarray:
    """VOC semantics (dataset/voc.py:180-211): order=[0]+old+new;
    keep={0}∪new(∪old)∪{255}; 255 preserved; future classes -> bkg 0."""
    labels = strip_zero(list(labels))
    labels_old = strip_zero(list(labels_old or []))
    order = [0] + labels_old + labels
    masking_value = 0
    if not masking:
        keep = order
    elif data_masking == "current":
        keep = [0] + labels
    elif data_masking == "current+old":
        keep = [0] + labels_old + labels
    elif data_masking == "new":
        keep = [0] + labels
        masking_value = 255
    else:
        raise NotImplementedError(data_masking)
    return build_remap_lut(order, keep, masking_value, ignore_mapping=255)


def ade_remap_lut(labels, labels_old, masking: bool = True,
                  ignore_test_bg: bool = False) -> np.ndarray:
    """ADE semantics (dataset/ade.py:121-150): keep = new labels only when
    masking; 0 (void) and unseen -> masking_value; note the reference does NOT
    preserve 255 under masking (no +[255]); with ignore_test_bg the void maps
    to 255."""
    labels = strip_zero(list(labels))
    labels_old = strip_zero(list(labels_old or []))
    order = [0] + labels_old + labels
    masking_value = 255 if ignore_test_bg else 0
    if masking:
        keep = labels
        lut = build_remap_lut(order, keep, masking_value)
        lut[0] = 255 if ignore_test_bg else 0
    else:
        lut = build_remap_lut(order, order, masking_value, ignore_mapping=255)
        if ignore_test_bg:
            lut[0] = 255
    return lut


def city_remap_lut(labels, labels_old, train: bool = True,
                   masking: bool = True) -> np.ndarray:
    """Cityscapes semantics (dataset/cityscape.py:137-156): masking_value = 0
    for train, 255 for val; keep = {0}∪new∪{255} with 255 -> masking_value."""
    labels = strip_zero(list(labels))
    labels_old = strip_zero(list(labels_old or []))
    order = [0] + labels_old + labels
    masking_value = 0 if train else 255
    keep = ([0] + labels) if masking else order
    lut = build_remap_lut(order, keep, masking_value,
                          ignore_mapping=masking_value)
    return lut


CITY_ID_TO_20 = np.zeros(35, np.int32)
# 34-class labelIds -> 20 (0=void + 19 train classes)
# (reference dataset/cityscape.py:52-59 _classes/_key tables)
for _i, _c in enumerate([7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25,
                         26, 27, 28, 31, 32, 33]):
    CITY_ID_TO_20[_c] = _i + 1

CITY_ID_TO_TRAINID = np.full(35, 255, np.int32)
# domain-incremental variant: 19 train-ids, unknown=255
# (reference dataset/cityscapes_domain.py:18-54)
for _i, _c in enumerate([7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25,
                         26, 27, 28, 31, 32, 33]):
    CITY_ID_TO_TRAINID[_c] = _i

CITY_TO_DOMAIN_ID = {
    "aachen": 0, "bremen": 1, "darmstadt": 2, "erfurt": 3, "hanover": 4,
    "krefeld": 5, "strasbourg": 6, "tubingen": 7, "weimar": 8, "bochum": 9,
    "cologne": 10, "dusseldorf": 11, "hamburg": 12, "jena": 13,
    "monchengladbach": 14, "stuttgart": 15, "ulm": 16, "zurich": 17,
    "frankfurt": 18, "lindau": 19, "munster": 20,
}


class MaskLabels:
    """Standalone label-masking transform: keep `labels_to_keep`, map the rest
    to `mask_value` (reference dataset/utils.py:90-108, done as a LUT gather
    instead of nested per-pixel apply_)."""

    def __init__(self, labels_to_keep, mask_value: int = 0):
        self.lut = np.full(256, mask_value, np.int32)
        for lab in labels_to_keep:
            if 0 <= lab < 256:
                self.lut[lab] = lab

    def __call__(self, lbl: np.ndarray) -> np.ndarray:
        return self.lut[np.clip(lbl.astype(np.int64), 0, 255)]


class Subset:
    """Index-subset with paired transform + LUT label remap
    (reference dataset/utils.py:45-87)."""

    def __init__(self, dataset, indices, transform=None, remap_lut=None):
        self.dataset = dataset
        self.indices = list(indices)
        self.transform = transform
        self.remap_lut = remap_lut

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        img, lbl = self.dataset[self.indices[idx]]
        img = np.asarray(img)
        lbl = np.asarray(lbl)
        if self.transform is not None:
            img, lbl = self.transform(img, lbl, rng)
        if self.remap_lut is not None:
            from .native import remap_labels
            lbl = remap_labels(np.asarray(lbl), self.remap_lut)
        return img, lbl

    def get(self, idx, rng=None):
        return self.__getitem__(idx, rng)

    def __len__(self):
        return len(self.indices)
