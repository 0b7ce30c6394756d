"""Dataset readers: VOC-aug / ADE20k / Cityscapes (+ domain-incremental
variant) and the synthetic in-memory datasets for tests and smoke runs.

The port's own copy of ucd_tpu/data/datasets.py. Each incremental dataset
is a base reader + a cached index filter + a LUT remap through
`incremental.Subset`.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from .incremental import (
    CITY_ID_TO_20,
    CITY_ID_TO_TRAINID,
    CITY_TO_DOMAIN_ID,
    Subset,
    ade_remap_lut,
    city_remap_lut,
    filter_images,
    load_or_compute_idxs,
    strip_zero,
    voc_remap_lut,
)

from PIL import Image


def decode_rgb(path: str) -> np.ndarray:
    """Decode an image file to an RGB uint8 array (no convert("RGB") copy
    for an image that is RGB already, as every JPEG is)."""
    im = Image.open(path)
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.asarray(im)

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

CITY_CLASSES = [
    "void", "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky", "person",
    "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]


class VOCSegmentation:
    """VOC2012 + SegmentationClassAug (reference dataset/voc.py:38-116):
    split files under <root>/splits; train_aug.txt lines are
    '/JPEGImages/x.jpg /SegmentationClassAug/x.png'."""

    def __init__(self, root: str, image_set: str = "train", is_aug: bool = True):
        self.root = os.path.expanduser(root)
        splits_dir = os.path.join(self.root, "splits")
        if is_aug and image_set == "train":
            split_f = os.path.join(splits_dir, "train_aug.txt")
        else:
            split_f = os.path.join(splits_dir, image_set + ".txt")
        if not os.path.exists(split_f):
            raise FileNotFoundError(split_f)
        with open(split_f) as f:
            file_names = [x.strip().split(" ") for x in f.readlines()]
        self.images = [(os.path.join(self.root, a.lstrip("/")),
                        os.path.join(self.root, b.lstrip("/")))
                       for a, b in file_names]

    def __getitem__(self, index):
        img = decode_rgb(self.images[index][0])
        lbl = np.asarray(Image.open(self.images[index][1]))
        return img, lbl

    def get_mask(self, index):
        return np.asarray(Image.open(self.images[index][1]))

    def __len__(self):
        return len(self.images)


class AdeSegmentation:
    """ADEChallengeData2016 (reference dataset/ade.py:35-74)."""

    def __init__(self, root: str, train: bool = True):
        root = os.path.expanduser(root)
        ade_root = os.path.join(root, "ADEChallengeData2016")
        split = "training" if train else "validation"
        ann = os.path.join(ade_root, "annotations", split)
        img = os.path.join(ade_root, "images", split)
        fnames = sorted(os.listdir(img))
        self.images = [(os.path.join(img, x), os.path.join(ann, x[:-3] + "png"))
                       for x in fnames]

    def __getitem__(self, index):
        img = decode_rgb(self.images[index][0])
        lbl = np.asarray(Image.open(self.images[index][1]))
        return img, lbl

    def get_mask(self, index):
        return np.asarray(Image.open(self.images[index][1]))

    def __len__(self):
        return len(self.images)


class CitySegmentation:
    """Cityscapes with the 34->20 label-id collapse
    (reference dataset/cityscape.py:35-101)."""

    def __init__(self, root: str, train: bool = True):
        root = os.path.expanduser(root)
        city_root = os.path.join(root, "Cityscapes")
        split = "train" if train else "val"
        img_folder = os.path.join(city_root, "leftImg8bit", split)
        mask_folder = os.path.join(city_root, "gtFine", split)
        self.images, self.masks = [], []
        for path in sorted(glob.glob(os.path.join(img_folder, "*", "*.png"))):
            city = os.path.basename(os.path.dirname(path))
            mask = os.path.join(
                mask_folder, city,
                os.path.basename(path).replace("leftImg8bit",
                                               "gtFine_labelIds"))
            if os.path.isfile(mask):
                self.images.append(path)
                self.masks.append(mask)

    def _collapse(self, mask):
        m = np.asarray(mask, np.int64)
        return CITY_ID_TO_20[np.clip(m, 0, 34)]

    def __getitem__(self, index):
        img = decode_rgb(self.images[index])
        lbl = self._collapse(np.asarray(Image.open(self.masks[index])))
        return img, lbl.astype(np.uint8)

    def get_mask(self, index):
        return self._collapse(np.asarray(Image.open(self.masks[index])))

    def __len__(self):
        return len(self.images)


class CityscapesSegmentationDomain:
    """Domain-incremental Cityscapes: steps = cities, labels = 19 train-ids
    (reference dataset/cityscapes_domain.py:79-145)."""

    def __init__(self, root: str):
        root = os.path.expanduser(root)
        ann = os.path.join(root, "gtFine")
        img = os.path.join(root, "leftImg8bit")
        self.items = []
        for split in ("train", "val"):
            for path in sorted(glob.glob(os.path.join(img, split, "*", "*.png"))):
                city = os.path.basename(os.path.dirname(path))
                mask = os.path.join(
                    ann, split, city,
                    os.path.basename(path)[:-15] + "gtFine_labelIds.png")
                self.items.append((path, mask, CITY_TO_DOMAIN_ID[city]))

    def __getitem__(self, index):
        path, mask, _ = self.items[index]
        img = decode_rgb(path)
        m = np.asarray(Image.open(mask), np.int64)
        lbl = CITY_ID_TO_TRAINID[np.clip(m, 0, 34)]
        return img, lbl.astype(np.uint8)

    def domain(self, index) -> int:
        return self.items[index][2]

    def __len__(self):
        return len(self.items)


class SyntheticSegmentation:
    """In-memory random dataset for tests and benches (the reference's only
    runnable smoke is real-data training; SURVEY.md §4)."""

    def __init__(self, n: int = 32, size: int = 64, n_classes: int = 21,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.images = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
        self.labels = rng.randint(0, n_classes, size=(n, size, size)).astype(
            np.uint8)

    def __getitem__(self, index):
        return self.images[index], self.labels[index]

    def get_mask(self, index):
        return self.labels[index]

    def __len__(self):
        return len(self.images)


class LearnableSynthetic:
    """Color-coded synthetic segmentation: each class paints its pixels with
    a distinct mean color + noise, so the task is actually LEARNABLE (unlike
    SyntheticSegmentation's random labels). Used by the learnability check —
    a functional test that the end-to-end training stack reduces loss and
    reaches nontrivial mIoU, which no amount of shape-level testing shows."""

    def __init__(self, n: int = 32, size: int = 64, n_classes: int = 4,
                 seed: int = 0, noise: float = 18.0, color_seed: int = 1234):
        assert n_classes <= 27, "lattice palette supports up to 27 classes"
        rng = np.random.RandomState(seed)
        # per-class anchor colors from a SEPARATE seed: train/val splits with
        # different layout seeds must share the class->color mapping.
        # Colors come from a 3x3x3 RGB lattice (pairwise distance >= 88),
        # shuffled by color_seed: at 20+ classes, uniformly-random colors
        # collide within the noise radius and the task stops being learnable
        # — the lattice keeps every class pair separable.
        grid = np.array([[r, g, b]
                         for r in (40, 128, 216)
                         for g in (40, 128, 216)
                         for b in (40, 128, 216)], dtype=np.int64)
        perm = np.random.RandomState(color_seed).permutation(len(grid))
        colors = grid[perm[:n_classes]]
        self.images = np.empty((n, size, size, 3), np.uint8)
        self.labels = np.empty((n, size, size), np.uint8)
        for i in range(n):
            lbl = np.zeros((size, size), np.uint8)
            # dense random class rectangles over background 0: with many
            # classes the per-class pixel budget is what sets how fast a
            # short CPU training run can learn, so keep foreground dominant
            for _ in range(8):
                c = rng.randint(1, n_classes)
                h0, w0 = rng.randint(0, (2 * size) // 3, size=2)
                h1 = h0 + rng.randint(size // 3, (2 * size) // 3)
                w1 = w0 + rng.randint(size // 3, (2 * size) // 3)
                lbl[h0:h1, w0:w1] = c
            img = colors[lbl].astype(np.float64)
            img += rng.randn(size, size, 3) * noise
            self.images[i] = np.clip(img, 0, 255).astype(np.uint8)
            self.labels[i] = lbl

    def __getitem__(self, index):
        return self.images[index], self.labels[index]

    def get_mask(self, index):
        return self.labels[index]

    def __len__(self):
        return len(self.images)


def make_incremental_dataset(dataset: str, root: str, train: bool,
                             transform, labels, labels_old=None,
                             idxs_path: Optional[str] = None,
                             masking: bool = True, overlap: bool = True,
                             base=None):
    """Assemble base reader + filter + remap (reference run.py:78-96 switch +
    per-dataset Incremental classes). `base` injects a prebuilt reader
    (e.g. SyntheticSegmentation) for tests."""
    labels = list(labels)
    labels_old = list(labels_old or [])

    if dataset == "city_domain":
        # steps are DOMAINS (city ids; 0 is a valid domain — no zero-strip);
        # 80/20 split via RandomState(1) shuffle
        # (reference cityscapes_domain.py:165-172); labels are already
        # train-ids, no remap
        if base is None:
            base = CityscapesSegmentationDomain(root)
        domains = set(labels)
        idxs = load_or_compute_idxs(
            idxs_path,
            lambda: [i for i in range(len(base)) if base.domain(i) in domains])
        rnd = np.random.RandomState(1)
        idxs = list(idxs)
        rnd.shuffle(idxs)
        n_train = int(0.8 * len(idxs))
        idxs = idxs[:n_train] if train else idxs[n_train:]
        return Subset(base, idxs, transform, None)

    if base is None:
        if dataset == "voc":
            base = VOCSegmentation(root, "train" if train else "val")
        elif dataset == "ade":
            base = AdeSegmentation(root, train)
        elif dataset == "city":
            base = CitySegmentation(root, train)
        else:
            raise NotImplementedError(dataset)

    new = strip_zero(labels)
    old = strip_zero(labels_old)
    assert not set(new) & set(old), "labels and labels_old must be disjoint"

    idxs = load_or_compute_idxs(
        idxs_path,
        lambda: filter_images((base.get_mask(i) for i in range(len(base))),
                              new, old, overlap=overlap))

    if dataset == "ade":
        lut = ade_remap_lut(new, old, masking=masking)
    elif dataset == "city":
        lut = city_remap_lut(new, old, train=train, masking=masking)
    else:
        lut = voc_remap_lut(new, old, masking=masking)
    return Subset(base, idxs, transform, lut)
