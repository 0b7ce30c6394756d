"""The port's data pipeline against the JAX package's, bit for bit: the same
inputs and the same `np.random.Generator` seed give the same arrays.

Both packages bind a C++ build of their host ops when one is present
(native/data_ops.cc, and the port's copy of it); the host normalize there
rounds differently from the numpy formula. So the numpy/PIL paths are held
against each other here with both bindings switched off (`jax_plain`), and
the geometric ops, which the bindings compute PIL-exactly, also against
the JAX binding itself; tests/test_torch_native_ops.py holds the two
bindings against each other."""

import os

import numpy as np
import pytest
from PIL import Image

import ucd_torch.data as TD
import ucd_torch.data.incremental as TI
import ucd_torch.data.native as TN
import ucd_torch.data.transforms as TT
import ucd_tpu.data as JD
import ucd_tpu.data.incremental as JI
import ucd_tpu.data.native as JN
import ucd_tpu.data.transforms as JT
from ucd_torch.utils import viz as TV
from ucd_tpu.utils import viz as JV


@pytest.fixture
def jax_plain(monkeypatch):
    """Both packages' data ops on their numpy/PIL paths."""
    monkeypatch.setattr(JN, "_LIB", False)
    monkeypatch.setattr(TN, "_LIB", False)


def _pair(seed, h=37, w=53, n_classes=21, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    lbl = rs.randint(0, n_classes, (h, w)).astype(dtype)
    lbl[:3, :5] = 255
    return img, lbl


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


TRANSFORMS = {
    "resize": lambda M: M.Resize(24),
    "resize_tall": lambda M: M.Resize(61),
    "center_crop": lambda M: M.CenterCrop(30),
    "center_crop_pads": lambda M: M.CenterCrop(64),
    "pad": lambda M: M.Pad(3, fill=7),
    "lambda": lambda M: M.Lambda(lambda i, l: (i[::2], l[::2])),
    "rotation": lambda M: M.RandomRotation(25.0),
    "color_jitter": lambda M: M.ColorJitter(0.4, 0.4, 0.4),
    "hflip": lambda M: M.RandomHorizontalFlip(0.5),
    "vflip": lambda M: M.RandomVerticalFlip(0.5),
    "random_crop": lambda M: M.RandomCrop(32),
    "random_crop_pads": lambda M: M.RandomCrop(64),
    "rrc": lambda M: M.RandomResizedCrop(32),
    "rrc_flip": lambda M: M.RandomResizedCrop(32, flip_p=0.5),
    "rrc_fallback": lambda M: M.RandomResizedCrop(16, scale=(8.0, 9.0)),
    "to_tensor": lambda M: M.ToTensorNormalize(),
    "to_uint8": lambda M: M.ToTensorNormalize(to_float=False),
    "compose": lambda M: M.Compose([M.RandomCrop(30), M.ColorJitter(0.2),
                                    M.RandomHorizontalFlip(0.7)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_bits_match_jax(name, jax_plain):
    """Four seeds per transform, each pair through both packages with a
    fresh generator of that seed; the generators end in the same state."""
    for seed in range(4):
        img, lbl = _pair(seed)
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got = TRANSFORMS[name](TT)(img, lbl, rt)
        want = TRANSFORMS[name](JT)(img, lbl, rj)
        _same(got, want)
        assert rt.random() == rj.random()


def test_wide_labels_and_float_images_match_jax(jax_plain):
    img, lbl = _pair(9, dtype=np.int64)
    fimg = img.astype(np.float32) * 0.5
    for M in (TT, JT):
        assert M.ToTensorNormalize()(img, lbl)[1].dtype == np.int32
    _same(TT.ToTensorNormalize()(fimg, lbl), JT.ToTensorNormalize()(fimg, lbl))
    _same(TT.ToTensorNormalize(to_float=False)(fimg * 3, lbl),
          JT.ToTensorNormalize(to_float=False)(fimg * 3, lbl))
    x = TT.ToTensorNormalize()(img, lbl)[0]
    np.testing.assert_array_equal(TT.Denormalize()(x), JT.Denormalize()(x))


@pytest.mark.parametrize("device_normalize", [True, False])
def test_train_and_val_transforms_match_jax(device_normalize, jax_plain):
    for seed, (h, w) in enumerate([(37, 53), (64, 48), (20, 20)]):
        img, lbl = _pair(seed, h, w)
        for crop in (32, 17):
            _same(TT.train_transform(crop, device_normalize)(
                      img, lbl, np.random.default_rng(seed)),
                  JT.train_transform(crop, device_normalize)(
                      img, lbl, np.random.default_rng(seed)))
        for crop in (32, None):
            _same(TT.val_transform(crop, device_normalize)(img, lbl),
                  JT.val_transform(crop, device_normalize)(img, lbl))


@pytest.mark.skipif(not JN.has_native(),
                    reason="the JAX package's host-op binding is not built")
def test_geometry_matches_the_jax_binding():
    """The PIL crop + resize (+ flip) equals the JAX package's C++ binding,
    and so does the default train pipeline (device normalize)."""
    for seed in range(4):
        img, lbl = _pair(seed, 41, 67)
        for crop, flip in ((None, False), ((3, 5, 30, 40), True),
                           ((0, 0, 41, 20), False)):
            _same(TN.pil_resize_pair(img, lbl, 29, 33, crop=crop, flip=flip),
                  JN.pil_resize_pair(img, lbl, 29, 33, crop=crop, flip=flip))
        _same(TT.train_transform(32, True)(img, lbl,
                                           np.random.default_rng(seed)),
              JT.train_transform(32, True)(img, lbl,
                                           np.random.default_rng(seed)))


def test_host_ops_match_jax(jax_plain):
    img, lbl = _pair(3)
    mean, std = TT.IMAGENET_MEAN, TT.IMAGENET_STD
    np.testing.assert_array_equal(TN.normalize_image(img, mean, std),
                                  JN.normalize_image(img, mean, std))
    lut = TI.voc_remap_lut([16, 17], list(range(1, 16)))
    for lab in (lbl, lbl.astype(np.int32), lbl.astype(np.int64)):
        _same([TN.remap_labels(lab, lut)], [JN.remap_labels(lab, lut)])
    wide = lut.copy()
    wide[5] = 300
    _same([TN.remap_labels(lbl, wide)], [JN.remap_labels(lbl, wide)])
    pred = np.random.RandomState(4).randint(0, 21, lbl.shape)
    ht, hj = np.zeros((21, 21), np.int64), np.zeros((21, 21), np.int64)
    TN.confusion_update(ht, lbl, pred)
    JN.confusion_update(hj, lbl, pred)
    np.testing.assert_array_equal(ht, hj)
    assert ht.sum() == int((lbl < 21).sum())


def test_luts_and_filters_match_jax():
    for labels, old in (([16, 17, 18, 19, 20], list(range(1, 16))),
                        ([1, 2, 3], []), ([0, 5, 6], [1, 2])):
        for masking in (True, False):
            np.testing.assert_array_equal(
                TI.voc_remap_lut(labels, old, masking),
                JI.voc_remap_lut(labels, old, masking))
            for ignore_bg in (True, False):
                np.testing.assert_array_equal(
                    TI.ade_remap_lut(labels, old, masking, ignore_bg),
                    JI.ade_remap_lut(labels, old, masking, ignore_bg))
            for train in (True, False):
                np.testing.assert_array_equal(
                    TI.city_remap_lut(labels, old, train, masking),
                    JI.city_remap_lut(labels, old, train, masking))
        for dm in ("current", "current+old", "new"):
            np.testing.assert_array_equal(
                TI.voc_remap_lut(labels, old, True, dm),
                JI.voc_remap_lut(labels, old, True, dm))
    with pytest.raises(NotImplementedError):
        TI.voc_remap_lut([1], [], True, "bogus")
    rs = np.random.RandomState(0)
    masks = [rs.randint(0, 6, (8, 8)).astype(np.uint8) for _ in range(30)]
    masks[3][:] = 0
    masks[4][0, 0] = 255
    for overlap in (True, False):
        got = TI.filter_images(masks, [4, 5], [1, 2], overlap=overlap)
        assert got == JI.filter_images(masks, [4, 5], [1, 2],
                                       overlap=overlap)
        assert got == JI.filter_images([lambda m=m: m for m in masks],
                                       [4, 5], [1, 2], overlap=overlap)
    assert TI.group_images(masks, [1, 2, 3]) == JI.group_images(masks,
                                                                [1, 2, 3])
    np.testing.assert_array_equal(TI.MaskLabels([1, 3], 255)(masks[0]),
                                  JI.MaskLabels([1, 3], 255)(masks[0]))
    np.testing.assert_array_equal(TI.CITY_ID_TO_20, JI.CITY_ID_TO_20)
    np.testing.assert_array_equal(TI.CITY_ID_TO_TRAINID,
                                  JI.CITY_ID_TO_TRAINID)
    assert TI.CITY_TO_DOMAIN_ID == JI.CITY_TO_DOMAIN_ID


def test_idx_cache_round_trip(tmp_path):
    path = str(tmp_path / "cache" / "train-1.npy")
    calls = []

    def compute():
        calls.append(1)
        return [3, 1, 4]
    assert TI.load_or_compute_idxs(path, compute) == [3, 1, 4]
    assert TI.load_or_compute_idxs(path, compute) == [3, 1, 4]
    assert len(calls) == 1
    # the JAX package reads the port's cache file and vice versa
    assert JI.load_or_compute_idxs(path, compute) == [3, 1, 4]


def test_synthetic_datasets_match_jax():
    for T, J in ((TD.SyntheticSegmentation(n=5, size=16, n_classes=7, seed=3),
                  JD.SyntheticSegmentation(n=5, size=16, n_classes=7, seed=3)),
                 (TD.LearnableSynthetic(n=4, size=24, n_classes=21, seed=2),
                  JD.LearnableSynthetic(n=4, size=24, n_classes=21, seed=2))):
        assert len(T) == len(J)
        for i in range(len(T)):
            _same(T[i], J[i])
            np.testing.assert_array_equal(T.get_mask(i), J.get_mask(i))


def _datasets(M, base, transform, **kw):
    return M.make_incremental_dataset(
        "voc", "unused", train=True, transform=transform,
        labels=[16, 17, 18, 19, 20], labels_old=list(range(1, 16)),
        base=base, **kw)


@pytest.mark.parametrize("overlap", [True, False])
def test_incremental_dataset_over_synthetic_matches_jax(overlap):
    base = JD.SyntheticSegmentation(n=12, size=24, n_classes=21, seed=5)
    for i in range(0, 12, 3):
        base.labels[i][base.labels[i] > 16] = 16  # disjoint keeps these
    dt = _datasets(TD, base, TT.train_transform(16, True), overlap=overlap)
    dj = _datasets(JD, base, JT.train_transform(16, True), overlap=overlap)
    assert dt.indices == dj.indices and len(dt) > 0
    for i in range(len(dt)):
        _same(dt.get(i, np.random.default_rng(i)),
              dj.get(i, np.random.default_rng(i)))
    assert dt[0][1].dtype == np.uint8


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _voc_tree(root, rs, n=6, size=24):
    lines = []
    for i in range(n):
        img, lbl = f"JPEGImages/i{i}.png", f"SegmentationClassAug/i{i}.png"
        _save(os.path.join(root, img),
              rs.randint(0, 256, (size, size + 4, 3)).astype(np.uint8))
        lab = rs.randint(0, 16, (size, size + 4)).astype(np.uint8)
        if i % 2 == 0:
            lab[4:12, 4:12] = 16
        _save(os.path.join(root, lbl), lab)
        lines.append(f"/{img} /{lbl}")
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)
    for name, sel in (("train_aug.txt", lines), ("val.txt", lines[:4])):
        with open(os.path.join(root, "splits", name), "w") as f:
            f.write("\n".join(sel))


def _ade_tree(root, rs, n=4, size=24):
    for i in range(n):
        for split in ("training", "validation"):
            d = os.path.join(root, "ADEChallengeData2016")
            _save(os.path.join(d, "images", split, f"a{i}.jpg"),
                  rs.randint(0, 256, (size, size, 3)).astype(np.uint8))
            _save(os.path.join(d, "annotations", split, f"a{i}.png"),
                  rs.randint(0, 151, (size, size)).astype(np.uint8))


def _city_tree(root, rs, size=24):
    for split in ("train", "val"):
        for city in ("aachen", "bremen"):
            for i in range(2):
                stem = f"{city}_{i:06d}_000019"
                _save(os.path.join(root, "Cityscapes", "leftImg8bit", split,
                                   city, f"{stem}_leftImg8bit.png"),
                      rs.randint(0, 256, (size, size, 3)).astype(np.uint8))
                _save(os.path.join(root, "Cityscapes", "gtFine", split, city,
                                   f"{stem}_gtFine_labelIds.png"),
                      rs.randint(0, 34, (size, size)).astype(np.uint8))


@pytest.mark.parametrize("dataset,train", [("voc", True), ("voc", False),
                                           ("ade", True), ("city", False)])
def test_incremental_dataset_on_disk_matches_jax(tmp_path, dataset, train):
    """A small disk tree written here, through both packages' readers,
    index filters (each writing its own cache) and remaps."""
    rs = np.random.RandomState(7)
    root = str(tmp_path / "data")
    {"voc": _voc_tree, "ade": _ade_tree, "city": _city_tree}[dataset](
        root, rs)
    labels, old = {"voc": ([16, 17, 18, 19, 20], list(range(1, 16))),
                   "ade": ([101, 102, 103], list(range(1, 101))),
                   "city": ([5, 6, 7], [1, 2, 3, 4])}[dataset]
    out = []
    for name, M, T in (("t", TD, TT), ("j", JD, JT)):
        out.append(M.make_incremental_dataset(
            dataset, root, train=train,
            transform=T.train_transform(16, False),
            labels=labels, labels_old=old,
            idxs_path=str(tmp_path / name / "idx.npy"), overlap=True))
    dt, dj = out
    assert dt.indices == dj.indices and len(dt) > 0
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "idx.npy"),
                                  np.load(tmp_path / "j" / "idx.npy"))
    for i in range(len(dt)):
        np.testing.assert_array_equal(dt.dataset.get_mask(dt.indices[i]),
                                      dj.dataset.get_mask(dj.indices[i]))
        with _jax_plain_ops():
            _same(dt.get(i, np.random.default_rng(i)),
                  dj.get(i, np.random.default_rng(i)))


class _jax_plain_ops:
    """Both packages' data ops on their numpy/PIL paths within a block."""

    def __enter__(self):
        self.saved = JN._LIB, TN._LIB
        JN._LIB = TN._LIB = False

    def __exit__(self, *exc):
        JN._LIB, TN._LIB = self.saved


def test_city_domain_dataset_matches_jax(tmp_path):
    rs = np.random.RandomState(8)
    root = str(tmp_path / "cd")
    for split in ("train", "val"):
        for city in ("aachen", "bremen", "zurich"):
            stem = f"{city}_000000_000019"
            _save(os.path.join(root, "leftImg8bit", split, city,
                               f"{stem}_leftImg8bit.png"),
                  rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
            _save(os.path.join(root, "gtFine", split, city,
                               f"{stem}_gtFine_labelIds.png"),
                  rs.randint(0, 34, (16, 16)).astype(np.uint8))
    for train in (True, False):
        dt, dj = (M.make_incremental_dataset(
            "city_domain", root, train=train, transform=None,
            labels=[0, 1, 17]) for M in (TD, JD))
        assert dt.indices == dj.indices
        for i in range(len(dt)):
            _same(dt[i], dj[i])


@pytest.mark.parametrize("workers,prefetch", [(1, 0), (3, 2)])
def test_loader_epochs_match_jax(workers, prefetch):
    """Two epochs of seeded, shuffled, augmented batches: the same arrays
    in the same order as the JAX loader, for either worker count."""
    base = JD.SyntheticSegmentation(n=11, size=20, n_classes=21, seed=1)
    dt = _datasets(TD, base, TT.train_transform(16, True))
    dj = _datasets(JD, base, JT.train_transform(16, True))
    for drop_last in (True, False):
        lt = TD.DataLoader(dt, 3, seed=5, drop_last=drop_last,
                           workers=workers, prefetch=prefetch)
        lj = JD.DataLoader(dj, 3, seed=5, drop_last=drop_last, workers=1,
                           prefetch=0)
        assert len(lt) == len(lj)
        for epoch in (0, 1):
            bt, bj = list(lt.epoch(epoch)), list(lj.epoch(epoch))
            assert len(bt) == len(bj) == len(lt)
            for a, b in zip(bt, bj):
                assert a.keys() == b.keys()
                _same([a["image"], a["label"]], [b["image"], b["label"]])
        lt.close()
    # a plain (non-`get`) dataset and a per-process shard
    plain = JD.SyntheticSegmentation(n=10, size=8, seed=2)
    for pi in (0, 1):
        bt = list(TD.DataLoader(plain, 2, seed=1, process_index=pi,
                                process_count=2, prefetch=0).epoch(3))
        bj = list(JD.DataLoader(plain, 2, seed=1, process_index=pi,
                                process_count=2, prefetch=0).epoch(3))
        for a, b in zip(bt, bj):
            _same([a["image"], a["label"]], [b["image"], b["label"]])


def test_split_train_val_matches_jax():
    base = JD.SyntheticSegmentation(n=13, size=8, seed=4)
    (tt, tv), (jt, jv) = (TD.split_train_val(base, 0.2, 9),
                          JD.split_train_val(base, 0.2, 9))
    assert tt.indices == jt.indices and tv.indices == jv.indices
    assert len(tt) + len(tv) == 13
    _same(tt[2], jt[2])
    _same(tv.get(1), jv.get(1))


def test_viz_helpers_match_jax():
    rs = np.random.RandomState(6)
    lbl = rs.randint(0, 21, (12, 10)).astype(np.uint8)
    lbl[0] = 255
    pred = rs.randint(0, 21, (12, 10))
    img = rs.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    for ds in ("voc", "ade", "city", "city_domain"):
        np.testing.assert_array_equal(
            TV.Label2Color(TV.color_map(ds))(lbl),
            JV.Label2Color(JV.color_map(ds))(lbl))
        for im in (img, (img / 255.0 - 0.45).astype(np.float32)):
            np.testing.assert_array_equal(
                TV.compose_sample_png(im, lbl, pred, ds),
                JV.compose_sample_png(im, lbl, pred, ds))
    feats = rs.randn(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(TV.attention_map(feats, (12, 16)),
                                  JV.attention_map(feats, (12, 16)))
    x = rs.randn(4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(TV.Denormalize()(x), JV.Denormalize()(x))
