"""The port's C++ host ops (ucd_torch/data/native.py over
ucd_torch/data/csrc/data_ops.cc) against the JAX package's binding of
native/data_ops.cc, bit for bit, and against the port's own numpy/PIL
paths; the build at first use (never at import, concurrent builds, a
failing compiler, no compiler)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ucd_torch.data.native as TN
import ucd_torch.data.transforms as TT
import ucd_tpu.data.native as JN
import ucd_tpu.data.transforms as JT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_both = pytest.mark.skipif(
    TN.compiler() is None or not JN.has_native(),
    reason="needs a C++ compiler and the JAX package's built binding")

# (h, w) sources: VOC-like, odd, tiny, tall
SHAPES = [(75, 50), (37, 53), (1, 7), (64, 17)]


def _pair(seed, h, w, n_classes=21):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    lbl = rs.randint(0, n_classes, (h, w)).astype(np.uint8)
    lbl[: max(1, h // 8), : max(1, w // 8)] = 255
    return img, lbl


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


class _plain:
    """The port's ops on their numpy/PIL paths within a block."""

    def __enter__(self):
        self.saved, TN._LIB = TN._LIB, False

    def __exit__(self, *exc):
        TN._LIB = self.saved


@needs_both
@pytest.mark.parametrize("h,w", SHAPES)
def test_resize_pair_matches_the_jax_binding_and_pil(h, w):
    """Crops (whole, inner, edge strips), upscales and downscales, flips:
    the port's build equals the JAX build and Pillow, bit for bit."""
    assert TN.has_native()
    for seed in range(3):
        img, lbl = _pair(seed, h, w)
        rs = np.random.RandomState(100 + seed)
        crops = [None, (0, 0, h, 1), (h - 1, 0, 1, w)]
        for _ in range(3):
            ch, cw = rs.randint(1, h + 1), rs.randint(1, w + 1)
            crops.append((rs.randint(0, h - ch + 1), rs.randint(0, w - cw + 1),
                          ch, cw))
        for crop in crops:
            for oh, ow in ((32, 32), (3, 5), (2 * h + 1, w // 2 + 1)):
                for flip in (False, True):
                    got = TN.pil_resize_pair(img, lbl, oh, ow, crop, flip)
                    _same(got, JN.pil_resize_pair(img, lbl, oh, ow, crop,
                                                  flip))
                    with _plain():
                        _same(got, TN.pil_resize_pair(img, lbl, oh, ow, crop,
                                                      flip))


@needs_both
@pytest.mark.parametrize("h,w", SHAPES + [(512, 512)])
def test_normalize_matches_the_jax_binding(h, w):
    """The normalize equals the JAX build bit for bit (one FMA a value);
    the numpy formula rounds differently, by less than 1e-6."""
    img, _ = _pair(h * w, h, w)
    mean, std = TT.IMAGENET_MEAN, TT.IMAGENET_STD
    got = TN.normalize_image(img, mean, std)
    _same([got], [JN.normalize_image(img, mean, std)])
    with _plain():
        ref = TN.normalize_image(img, mean, std)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # channel counts other than 3 (the C loop takes up to 8)
    for c in (1, 4, 8):
        x = np.random.RandomState(c).randint(0, 256, (h, w, c)).astype(
            np.uint8)
        m, s = np.linspace(0.1, 0.9, c), np.linspace(0.2, 0.3, c)
        _same([TN.normalize_image(x, m, s)], [JN.normalize_image(x, m, s)])


@needs_both
@pytest.mark.parametrize("kind", ["u8_to_u8", "u8_to_i32", "i32", "i64"])
def test_remap_matches_the_jax_binding(kind):
    """LUT remap through every dispatch rule; a u8 -> u8 LUT stays a numpy
    gather and keeps uint8."""
    _, lbl = _pair(5, 41, 29)
    lut = np.arange(256, dtype=np.int32)[::-1].copy()
    lut[255] = 255
    if kind == "u8_to_i32":
        lut[7] = 300
    lab = {"i32": lbl.astype(np.int32), "i64": lbl.astype(np.int64)}.get(
        kind, lbl)
    if kind == "i32":
        lab[0, :3] = (-1, 256, 1000)
    got = TN.remap_labels(lab, lut)
    _same([got], [JN.remap_labels(lab, lut)])
    with _plain():
        _same([got], [TN.remap_labels(lab, lut)])
    assert got.dtype == (np.uint8 if kind == "u8_to_u8" else np.int32)


@needs_both
def test_confusion_matches_the_jax_binding():
    rs = np.random.RandomState(9)
    lbl = rs.randint(0, 21, (3, 40, 30))
    lbl[:, :4] = 255
    pred = rs.randint(0, 21, lbl.shape)
    got = TN.confusion_update(np.zeros((21, 21), np.int64), lbl, pred)
    _same([got], [JN.confusion_update(np.zeros((21, 21), np.int64), lbl,
                                      pred)])
    with _plain():
        _same([got], [TN.confusion_update(np.zeros((21, 21), np.int64), lbl,
                                          pred)])
    assert got.sum() == (lbl < 21).sum()


@needs_both
@pytest.mark.parametrize("device_normalize", [False, True])
def test_transforms_match_jax_with_both_bindings(device_normalize):
    """One RNG stream through the train and val pipelines of both packages
    with both builds in use: the same bits."""
    assert TN.has_native() and JN.has_native()
    for seed, (h, w) in enumerate([(375, 500), (37, 53), (64, 48)]):
        img, lbl = _pair(seed, h, w)
        for crop in (64, 17):
            _same(TT.train_transform(crop, device_normalize)(
                      img, lbl, np.random.default_rng(seed)),
                  JT.train_transform(crop, device_normalize)(
                      img, lbl, np.random.default_rng(seed)))
        for crop in (64, None):
            _same(TT.val_transform(crop, device_normalize)(img, lbl),
                  JT.val_transform(crop, device_normalize)(img, lbl))


def _run(code, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_import_builds_nothing():
    """A fresh interpreter imports the data package and the port with a
    compiler that must not be called: the library is built at first use."""
    proc = _run("""
        import subprocess
        def refuse(*a, **k):
            raise AssertionError('a build started at import')
        subprocess.run = subprocess.Popen = refuse
        import ucd_torch, ucd_torch.data, ucd_torch.data.native as N
        import ucd_torch.engine.experiment, ucd_torch.cli
        assert N._LIB is None
        print('ok')
        """)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0 and out.strip() == "ok", err


def test_the_port_reads_nothing_under_native():
    """The port builds its own copy of the source: no module names the JAX
    package's native/ directory or its library."""
    pkg = os.path.join(REPO, "ucd_torch")
    paths = [os.path.join(root, f) for root, _, files in os.walk(pkg)
             for f in files if f.endswith((".py", ".cc", ".cu", ".cuh"))]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert os.path.join(pkg, "data", "csrc", "data_ops.cc") in paths
    for path in paths:
        text = open(path).read()
        for needle in ("native/", '"native"', "'native'", "ucd_tpu/lib",
                       "UCD_TPU_NATIVE_LIB"):
            assert needle not in text, (path, needle)
    assert TN.SOURCE.is_relative_to(pkg)
    assert TN.library_path().parent == TN.BUILD_DIR


@pytest.mark.skipif(TN.compiler() is None, reason="no C++ compiler")
def test_concurrent_builds_both_load(tmp_path):
    """Two processes build into one empty directory at once; both load a
    whole library and compute the same normalize."""
    code = """
        import sys, pathlib, numpy as np
        import ucd_torch.data.native as N
        N.BUILD_DIR = pathlib.Path(sys.argv[1])
        assert N.has_native()
        x = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
        y = N.normalize_image(x, np.full(3, 0.5), np.full(3, 0.25))
        print(y.view(np.uint32).sum())
        """
    procs = [_run(code, tmp_path) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    built = sorted(f.name for f in tmp_path.iterdir())
    assert built == [TN.library_path().name], built


@pytest.mark.skipif(TN.compiler() is None, reason="no C++ compiler")
def test_failing_compiler_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output,
    every time it is asked; nothing falls back to numpy quietly."""
    bad = tmp_path / "data_ops.cc"
    bad.write_text('extern "C" void f() { this is not C++; }\n')
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_LIB", None)
    img = np.zeros((2, 2, 3), np.uint8)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="host ops .* failed"):
            TN.normalize_image(img, np.zeros(3), np.ones(3))
    assert TN._LIB is None
    assert list((tmp_path / "build").iterdir()) == []


def test_no_compiler_keeps_the_numpy_paths(tmp_path, monkeypatch):
    """Without a compiler has_native() is False and every op takes its
    numpy/PIL path (the JAX package's rule for an unbuilt library)."""
    monkeypatch.setenv("CXX", "no-such-compiler-ucd")
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TN, "_LIB", None)
    assert TN.compiler() is None and not TN.has_native()
    img, lbl = _pair(1, 20, 30)
    x = TN.normalize_image(img, TT.IMAGENET_MEAN, TT.IMAGENET_STD)
    ref = (img.astype(np.float32) / 255.0 - TT.IMAGENET_MEAN) \
        / TT.IMAGENET_STD
    _same([x], [ref])
    io, lo = TN.pil_resize_pair(img, lbl, 10, 12, flip=True)
    assert io.shape == (10, 12, 3) and lo.shape == (10, 12)
    assert list(tmp_path.iterdir()) == []
