"""The port stands alone: ucd_torch and chip_smoke.py import nothing of JAX
and nothing of the JAX package, and the port's entry points refuse to run
on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "ucd_tpu")


def test_import_pulls_in_no_jax():
    """A fresh interpreter (this one imported jax in conftest.py) imports
    the port's modules and finds no JAX module loaded."""
    code = (
        "import sys\n"
        "import ucd_torch, ucd_torch.engine.server, ucd_torch.cli\n"
        "import ucd_torch.ops.fused_eval, ucd_torch.engine.export\n"
        "import ucd_torch.config, ucd_torch.tasks, ucd_torch.ops.losses\n"
        "import ucd_torch.ops.fused_loss, ucd_torch.engine.metrics\n"
        "import ucd_torch.engine.train, ucd_torch.engine.state\n"
        "import ucd_torch.ops.contrastive, ucd_torch.ops.tiled_contrastive\n"
        "import ucd_torch.data, ucd_torch.data.transforms\n"
        "import ucd_torch.data.native, ucd_torch.data.incremental\n"
        "import ucd_torch.data.datasets, ucd_torch.data.loader\n"
        "import ucd_torch.engine.checkpoint, ucd_torch.engine.logger\n"
        "import ucd_torch.engine.experiment, ucd_torch.models.pretrained\n"
        "import ucd_torch.utils.reporting, ucd_torch.utils.viz\n"
        "import ucd_torch.ops.assignment, ucd_torch.ops.contrastive_v1\n"
        "import ucd_torch.models.nonlocal_block\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_importing_the_kernel_modules_builds_nothing():
    """A fresh interpreter imports the kernel wrappers with an nvcc that
    must not be called and a build directory that must stay absent: kernels
    are built at first use on a CUDA tensor, never at import."""
    code = (
        "import os, subprocess, ucd_torch.ops.build as build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a kernel build started at import')\n"
        "subprocess.Popen = build.build = build.load = refuse\n"
        "existed = build.BUILD_DIR.exists()\n"
        "import ucd_torch.ops.fused_loss as FL\n"
        "import ucd_torch.ops.fused_eval as FE\n"
        "import ucd_torch.ops.contrastive\n"
        "import ucd_torch.ops.tiled_contrastive as TT\n"
        "import ucd_torch.engine.train\n"
        "assert build.BUILD_DIR.exists() == existed\n"
        "assert FL.fused_ce_kd.launches_fwd == 0\n"
        "assert FL.fused_ce_kd.launches_bwd == 0\n"
        "fn = TT.pixel_contrastive_loss_tiled\n"
        "assert (fn.launches_pass1, fn.launches_pass2, fn.launches_bwd) \\\n"
        "    == (0, 0, 0)\n"
        "assert 'fused_loss' in build.kernel_sources()\n"
        "assert TT.KERNEL in build.kernel_sources()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_train_entry_points_default_to_cuda():
    """build_train_state runs on CUDA unless the caller passes a device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    import dataclasses

    from ucd_torch import config as C
    from ucd_torch.engine.state import build_train_state
    from ucd_torch.models import make_model

    cfg = dataclasses.replace(
        C.make_config(dataset="voc", task="19-1", step=0, crop_size=32),
        backbone="resnet18")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_state(cfg, make_model(cfg),
                          torch.Generator().manual_seed(0), 10)
    state, old = build_train_state(cfg, make_model(cfg),
                                   torch.Generator().manual_seed(0), 10,
                                   device="cpu")
    assert old is None and state.step == 0


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_static_scan_names_no_jax_import():
    """Every module of the port and chip_smoke.py; of the new modules of
    the experiment slice, each must be among the scanned files."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ucd_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    rel = {os.path.relpath(p, REPO) for p in paths}
    for mod in ("data/transforms", "data/native", "data/incremental",
                "data/datasets", "data/loader", "engine/checkpoint",
                "engine/logger", "engine/experiment", "models/pretrained",
                "utils/reporting"):
        assert f"ucd_torch/{mod}.py" in rel, mod
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda(tmp_path):
    """Without a GPU, the default device is an error, never a silent CPU
    run; device='cpu' works."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    from ucd_torch import resolve_device
    from ucd_torch.engine.export import load_inference, save_inference
    from ucd_torch.engine.predictor import Predictor
    from ucd_torch.models import IncrementalSegmentationModel

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    model = IncrementalSegmentationModel((3,), backbone="resnet18",
                                         pooling_size=2)
    path = save_inference(model, str(tmp_path / "m.npz"),
                          export_dtype="float32")["path"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_inference(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model)
    loaded, _ = load_inference(path, device="cpu")
    preds = Predictor(loaded, device="cpu").predict_labels(
        np.zeros((1, 32, 32, 3), np.uint8))
    assert preds.shape == (1, 32, 32) and preds.device.type == "cpu"
