"""The port's serving path over an npz exported by the JAX package:
ucd_torch.engine.export.load_inference + Predictor against the JAX
Predictor (f32 and bf16 exports), the MicroBatcher against the JAX
batcher on the same traffic, one in-process HTTP round trip and the
`python -m ucd_torch.cli predict` entry point. All on the CPU
(device="cpu"); the export is made as tests/test_export.py makes it."""

import io
import json
import os
import subprocess
import sys
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import random_flat_variables, unflatten
from ucd_torch.engine import export as TX
from ucd_torch.engine import server as TS
from ucd_torch.engine.predictor import Predictor
from ucd_tpu import config
from ucd_tpu.engine import export as JX
from ucd_tpu.engine import server as JS
from ucd_tpu.engine.checkpoint import save_checkpoint
from ucd_tpu.engine.predictor import Predictor as JaxPredictor
from ucd_tpu.models import make_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One JAX step checkpoint (resnet50, pooling 4, seeded numpy weights)
    exported as f32 and as bf16 inference npz files."""
    d = tmp_path_factory.mktemp("torch_serve")
    cfg = config.make_config(
        dataset="voc", task="19-1", step=0, method="FT", epochs=1,
        batch_size=2, crop_size=32, backbone="resnet50", dtype="float32",
        pretrained=False, overlap=True, pooling=4)
    flat = random_flat_variables(make_model(cfg), (32, 32), seed=0)
    for i in range(len(cfg.classes_per_step)):   # trained-like O(10) logits
        flat[f"params/cls_{i}/kernel"] *= 1e-3
    tree = unflatten(flat)
    state = types.SimpleNamespace(params=tree["params"],
                                  batch_stats=tree["batch_stats"],
                                  opt_state={"none": np.zeros(())},
                                  step=np.int32(0))
    ckpt = os.path.join(d, "ckpt")
    save_checkpoint(ckpt, state, epoch=0, best_score=0.0)
    return {dt: JX.export_inference(ckpt, os.path.join(d, f"m_{dt}.npz"),
                                    cfg, export_dtype=dt)["path"]
            for dt in ("float32", "bfloat16")}


def _images(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (h, w, 3), np.uint8) for h, w in sizes]


@pytest.mark.parametrize("dtype,agree", [("float32", 0.999),
                                         ("bfloat16", 0.98)])
def test_load_inference_predicts_like_jax(exports, dtype, agree):
    jm, jv, _ = JX.load_inference(exports[dtype])
    model, meta = TX.load_inference(exports[dtype], device="cpu")
    assert meta["dtype"] == dtype and model.classes == tuple(jm.classes)
    assert model.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
    imgs = np.stack(_images(0, [(64, 64)] * 2))
    want = np.asarray(JaxPredictor(jm, jv, fused=False).predict_labels(imgs))
    assert len(np.unique(want)) > 1
    for fused in (True, False):
        got = Predictor(model, fused=fused, device="cpu").predict_labels(imgs)
        got = got.numpy()
        assert (got == want).mean() >= agree, (fused, (got != want).mean())


def _drive(batcher, phases):
    """Submit each phase's images concurrently; phases run one after the
    other, so the coalescing is the same for every batcher."""
    answers = []
    for imgs in phases:
        out = [None] * len(imgs)

        def worker(i, img):
            out[i] = batcher.submit(img)

        threads = [threading.Thread(target=worker, args=(i, img))
                   for i, img in enumerate(imgs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        answers += out
    return answers, batcher.stats()


def test_microbatcher_matches_jax_batcher(exports):
    """Same traffic through both batchers: a full bucket, a lone image of
    a new bucket (natural size), a lone image of the first bucket (padded
    back to the full batch). Same stats, same answers up to near-ties."""
    phases = [_images(1, [(32, 32), (30, 20)]), _images(2, [(20, 40)]),
              _images(3, [(17, 31)])]
    jm, jv, _ = JX.load_inference(exports["float32"])
    model, _ = TX.load_inference(exports["float32"], device="cpu")
    kw = dict(bucket=32, batch_size=2, max_wait_ms=300.0)
    jb = JS.MicroBatcher(JaxPredictor(jm, jv, fused=False), **kw)
    tb = TS.MicroBatcher(Predictor(model, device="cpu"), **kw)
    try:
        want, want_stats = _drive(jb, phases)
        got, got_stats = _drive(tb, phases)
    finally:
        jb.close()
        tb.close()
    assert got_stats == want_stats == {"batches": 3, "images": 4,
                                       "padded_rows": 1}
    for g, w, img in zip(got, want, sum(phases, [])):
        assert g.shape == w.shape == img.shape[:2] and g.dtype == np.uint8
        assert (g == w).mean() >= 0.999


def test_http_round_trip(exports):
    path = exports["float32"]
    srv = TS.make_server(path, host="127.0.0.1", port=0, batch_size=2,
                         bucket=32, max_wait_ms=20.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address[:2]
    img = _images(4, [(30, 45)])[0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")

    def post(fmt):
        req = urllib.request.Request(
            f"http://{host}:{port}/predict?format={fmt}",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    try:
        model, _ = TX.load_inference(path, device="cpu")
        arr = np.zeros((1, 32, 64, 3), np.uint8)   # the server's bucket
        arr[0, :30, :45] = img
        want = Predictor(model, device="cpu").predict_labels(arr)
        want = want.numpy()[0, :30, :45]
        status, ctype, body = post("ids")
        assert status == 200 and ctype == "image/png"
        np.testing.assert_array_equal(np.asarray(Image.open(
            io.BytesIO(body))), want)
        _, ctype, body = post("json")
        assert ctype == "application/json"
        np.testing.assert_array_equal(np.asarray(json.loads(body)["ids"]),
                                      want)
        _, ctype, body = post("color")
        from ucd_torch.utils.viz import color_map
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(body)).convert("RGB")),
            color_map("voc")[want])
        with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["model"]["format"] == "ucd_tpu.inference.v1"
        assert health["stats"]["images"] == 3
    finally:
        TS.shutdown_server(srv)


def test_cli_predict_writes_pngs(exports, tmp_path):
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for name, (h, w) in (("a.png", (40, 52)), ("b.jpg", (64, 30))):
        Image.fromarray(_images(5, [(h, w)])[0]).save(imgdir / name)
    out = tmp_path / "pred"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "ucd_torch.cli", "predict", "--device", "cpu",
         "--model", exports["bfloat16"], "--images", str(imgdir),
         "--out", str(out), "--bucket", "64", "--save_ids"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "wrote 4 files" in res.stdout
    assert Image.open(out / "a_color.png").size == (52, 40)
    ids = np.asarray(Image.open(out / "b_ids.png"))
    assert ids.shape == (64, 30) and ids.max() < 21
