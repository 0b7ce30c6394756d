#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`ucd_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero, and no result line is printed):

  1. build every CUDA kernel of the port from `ucd_torch/ops/csrc/` with
     nvcc (sm_90a), all sources at once, and print the card;
  2. hold each kernel against its plain PyTorch version on the card
     (fused upsample+argmax: the serving shape, ADE's 151 classes, a
     non-multiple shape, bf16 input, identity resolution, NaN pixels);
  3. drive the serving path at full width: ResNet-101 DeepLab-v3 (os 16,
     head 256, pooling 32) with VOC 15-5s's six heads (21 classes), seeded
     random weights with BN statistics calibrated on one seeded batch,
     written as a bf16 `ucd_tpu.inference.v1` npz and served through
     load_inference -> Predictor -> MicroBatcher -> HTTP; the kernels'
     launch counts are read over this phase alone;
  4. time each kernel beside its plain version, one library call and its
     roofline bound, and the serving throughput at batch 8, 512x512, bf16.

The last three lines of stdout are the `{"kernels": [...]}` record, the
card's name and power limit (nvidia-smi), and `{"ok": true, "device": ...}`.
`--profile DIR` also writes a torch.profiler table of predict_labels there.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ucd_torch.engine.export import (_bucket_hw, load_inference,  # noqa: E402
                                     save_inference)
from ucd_torch.engine.predictor import Predictor  # noqa: E402
from ucd_torch.engine.server import (MicroBatcher, make_server,  # noqa: E402
                                     shutdown_server)
from ucd_torch.models import IncrementalSegmentationModel  # noqa: E402
from ucd_torch.models.segmentation import resize_bilinear  # noqa: E402
from ucd_torch.ops import build  # noqa: E402
from ucd_torch.ops import fused_eval as FE  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# VOC 15-5s at its last step: the model README.md's export example serves
CLASSES = (16, 1, 1, 1, 1, 1)
BATCH, SIZE = 8, 512
SMALL = (375, 500)  # VOC's most common image size: bucket 384x512


def log(*a):
    print(*a, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=100, warmup=10) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_images(n, h, w, seed) -> np.ndarray:
    """Seeded uint8 HWC images with spatial structure (smooth color fields
    plus noise), so predictions vary across each image."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(n, 3, 6, 8, generator=g) * 255
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False)
    img = img + torch.randn(n, 3, h, w, generator=g) * 12
    return img.clamp(0, 255).round().to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().numpy()


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def check_fused_argmax(z, out_hw, gap_tol, rate_tol) -> dict:
    """Kernel vs plain on the same CUDA tensor. Mismatches are allowed only
    where the plain upsample's top-2 gap is below `gap_tol`, at a rate
    below `rate_tol`; pixels with a NaN class value must agree exactly
    (both give class 0). max_abs_err is the largest logit gap, under the
    plain upsample, between the two versions' chosen classes."""
    got = FE.fused_argmax(z, out_hw)
    want = FE.fused_argmax_plain(z, out_hw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (z.shape[0], *out_hw), got.shape
    assert got.dtype == torch.int32
    up = F.interpolate(z.permute(0, 3, 1, 2).float(), size=out_hw,
                       mode="bilinear", align_corners=False)
    nan_px = up.isnan().any(dim=1)
    assert torch.equal(got[nan_px], want[nan_px]), "NaN pixels differ"
    assert (got[nan_px] == 0).all()
    ok = ~nan_px
    mism = (got != want) & ok
    top2 = up.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    n_bad = int(mism.sum())
    if n_bad:
        worst = float(gap[mism].max())
        assert worst < gap_tol, f"{n_bad} real mismatches, gap {worst}"
    rate = n_bad / max(int(ok.sum()), 1)
    assert rate < rate_tol, rate
    v_got = up.gather(1, got.long().unsqueeze(1)).squeeze(1)
    v_want = up.gather(1, want.long().unsqueeze(1)).squeeze(1)
    err = float((v_want - v_got)[ok].abs().max()) if ok.any() else 0.0
    assert 0 <= got.min() and got.max() < z.shape[-1]
    return {"mismatch_rate": rate, "max_abs_err": err,
            "nan_pixels": int(nan_px.sum())}


def phase_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    z_nan = rnd(2, 8, 8, 21)
    z_nan[0, 1, 2, :] = float("nan")      # fully-NaN source pixel
    z_nan[1, 5, 3, 7] = float("nan")      # one NaN class value
    cases = {
        "serving (8,32,32,21) f32 -> 512": (rnd(8, 32, 32, 21), (512, 512)),
        "ADE (8,32,32,151) f32 -> 512": (rnd(8, 32, 32, 151), (512, 512)),
        "non-multiple (2,13,17,21) -> (100,132)": (rnd(2, 13, 17, 21),
                                                   (100, 132)),
        "bf16 (8,32,32,21) -> 512": (rnd(8, 32, 32, 21).bfloat16(),
                                     (512, 512)),
        "identity (2,16,16,21)": (rnd(2, 16, 16, 21), (16, 16)),
        "partial NaN (2,8,8,21) -> 96": (z_nan, (96, 96)),
        "all NaN (1,4,4,5) -> 8": (torch.full((1, 4, 4, 5), float("nan"),
                                              device=dev), (8, 8)),
    }
    worst = {"mismatch_rate": 0.0, "max_abs_err": 0.0}
    for name, (z, hw) in cases.items():
        bf16 = z.dtype == torch.bfloat16
        r = check_fused_argmax(z, hw, 0.08 if bf16 else 1e-4,
                               2e-2 if bf16 else 1e-3)
        log(f"[kernel] fused_argmax {name}: ok {json.dumps(r)}")
        worst = {k: max(worst[k], r[k]) for k in worst}
    all_nan = FE.fused_argmax(cases["all NaN (1,4,4,5) -> 8"][0], (8, 8))
    assert (all_nan == 0).all()
    # exact ties: classes 3 and 7 carry the same values at every source
    # pixel, above all others; the first occurrence must win everywhere
    z = rnd(2, 8, 8, 21)
    z[..., 3] = z[..., 7] = z.amax(dim=-1) + 1.0
    for fn in (FE.fused_argmax, FE.fused_argmax_plain):
        assert (fn(z, (64, 64)) == 3).all(), fn.__name__
    log("[kernel] fused_argmax exact ties: first occurrence wins")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the full-width serving path
# ---------------------------------------------------------------------------

def build_model(dev, tmp) -> str:
    """Seeded full-width model, BN statistics calibrated on one seeded
    batch, checked on the card against the CPU at a small size, written as
    a bf16 inference npz. Returns its path."""
    model = IncrementalSegmentationModel(
        CLASSES, backbone="resnet101", output_stride=16, head_channels=256,
        pooling_size=32, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device=dev, memory_format=torch.channels_last)
    # one no-grad train-mode pass with momentum None sets every BN's
    # running statistics to that batch's, which keeps the 33 blocks'
    # activations finite in eval mode
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = None
    cal = torch.from_numpy(make_images(BATCH, SIZE, SIZE, seed=10)).to(dev)
    model.train()
    with torch.no_grad():
        model.forward_sem(cal.permute(0, 3, 1, 2))
    for m in bns:
        m.momentum = 0.1
    model.eval()
    # a random head favours one class everywhere: center and scale each
    # class's logit over the same batch (mean 0, std 2) so the prediction
    # varies across each image, as a trained model's does
    with torch.no_grad():
        sem = model.forward_sem(cal.permute(0, 3, 1, 2))
        mu = sem.mean(dim=(0, 2, 3))
        scale = 2.0 / sem.std(dim=(0, 2, 3)).clamp_min(1e-6)
        k = 0
        for cls in model.classifiers():
            s = scale[k:k + cls.out_channels]
            cls.weight.mul_(s.view(-1, 1, 1, 1))
            cls.bias.sub_(mu[k:k + cls.out_channels]).mul_(s)
            k += cls.out_channels

    # reference on a small input: the f32 model on the card (TF32 off)
    # against the same model on the CPU
    x = torch.from_numpy(make_images(1, 64, 64, seed=11))
    with torch.no_grad():
        ref = model.cpu().forward_sem(x.permute(0, 3, 1, 2))
        got = model.to(dev).forward_sem(x.to(dev).permute(0, 3, 1, 2)).cpu()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"[serve] f32 model on the card vs CPU at 64x64: max|d| {err:.3g} "
        f"of max|ref| {scale:.3g}")
    assert torch.isfinite(ref).all() and err <= 1e-3 * scale
    meta = save_inference(model, os.path.join(tmp, "model.npz"),
                          dataset="voc", export_dtype="bfloat16")
    return meta["path"]


def direct(predictor, img, batch, bucket=128):
    """predict_labels of `img` alone, padded into its bucket, at row 0 of
    a zero batch of `batch` rows: the layout the batcher gives it."""
    h, w = img.shape[:2]
    hb, wb = _bucket_hw(h, w, bucket)
    arr = np.zeros((batch, hb, wb, 3), np.uint8)
    arr[0, :h, :w] = img
    return predictor.predict_labels(arr).cpu().numpy()[0, :h, :w]


def submit_all(batcher, imgs):
    out = [None] * len(imgs)
    errs = []

    def worker(i):
        try:
            out[i] = batcher.submit(imgs[i])
        except Exception as e:  # collected and raised below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errs:
        raise errs[0]
    assert all(o is not None for o in out), "a submit never returned"
    return out


def phase_serving(dev, npz) -> dict:
    model, meta = load_inference(npz, device=dev)
    assert model.dtype == torch.bfloat16 and meta["dtype"] == "bfloat16"
    predictor = Predictor(model, device=dev)
    imgs = make_images(BATCH, SIZE, SIZE, seed=20)

    # (a) one batch through the fused path, against the dense path
    before = FE.fused_argmax.launches
    preds = predictor.predict_labels(imgs).cpu().numpy()
    assert FE.fused_argmax.launches == before + 1
    assert preds.shape == (BATCH, SIZE, SIZE) and preds.dtype == np.uint8
    dense = Predictor(model, fused=False, device=dev).predict_labels(
        imgs).cpu().numpy()
    with torch.inference_mode():
        x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2)
        sem = model.forward_sem(x)
        up = resize_bilinear(sem, (SIZE, SIZE))
    assert sem.shape == (BATCH, sum(CLASSES), SIZE // 16, SIZE // 16)
    assert sem.dtype == torch.float32 and bool(torch.isfinite(sem).all())
    mism = torch.from_numpy(preds != dense).to(dev)
    top2 = up.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    n_bad = int(mism.sum())
    assert n_bad == 0 or float(gap[mism].max()) < 1e-4, "fused != dense"
    assert n_bad / mism.numel() < 1e-3
    classes = np.unique(preds)
    assert len(classes) > 1, classes
    log(f"[serve] predict_labels ({BATCH},{SIZE},{SIZE}) bf16: "
        f"{len(classes)} classes "
        f"predicted, fused vs dense mismatches {n_bad} (near-ties only), "
        f"sem max|.| {float(sem.abs().max()):.3g}")

    # (b) concurrent mixed-size traffic through the MicroBatcher, after one
    # full batch of each bucket so every chunk runs at batch 8
    mb = MicroBatcher(predictor, bucket=128, batch_size=BATCH,
                      max_wait_ms=50.0)
    try:
        mb.max_wait = 5.0  # a slow thread start must not split the batch
        submit_all(mb, list(make_images(BATCH, SIZE, SIZE, seed=21)))
        submit_all(mb, list(make_images(BATCH, *SMALL, seed=22)))
        assert mb.stats()["batches"] == 2, mb.stats()
        mb.max_wait = 0.05
        traffic = list(make_images(6, SIZE, SIZE, seed=23)) + \
            list(make_images(6, *SMALL, seed=24))
        order = np.random.RandomState(25).permutation(len(traffic))
        traffic = [traffic[i] for i in order]
        answers = submit_all(mb, traffic)
        stats = mb.stats()
    finally:
        mb.close()
    for img, ans in zip(traffic, answers):
        assert ans.shape == img.shape[:2] and ans.dtype == np.uint8
        want = direct(predictor, img, BATCH)
        assert np.array_equal(ans, want), (
            f"batcher answer differs from direct prediction on "
            f"{int((ans != want).sum())} px")
    log(f"[serve] MicroBatcher: 12 concurrent mixed-size requests equal "
        f"direct prediction; stats {json.dumps(stats)}")

    # (c) HTTP round trip
    srv = make_server(npz, host="127.0.0.1", port=0, batch_size=BATCH,
                      bucket=128, max_wait_ms=5.0, device=dev)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        from PIL import Image

        host, port = srv.server_address[:2]
        img = make_images(1, *SMALL, seed=26)[0]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        want = direct(predictor, img, 1)
        bodies = {}
        for fmt in ("ids", "color", "json"):
            req = urllib.request.Request(
                f"http://{host}:{port}/predict?format={fmt}",
                data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                bodies[fmt] = r.read()
        ids = np.asarray(Image.open(io.BytesIO(bodies["ids"])))
        assert np.array_equal(ids, want), "HTTP ids differ from direct"
        assert np.array_equal(np.asarray(json.loads(bodies["json"])["ids"]),
                              want)
        color = np.asarray(Image.open(io.BytesIO(bodies["color"])))
        assert np.array_equal(color, want)  # palette indices are the ids
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["stats"]["images"] == 3
    finally:
        shutdown_server(srv)
    log("[serve] HTTP: ids, color and json answers equal direct "
        "prediction; /healthz ok")
    return {"model": model, "predictor": predictor, "imgs": imgs}


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------

def time_fused_argmax(dev, where) -> dict:
    B, h, w, C, H, W = BATCH, SIZE // 16, SIZE // 16, sum(CLASSES), SIZE, SIZE
    z = torch.randn(B, h, w, C, generator=torch.Generator().manual_seed(2)
                    ).to(dev)
    kernel_ms = cuda_ms(lambda: FE.fused_argmax(z, (H, W)), iters=200)
    plain_ms = cuda_ms(lambda: FE.fused_argmax_plain(z, (H, W)), iters=50)
    library_ms = cuda_ms(lambda: F.interpolate(
        z.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
        align_corners=False).argmax(dim=1), iters=50)
    # least work: read the logits once, write the int32 ids once; per
    # output (pixel, class) a height lerp of width-lerped rows (3 flops)
    # and one compare, plus the width lerp of the h source rows (3 flops)
    n_bytes = B * h * w * C * 4 + B * H * W * 4
    n_ops = B * H * W * C * 4 + B * h * W * C * 3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    r = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log(f"[time] fused_argmax (8,32,32,21) f32 -> 512x512 on {where}: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(F.interpolate + argmax) {library_ms:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {n_bytes} B, "
        f"{n_ops} flop)")
    return r


def time_serving(dev, served, where, profile_dir) -> dict:
    predictor, imgs = served["predictor"], served["imgs"]
    model = served["model"]
    for _ in range(3):
        predictor.predict_labels(imgs).cpu()
    n = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        predictor.predict_labels(imgs).cpu()
    sync_s = (time.perf_counter() - t0) / n
    # device-side split of one batch: forward to the low-res logits, then
    # the fused kernel
    x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2)
    with torch.inference_mode():
        sem = model.forward_sem(x)
        fwd_ms = cuda_ms(lambda: model.forward_sem(x), iters=10, warmup=2)
        z = sem.permute(0, 2, 3, 1).contiguous()
        arg_ms = cuda_ms(lambda: FE.fused_argmax(z, (SIZE, SIZE)), iters=50)
    r = {"img_per_s": BATCH / sync_s, "batch_ms": sync_s * 1e3,
         "forward_sem_ms": fwd_ms, "fused_argmax_ms": arg_ms,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[time] predict_labels batch 8, 512x512, bf16 on {where}: "
        f"{r['img_per_s']:.2f} img/s ({r['batch_ms']:.2f} ms per batch incl. "
        f"upload and fetch); device: forward_sem {fwd_ms:.2f} ms, "
        f"fused_argmax {arg_ms:.4f} ms; peak memory {r['peak_mem_gb']:.2f} GB")
    if profile_dir:
        profile(predictor, imgs, profile_dir)
    return r


def profile(predictor, imgs, out_dir):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    os.makedirs(out_dir, exist_ok=True)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            predictor.predict_labels(imgs).cpu()
    avg = prof.key_averages()
    try:
        table = avg.table(sort_by="device_time_total", row_limit=40)
    except (KeyError, AttributeError, RuntimeError):
        table = avg.table(sort_by="cuda_time_total", row_limit=40)
    path = os.path.join(out_dir, "predict_labels_profile.txt")
    with open(path, "w") as f:
        f.write(table)
    log(f"[profile] 5 x predict_labels -> {path}")
    log("\n".join(table.splitlines()[:20]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also write a torch.profiler table of "
                         "predict_labels into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1: build
    t0 = time.time()
    build.build(build.kernel_sources())
    where = card()
    log(f"[build] {build.kernel_sources()} built in {time.time() - t0:.1f} s "
        f"for {where}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(build.library_path(FE.KERNEL).with_suffix(".log").read_text().strip())

    # phase 2: every kernel against its plain version
    err = phase_kernels(dev)

    # phase 3: the main path, with every launch count read over it alone
    with tempfile.TemporaryDirectory() as tmp:
        npz = build_model(dev, tmp)
        FE.fused_argmax.launches = 0
        served = phase_serving(dev, npz)
        launches = FE.fused_argmax.launches
    assert launches > 0, "the serving path never launched fused_argmax"
    log(f"[serve] fused_argmax launches on the serving path: {launches}")

    # phase 4: timings
    timing = time_fused_argmax(dev, where)
    serving = time_serving(dev, served, where, args.profile)
    log(json.dumps({"serving": {"card": where, **serving}}))

    log(json.dumps({"kernels": [{
        "name": "fused_argmax", "route": "cuda",
        "source": "ucd_torch/ops/csrc/fused_argmax.cu",
        "replaces": "ucd_tpu/ops/fused_eval.py:76",
        "replaces_fn": "ucd_tpu/ops/fused_eval.py::_argmax_kernel",
        "launches": launches, "max_abs_err": err["max_abs_err"],
        "mismatch_rate": err["mismatch_rate"],
        "ms": timing["ms"], "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]}))
    log(where)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
