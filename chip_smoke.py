#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`ucd_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero, and no result line is printed):

  1. build every CUDA kernel of the port from `ucd_torch/ops/csrc/` with
     nvcc (sm_90a), all sources at once, and print the card;
  2. hold each kernel against its plain PyTorch version on the card:
     fused upsample+argmax (the serving shape, ADE's 151 classes, a
     non-multiple shape, bf16 input, identity resolution, and the JAX
     kernel's NaN / ±inf rule: NaN in a source pixel, in one class value,
     at a row edge, in bf16, all NaN; ±inf at the clamped edges, +inf and
     -inf in one row, two +inf classes, in bf16 and at 151 classes, all
     -inf) and the fused upsample+CE/KD forward and
     backward kernels (the six-mode matrix at the train shape, ADE's class
     counts, a non-multiple shape, identity resolution, alpha 2, all-ignore
     labels, uint8 vs int32 labels, bit-reproducible backward) and the
     three tiled contrastive kernels (pass 1, pass 2, backward and the
     composed loss at the train shape, ADE's 151 probabilities, non-aligned
     P = 50 / C = 7, a feature width beyond one backward slice, a compacted
     batch and no GT-new pixel, each in f32 mode (FMA kernels) and in bf16
     mode (all three on the tensor cores, over zero-padded 2-byte
     operands); pass 1 twice with the same bits, no valid anchor,
     bit-reproducible backward, and the tiled loss against the dense one);
  3. drive the two main paths at full width (ResNet-101 DeepLab-v3, os 16,
     head 256, pooling 32; seeded random weights with BN statistics
     calibrated on one seeded batch), each with the kernels' launch counts
     set to 0 just before and read just after:
     a. serving: VOC 15-5s's six heads (21 classes) written as a bf16
        `ucd_tpu.inference.v1` npz and served through load_inference ->
        Predictor -> MicroBatcher -> HTTP;
     b. training: VOC 15-5s step 1 with the UCD preset (unbiased CE +
        unbiased KD x10 + the pixel-contrastive term x0.01 through the
        tiled kernels, imprinted new classifier, cls_0 frozen), bf16
        compute with f32 masters, batch 8 of 512x512 uint8 images:
        build_train_state -> make_train_step for 12 steps (after the
        first, every BN's running statistics are held against the batch
        mean and biased variance recomputed in plain f32), then
        make_eval_step over two batches to a confusion matrix and mIoU,
        and once more with the running statistics reset to one batch's,
        where it must agree with the train-mode forward;
        plus one f32 ResNet-50 step at 64x64 on the card against the same
        step on the CPU;
     c. the experiment around the step, through the port's CLI in this
        process: `run-task` of VOC 15-5 under UCD (ResNet-101, batch 8,
        512x512, bf16; two incremental steps of one epoch on 16 synthetic
        images each, with validate, checkpoint and final test; step 1
        restores its donor from step 0's checkpoint), `export` of the
        step-1 checkpoint at f32 (its tensors bit for bit) and bf16, and
        `predict --save_ids` with the bf16 npz on four val images (the id
        maps equal `predict_labels`); every kernel launches in the phase,
        B3-B5 only in step 1 and only on the tensor cores, B6 in validate,
        final test and predict;
  4. time each kernel three ways (its own device time from a
     torch.profiler window, CUDA events around the wrapper calls, the
     host's enqueue time a call) beside its plain version, one library
     call (where one exists) and its roofline bound, the serving throughput
     and the
     train-step throughput under UCD and under MiB at batch 8 (UCD also at
     16), 512x512, bf16; then the experiment loop in steady state (three
     epochs of 8 UCD iterations through `Experiment.train_epoch`), the
     train loader alone at 1, 4 and 8 threads, and a checkpoint write,
     sync and async.

After phase 4 come `{"serving": ...}`, `{"training": ...}` and
`{"experiment": ...}` (phase 3c's seconds per step, epoch img/s, loader and
checkpoint times, launches and peak memory, beside phase 4's raw UCD step
img/s). The last three lines of stdout are the `{"kernels": [...]}` record
(each row's `ms` / `kernel_ms` the device time, `wrapper_ms` the events',
`launches_experiment` its launches in phase 3c), the
card's name and power limit (nvidia-smi), and `{"ok": true, "device": ...}`.
`--profile DIR` also writes torch.profiler tables of predict_labels and of
the train step there. `--only kernels` stops after phase 2 and prints no
result (for bringing a kernel up).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
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

from ucd_torch import config as C  # noqa: E402
from ucd_torch.engine.export import (_bucket_hw, load_inference,  # noqa: E402
                                     save_inference)
from ucd_torch.engine.metrics import (empty_confusion,  # noqa: E402
                                      results_from_confusion)
from ucd_torch.engine.predictor import Predictor  # noqa: E402
from ucd_torch.engine.server import (MicroBatcher, make_server,  # noqa: E402
                                     shutdown_server)
from ucd_torch.engine.state import build_train_state  # noqa: E402
from ucd_torch.engine.train import (compute_train_losses,  # noqa: E402
                                    make_eval_step, make_train_step)
from ucd_torch.models import (IncrementalSegmentationModel,  # noqa: E402
                              make_model)
from ucd_torch.models.segmentation import resize_bilinear  # noqa: E402
from ucd_torch.ops import build  # noqa: E402
from ucd_torch.ops import contrastive as CT  # noqa: E402
from ucd_torch.ops import fused_eval as FE  # noqa: E402
from ucd_torch.ops import fused_loss as FL  # noqa: E402
from ucd_torch.ops import tiled_contrastive as TT  # noqa: E402

# the kernel timers (device time from the profiler, host enqueue time),
# shared with the script that times two checkouts in turns
_spec = importlib.util.spec_from_file_location(
    "bench_fused_kernels", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts", "bench_fused_kernels.py"))
BFK = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(BFK)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 in the tensor cores
# exp2 / log2 / reciprocal in the special function units: 16 a clock per
# SM (CUDA C programming guide, arithmetic instructions, compute
# capability 9.0) x 132 SMs x 1.98 GHz (the boost clock behind 67e12)
SFU_OP_PER_S = 16 * 132 * 1.98e9
# VOC 15-5s at its last step: the model README.md's export example serves
CLASSES = (16, 1, 1, 1, 1, 1)
BATCH, SIZE = 8, 512
SMALL = (375, 500)  # VOC's most common image size: bucket 384x512
# the train path: VOC 15-5s step 1 under the UCD preset (MiB + the
# pixel-contrastive term)
TRAIN = dict(dataset="voc", task="15-5s", step=1, method="UCD",
             backbone="resnet101", batch_size=BATCH, crop_size=SIZE,
             lr=0.001)
TRAIN_STEPS_FRESH, TRAIN_STEPS_REPEAT = 4, 8
MODES = [("ce", "none"), ("ce", "kd"), ("ce", "unkd"),
         ("unce", "none"), ("unce", "kd"), ("unce", "unkd")]


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


def make_labels(n, h, w, n_classes, seed) -> np.ndarray:
    """Seeded uint8 (n, h, w) labels with spatial structure: a coarse grid
    of class ids upsampled to blocks, plus a 255 (ignore) frame and an
    ignore rectangle."""
    g = torch.Generator().manual_seed(seed)
    low = torch.randint(0, n_classes, (n, 1, 7, 9), generator=g).float()
    lab = F.interpolate(low, size=(h, w), mode="nearest")[:, 0]
    lab = lab.to(torch.uint8)
    e = max(1, h // 64)
    lab[:, :e] = lab[:, -e:] = 255
    lab[:, :, :e] = lab[:, :, -e:] = 255
    lab[:, h // 3:h // 3 + h // 8, w // 4:w // 4 + w // 6] = 255
    return lab.contiguous().numpy()


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def check_fused_argmax(z, out_hw, gap_tol, rate_tol) -> dict:
    """Kernel vs plain on the same CUDA tensor. Mismatches are allowed only
    where the plain upsample's top-2 gap is below `gap_tol`, at a rate
    below `rate_tol`; the pixels of the JAX kernel's non-finite rule (a
    NaN or ±inf class value in its upsampled logits, `jax_pattern`) must
    agree exactly. max_abs_err is the largest logit gap, under the plain
    upsample, between the two versions' chosen classes."""
    got = FE.fused_argmax(z, out_hw)
    want = FE.fused_argmax_plain(z, out_hw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (z.shape[0], *out_hw), got.shape
    assert got.dtype == torch.int32
    up = F.interpolate(z.permute(0, 3, 1, 2).float(), size=out_hw,
                       mode="bilinear", align_corners=False)
    pattern = FE.jax_pattern(z, out_hw)
    special = ~torch.isfinite(pattern).all(dim=-1)
    assert torch.equal(got[special], want[special]), "non-finite pixels differ"
    ok = ~special
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
            "nonfinite_pixels": int(special.sum()),
            "posinf_wins": int((torch.isposinf(pattern).any(-1)
                                & ~torch.isnan(pattern).any(-1)).sum())}


def phase_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    z_nan = rnd(2, 8, 8, 21)
    z_nan[0, 1, 2, :] = float("nan")      # fully-NaN source pixel
    z_nan[1, 5, 3, 7] = float("nan")      # one NaN class value
    z_edge = rnd(2, 32, 32, 21)
    z_edge[1, 0, 31, 4] = float("nan")    # first row, last column
    z_edge[0, 31, 0, 9] = float("nan")    # last row, first column
    inf = float("inf")
    z_inf = rnd(2, 32, 32, 21)
    z_inf[1, 0, 0, 4] = inf               # clamped edges: duplicated slots
    z_inf[0, 0, 31, 9] = -inf             # of weight 0
    z_inf[0, 31, 31, 2] = inf
    z_inf[1, 10, 5, 3] = inf              # +inf and -inf in one row: NaN
    z_inf[1, 10, 20, 3] = -inf
    z_inf[0, 12, 7, 5] = z_inf[0, 12, 7, 2] = inf  # two +inf: the first
    cases = {
        "serving (8,32,32,21) f32 -> 512": (rnd(8, 32, 32, 21), (512, 512)),
        "ADE (8,32,32,151) f32 -> 512": (rnd(8, 32, 32, 151), (512, 512)),
        "non-multiple (2,13,17,21) -> (100,132)": (rnd(2, 13, 17, 21),
                                                   (100, 132)),
        "bf16 (8,32,32,21) -> 512": (rnd(8, 32, 32, 21).bfloat16(),
                                     (512, 512)),
        "identity (2,16,16,21)": (rnd(2, 16, 16, 21), (16, 16)),
        "partial NaN (2,8,8,21) -> 96": (z_nan, (96, 96)),
        "NaN at row edges (2,32,32,21) -> 512": (z_edge, (512, 512)),
        "NaN at row edges bf16 (2,32,32,21) -> 512": (z_edge.bfloat16(),
                                                      (512, 512)),
        "all NaN (1,4,4,5) -> 8": (torch.full((1, 4, 4, 5), float("nan"),
                                              device=dev), (8, 8)),
        "±inf (2,32,32,21) -> 512": (z_inf, (512, 512)),
        "±inf bf16 (2,32,32,21) -> 512": (z_inf.bfloat16(), (512, 512)),
        "±inf ADE (2,32,32,151) -> 512": (
            torch.cat([z_inf, rnd(2, 32, 32, 130)], dim=-1), (512, 512)),
        "all -inf (1,4,4,5) -> 8": (torch.full((1, 4, 4, 5), -inf,
                                               device=dev), (8, 8)),
    }
    worst = {"mismatch_rate": 0.0, "max_abs_err": 0.0}
    for name, (z, hw) in cases.items():
        bf16 = z.dtype == torch.bfloat16
        r = check_fused_argmax(z.contiguous(), hw, 0.08 if bf16 else 1e-4,
                               2e-2 if bf16 else 1e-3)
        log(f"[kernel] fused_argmax {name}: ok {json.dumps(r)}")
        worst = {k: max(worst[k], r[k]) for k in worst}
        if "row edges" in name or "±inf" in name:
            # whole rows of tiles, far more than the values' own taps
            assert 0 < r["nonfinite_pixels"] < z.shape[0] * hw[0] * hw[1], r
        if "±inf" in name:
            assert r["posinf_wins"] > 0, r
    for name in ("all NaN (1,4,4,5) -> 8", "all -inf (1,4,4,5) -> 8"):
        assert (FE.fused_argmax(cases[name][0], (8, 8)) == 0).all(), name
    # exact ties: classes 3 and 7 carry the same values at every source
    # pixel, above all others; the first occurrence must win everywhere
    z = rnd(2, 8, 8, 21)
    z[..., 3] = z[..., 7] = z.amax(dim=-1) + 1.0
    for fn in (FE.fused_argmax, FE.fused_argmax_plain):
        assert (fn(z, (64, 64)) == 3).all(), fn.__name__
    log("[kernel] fused_argmax exact ties: first occurrence wins")
    return worst


LOSS_RTOL, LOSS_ATOL, GRAD_TOL = 1e-5, 1e-6, 2e-4


def fused_loss_and_grad(z, lab, t, ct_kd=2.5, **kw):
    """(loss_ce, loss_kd, d(ce + ct_kd*kd)/dz) through the kernels."""
    zz = z.detach().requires_grad_(True)
    lc, lk = FL.fused_ce_kd(zz, lab, t, **kw)
    (g,) = torch.autograd.grad(lc + ct_kd * lk, zz)
    return lc.detach(), lk.detach(), g


def check_fused_loss(z, lab, t, **kw) -> dict:
    """Kernels vs plain on the same CUDA tensors: both losses within
    rtol 1e-5 / atol 1e-6, and the gradient of ce + 2.5*kd (distinct
    weights, so that cross-wired cotangents cannot cancel) within 2e-4 of
    its largest entry: the JAX package's own tolerances for its kernels."""
    lc, lk, g = fused_loss_and_grad(z, lab, t, **kw)
    pc, pk = FL.fused_ce_kd_plain(z, lab, t, **kw)
    pg = FL.fused_ce_kd_grad_plain(z, lab, t, ct_kd=2.5, **kw)
    torch.cuda.synchronize()
    assert lc.dtype == lk.dtype == torch.float32 and g.shape == z.shape
    loss_err = 0.0
    for got, want, name in ((lc, pc, "ce"), (lk, pk, "kd")):
        err = abs(float(got) - float(want))
        assert err <= LOSS_ATOL + LOSS_RTOL * abs(float(want)), (
            f"{name} loss: kernel {float(got)!r} vs plain {float(want)!r}")
        loss_err = max(loss_err, err)
    scale = float(pg.abs().max()) + 1e-12
    grad_err = float((g - pg).abs().max())
    assert torch.isfinite(g).all()
    assert grad_err <= GRAD_TOL * scale, (
        f"gradient: max|d| {grad_err:.3g} vs max|g| {scale:.3g}")
    return {"loss_err": loss_err, "grad_err": grad_err,
            "grad_rel_err": grad_err / scale,
            "ce": float(lc), "kd": float(lk)}


def phase_loss_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(3)

    def case(B, h, w, C, Co, H, W):
        z = torch.randn(B, h, w, C, generator=g).to(dev)
        t = torch.randn(B, h, w, Co, generator=g).to(dev)
        lab = torch.from_numpy(make_labels(B, H, W, C, seed=B + C + H)
                               ).to(dev)
        return z, lab, t

    worst = {"loss_err": 0.0, "grad_err": 0.0, "grad_rel_err": 0.0}

    def run(name, z, lab, t, **kw):
        r = check_fused_loss(z, lab, t, **kw)
        log(f"[kernel] fused_loss {name}: ok {json.dumps(r)}")
        for k in worst:
            worst[k] = max(worst[k], r[k])

    z, lab, t = case(BATCH, SIZE // 16, SIZE // 16, 17, 16, SIZE, SIZE)
    assert int((lab == 255).sum()) > 0
    for ce_mode, kd_mode in MODES:
        run(f"train shape (8,32,32,17/16) -> 512 {ce_mode}+{kd_mode}", z,
            lab, t, old_cl=16 if ce_mode == "unce" else 0, ce_mode=ce_mode,
            kd_mode=kd_mode)
    mib = dict(ce_mode="unce", kd_mode="unkd")
    # uint8, int32 and int64 labels give the same bits
    ref = fused_loss_and_grad(z, lab, t, old_cl=16, **mib)
    for dt in (torch.int32, torch.int64):
        got = fused_loss_and_grad(z, lab.to(dt), t, old_cl=16, **mib)
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), dt
    # the backward is bit-reproducible
    again = fused_loss_and_grad(z, lab, t, old_cl=16, **mib)
    assert all(torch.equal(a, b) for a, b in zip(ref, again))
    log("[kernel] fused_loss uint8 / int32 / int64 labels: same bits; "
        "backward run twice: same bits")
    run("alpha=2 (8,32,32,17/16) -> 512", z, lab, t, old_cl=16, alpha=2.0,
        **mib)
    za, laba, ta = case(2, SIZE // 16, SIZE // 16, 151, 101, SIZE, SIZE)
    run("ADE (2,32,32,151/101) -> 512", za, laba, ta, old_cl=101, **mib)
    zn, labn, tn = case(2, 13, 17, 11, 6, 100, 132)
    run("non-multiple (2,13,17,11/6) -> (100,132)", zn, labn, tn, old_cl=6,
        **mib)
    zi, labi, ti = case(2, 16, 16, 11, 6, 16, 16)
    run("identity (2,16,16,11/6)", zi, labi, ti, old_cl=6, **mib)
    # all-ignore labels: the CE term is exactly 0, and so is its gradient
    lab255 = torch.full_like(lab, 255)
    lc, _, g0 = fused_loss_and_grad(z, lab255, None, old_cl=16,
                                    ce_mode="unce", kd_mode="none")
    assert float(lc) == 0.0 and not g0.any(), float(lc)
    log("[kernel] fused_loss all-255 labels: CE exactly 0")
    # a float32-only, upsample-only contract: anything else raises
    for bad in (lambda: FL.fused_ce_kd(z.bfloat16(), lab),
                lambda: FL.fused_ce_kd(z, lab[:, :16, :16]),
                lambda: FL.fused_ce_kd(z, lab, t, ce_mode="unce", old_cl=0),
                lambda: FL.fused_ce_kd(z, lab.float())):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("fused_ce_kd accepted an input it cannot take")
    return worst


# Tiled contrastive kernels vs their plain versions. f32 mode: the JAX
# package's on-device gate for its own kernels (bench.py:87-91), loss rel err
# and |dA - ref| / |ref| (Frobenius) <= 1e-4, `num` exact; the per-anchor
# sums get the same 1e-4 (relative to each sum, plus 1e-6 of the largest).
# bf16 mode: kernel and plain version round at the same points, so they keep
# the 1e-4 on the forward sums and 1e-3 on dA (a last-bit f32 difference in
# dL/dadc can flip its bf16 rounding); against the f32 dense loss the bf16
# mode stays within 3e-2 (loss) / 5e-2 of the largest gradient entry
# (bench.py:105-108).
TAU = 0.07
CON_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-3)}
CON_BF16_VS_DENSE = (3e-2, 5e-2)
CON_MAIN = dict(B=BATCH, h=SIZE // 16, w=SIZE // 16, D=256, C=16, H=SIZE,
                W=SIZE, max_label=20, n_label=21)


def contrastive_batch(dev, seed, B, h, w, D, C, H, W, max_label, n_label,
                      capacity=0, labels=None, bkg_logit=0.0, n_old=None):
    """A seeded contrastive batch on `dev`, made by `build_contrastive_batch`
    as the train step makes it: new-model features, donor features
    correlated with them, donor logits over C classes, block-structured
    uint8 labels with 255 regions (or `labels`). As an incremental step's
    dataset has them, ids below `n_old` (default C, the donor's classes)
    are background and only the new ids up to `n_label` - 1 are labelled:
    those pixels are GT-new, the others take the donor's pseudo-label."""
    g = torch.Generator().manual_seed(seed)
    f_n = torch.randn(B, h, w, D, generator=g)
    f_o = 0.6 * f_n + 0.8 * torch.randn(B, h, w, D, generator=g)
    l_po = torch.randn(B, h, w, C, generator=g) * 3
    l_po[..., 0] += bkg_logit
    if labels is None:
        labels = torch.from_numpy(make_labels(B, H, W, n_label, seed + 1))
        labels[labels < (C if n_old is None else n_old)] = 0
    batch = CT.build_contrastive_batch(f_n.to(dev), labels.to(dev),
                                       l_po.to(dev), f_o.to(dev), max_label)
    return CT.compact_batch(batch, capacity)


def tiled_loss_and_grad(fn, batch, *args):
    af = batch.anchor_feat.detach().requires_grad_(True)
    loss = fn(batch._replace(anchor_feat=af), *args)
    (g,) = torch.autograd.grad(loss, af)
    return loss.detach(), g


def rel_rows(got, want) -> float:
    """Largest |got - want| over the anchors, relative to |want| + 1e-6 of
    the largest |want|."""
    scale = want.abs() + 1e-6 * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / scale).max())


def check_contrastive(batch, dtype) -> dict:
    """The three kernels and the composed loss against the plain versions on
    the same CUDA batch; each stage is fed the plain version's inputs."""
    fn = TT.pixel_contrastive_loss_tiled
    before = (fn.launches_pass1, fn.launches_pass2, fn.launches_bwd)
    fwd_tol, bwd_tol = CON_TOL[dtype]
    neg_p, num_p = TT.pass1_plain(batch, TAU, dtype)
    s_p, g_p = TT.pass2_plain(batch, neg_p, TAU, dtype)
    coef = TT.backward_coef(num_p, torch.ones((), device=neg_p.device))
    da_p = TT.bwd_plain(batch, neg_p, g_p, coef, TAU, dtype)
    prep = TT.prepare(batch, dtype)
    # the mode alone picks the kernels of pass 2 and the backward: f32 FMAs
    # in f32 mode, the tensor-core kernels on 2-byte operands in bf16 mode
    assert prep.variant == TT.kernel_variant(dtype) == (
        "mma" if dtype == torch.bfloat16 else "fma")
    assert (prep.mma is not None) == (prep.variant == "mma")
    if prep.mma is not None:
        # all three stages read the 2-byte operands: no float32 copies
        assert {t.dtype for t in prep.mma[:4]} == {torch.bfloat16}
        assert prep.af is None and prep.cf is None
    mma_before = fn.launches_pass1_mma
    neg, num = TT.launch_pass1(prep, TAU)
    assert fn.launches_pass1_mma == mma_before + (prep.variant == "mma")
    again = TT.launch_pass1(prep, TAU)
    assert torch.equal(neg, again[0]) and torch.equal(num, again[1]), \
        "pass 1 twice: different bits"
    before = (before[0] + 1,) + before[1:]
    s, g = TT.launch_pass2(prep, neg_p, TAU)
    da = TT.launch_bwd(prep, neg_p, g_p, coef, TAU)
    torch.cuda.synchronize()
    assert da.shape == batch.anchor_feat.shape and s.shape == neg_p.shape
    assert (fn.launches_pass1, fn.launches_pass2, fn.launches_bwd) == tuple(
        b + 1 for b in before)
    for t in (neg, num, s, g, da):
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
    assert torch.equal(num, num_p), "positive counts differ"
    r = {"neg_rel": rel_rows(neg, neg_p), "s_rel": rel_rows(s, s_p),
         "g_rel": rel_rows(g, g_p),
         "neg_abs": float((neg - neg_p).abs().max()),
         "s_abs": float((s - s_p).abs().max()),
         "da_abs": float((da - da_p).abs().max())}
    ref = float(torch.linalg.vector_norm(da_p))
    r["da_rel"] = float(torch.linalg.vector_norm(da - da_p)) / ref \
        if ref > 0 else float(da.abs().max())
    for k in ("neg_rel", "s_rel", "g_rel"):
        assert r[k] <= fwd_tol, (k, r[k])
    assert r["da_rel"] <= bwd_tol, r["da_rel"]
    # the composed loss and its gradient through autograd
    loss, grad = tiled_loss_and_grad(fn, batch, TAU, dtype)
    loss_p, grad_p = tiled_loss_and_grad(
        TT.pixel_contrastive_loss_tiled_plain, batch, TAU, dtype)
    ref = float(torch.linalg.vector_norm(grad_p))
    r["loss"] = float(loss)
    r["loss_rel"] = abs(float(loss) - float(loss_p)) / max(
        abs(float(loss_p)), 1e-30) if float(loss_p) != 0 else abs(float(loss))
    r["grad_rel"] = float(torch.linalg.vector_norm(grad - grad_p)) / ref \
        if ref > 0 else float(grad.abs().max())
    assert r["loss_rel"] <= fwd_tol and r["grad_rel"] <= bwd_tol, r
    r["valid_anchors"] = int(batch.anchor_valid.sum())
    r["anchors_with_positives"] = int((num > 0).sum())
    return r


def phase_contrastive_kernels(dev) -> dict:
    worst = {}

    def run(name, batch, dtype):
        r = check_contrastive(batch, dtype)
        mode = "bf16" if dtype == torch.bfloat16 else "f32"
        log(f"[kernel] tiled_contrastive {name} {mode}: ok {json.dumps(r)}")
        for k, v in r.items():
            if k.endswith(("_rel", "_abs")):
                worst[k] = max(worst.get(k, 0.0), v)
        return r

    main = contrastive_batch(dev, 60, **CON_MAIN)
    P, D = main.anchor_feat.shape
    assert (P, D) == (BATCH * (SIZE // 16) ** 2, 256)
    assert main.contrast_feat.shape[0] == 2 * P
    assert main.anchor_is_new.any() and not main.anchor_valid.all()
    for dtype in (torch.float32, torch.bfloat16):
        r = run(f"train shape P={P} M={2 * P} D=256 C=16", main, dtype)
        assert r["anchors_with_positives"] > P // 4, r
        # the backward twice: same bits
        a = tiled_loss_and_grad(TT.pixel_contrastive_loss_tiled, main, TAU,
                                dtype)
        b = tiled_loss_and_grad(TT.pixel_contrastive_loss_tiled, main, TAU,
                                dtype)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    log("[kernel] tiled_contrastive forward + backward run twice: same bits")
    ade = contrastive_batch(dev, 61, **dict(CON_MAIN, B=2, C=151, n_old=101,
                                            max_label=150, n_label=151))
    for dtype in (torch.float32, torch.bfloat16):
        run(f"ADE P={ade.anchor_feat.shape[0]} C=151", ade, dtype)
    small = dict(B=2, h=5, w=5, D=8, C=7, H=20, W=20, max_label=6, n_label=7,
                 n_old=4)
    # (in bf16 mode the wrapper zero-pads these operands to the tensor-core
    # tiles: P to 128, M to 64, D and C to 16, padded slots invalid)
    for dtype in (torch.float32, torch.bfloat16):
        run("non-aligned P=50 M=100 D=8 C=7",
            contrastive_batch(dev, 62, **small), dtype)
    wide = dict(B=2, h=10, w=10, D=300, C=16, H=160, W=160, max_label=20,
                n_label=21)
    run("wide P=200 D=300 (two backward slices)",
        contrastive_batch(dev, 63, **wide), torch.float32)
    run("wide P=200 D=300 (two backward slices)",
        contrastive_batch(dev, 63, **wide), torch.bfloat16)
    mid = dict(CON_MAIN, B=2, h=8, w=8, H=128, W=128)
    compact = contrastive_batch(dev, 64, capacity=100, **mid)
    assert compact.anchor_feat.shape[0] == 100
    for dtype in (torch.float32, torch.bfloat16):
        run("compacted to capacity 100", compact, dtype)
    no_new = contrastive_batch(
        dev, 65, labels=torch.zeros(2, 128, 128, dtype=torch.uint8), **mid)
    assert not no_new.anchor_is_new.any() and no_new.anchor_valid.any()
    for dtype in (torch.float32, torch.bfloat16):
        run("no GT-new pixel", no_new, dtype)
    # no valid anchor at all: loss exactly 0, gradient exactly 0
    empty = contrastive_batch(
        dev, 66, labels=torch.zeros(2, 128, 128, dtype=torch.uint8),
        bkg_logit=60.0, **mid)
    assert not empty.anchor_valid.any()
    for dtype in (torch.float32, torch.bfloat16):
        loss, grad = tiled_loss_and_grad(TT.pixel_contrastive_loss_tiled,
                                         empty, TAU, dtype)
        assert float(loss) == 0.0 and not grad.any(), float(loss)
    log("[kernel] tiled_contrastive no valid anchor: loss 0, gradient 0")

    # against the dense loss at a mid shape: f32 mode within the kernel
    # bounds, bf16 mode within bf16 rounding of it
    midb = contrastive_batch(dev, 67, **dict(CON_MAIN, B=2))
    dense, g_dense = tiled_loss_and_grad(CT.pixel_contrastive_loss, midb, TAU)
    scale = float(g_dense.abs().max())
    for dtype, (l_tol, g_tol) in ((torch.float32, (1e-4, 1e-4)),
                                  (torch.bfloat16, CON_BF16_VS_DENSE)):
        loss, grad = tiled_loss_and_grad(TT.pixel_contrastive_loss_tiled,
                                         midb, TAU, dtype)
        l_err = abs(float(loss) - float(dense)) / abs(float(dense))
        g_err = float((grad - g_dense).abs().max()) / scale
        log(f"[kernel] tiled_contrastive vs dense at "
            f"P={midb.anchor_feat.shape[0]} "
            f"{'bf16' if dtype == torch.bfloat16 else 'f32'}: loss "
            f"{float(loss):.6f} / {float(dense):.6f} (rel {l_err:.3g}), "
            f"gradient max err {g_err:.3g} of its largest entry")
        assert l_err <= l_tol and g_err <= g_tol, (l_err, g_err)
        worst["bf16_vs_dense_loss" if dtype == torch.bfloat16
              else "f32_vs_dense_loss"] = l_err
        worst["bf16_vs_dense_grad" if dtype == torch.bfloat16
              else "f32_vs_dense_grad"] = g_err
    # float32-only, CUDA-only, same-device contract: anything else raises
    for bad in (lambda: TT.pixel_contrastive_loss_tiled(main, TAU,
                                                        torch.float16),
                lambda: TT.pixel_contrastive_loss_tiled(main._replace(
                    anchor_feat=main.anchor_feat.double()), TAU),
                lambda: TT.pixel_contrastive_loss_tiled(main._replace(
                    contrast_label=main.contrast_label.long()), TAU),
                lambda: TT.pixel_contrastive_loss_tiled(main._replace(
                    contrast_prob=main.contrast_prob[:, :8]), TAU)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("pixel_contrastive_loss_tiled accepted an "
                             "input it cannot take")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the full-width serving path
# ---------------------------------------------------------------------------

def set_bn_stats_to_batch(model, x):
    """One no-grad train-mode pass over the NCHW batch `x` with momentum
    None sets every BN's running statistics to that batch's."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = None
        m.reset_running_stats()
    model.train()
    with torch.no_grad():
        model.forward_sem(x)
    for m in bns:
        m.momentum = 0.1
    model.eval()


def calibrate(model, x):
    """Running statistics of every BN set to those of the uint8 NHWC batch
    `x`, which keeps the blocks' activations finite in eval mode. Then each
    class's logit is centered and scaled over the same batch (mean 0, std
    2): a random head favours one class everywhere, and the prediction
    should vary across each image as a trained model's does."""
    x = x.permute(0, 3, 1, 2)
    set_bn_stats_to_batch(model, x)
    with torch.no_grad():
        sem = model.forward_sem(x)
        mu = sem.mean(dim=(0, 2, 3))
        scale = 2.0 / sem.std(dim=(0, 2, 3)).clamp_min(1e-6)
        k = 0
        for cls in model.classifiers():
            s = scale[k:k + cls.out_channels]
            cls.weight.mul_(s.view(-1, 1, 1, 1))
            cls.bias.sub_(mu[k:k + cls.out_channels]).mul_(s)
            k += cls.out_channels
    return model


def calibrated_model(dev, classes, backbone="resnet101", size=SIZE,
                     batch=BATCH, seed=0):
    """Seeded f32 model on `dev`, calibrated on one seeded batch."""
    model = IncrementalSegmentationModel(
        classes, backbone=backbone, output_stride=16, head_channels=256,
        pooling_size=32, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device=dev, memory_format=torch.channels_last)
    cal = torch.from_numpy(make_images(batch, size, size, seed=10)).to(dev)
    return calibrate(model, cal)


def build_model(dev, tmp) -> str:
    """Seeded full-width model, BN statistics calibrated on one seeded
    batch, checked on the card against the CPU at a small size, written as
    a bf16 inference npz. Returns its path."""
    model = calibrated_model(dev, CLASSES)

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
    torch.cuda.reset_peak_memory_stats()
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
    return {"model": model, "predictor": predictor, "imgs": imgs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


# ---------------------------------------------------------------------------
# phase 3b: the full-width train path
# ---------------------------------------------------------------------------

def train_batches(n, batch, size, n_classes, seed):
    """n seeded batches of uint8 NHWC images and uint8 labels, on the
    host."""
    return [{"image": make_images(batch, size, size, seed=seed + 2 * i),
             "label": make_labels(batch, size, size, n_classes,
                                  seed=seed + 2 * i + 1)} for i in range(n)]


def build_train(dev, cfg, prev_sd, seed=1):
    """(model, donor model, state, old_vars) of an incremental step whose
    previous step left `prev_sd`."""
    model = make_model(cfg)
    model_old = make_model(cfg, cfg.classes_per_step[:-1]).to(
        device=dev, memory_format=torch.channels_last)
    state, old_vars = build_train_state(
        cfg, model, torch.Generator().manual_seed(seed), total_iters=100,
        prev_model_state=prev_sd, device=dev)
    return model, model_old, state, old_vars


def check_fused_vs_dense(cfg, model, model_old, old_vars, batch, dev):
    """On one batch, the step's loss terms through the kernels equal the
    dense path's (f32 upsample + ops.losses; the dense f32 contrastive
    loss): CE and KD within the fused-loss kernel tolerances, and so the
    gradient on the low-res logits; the contrastive term, which the bf16
    policy runs in the kernels' bf16 mode, within bf16 rounding of the dense
    f32 loss (3e-2; gradient on the new model's pre_logits within 5e-2 of
    its largest entry)."""
    x = torch.from_numpy(batch["image"]).to(dev).permute(0, 3, 1, 2)
    labels = torch.from_numpy(batch["label"]).to(dev)
    model.eval()
    with torch.no_grad():
        feats = model.forward_feats(x, attention=True)
        _, f_old = torch.func.functional_call(
            model_old, old_vars, (x,), {"upsample": False,
                                        "attention": True})
    sem, sem_old = (f["sem"].permute(0, 2, 3, 1).contiguous()
                    for f in (feats, f_old))
    pre, pre_old = (f["pre_logits"].permute(0, 2, 3, 1)
                    for f in (feats, f_old))
    assert sem.shape == (BATCH, SIZE // 16, SIZE // 16, cfg.tot_classes)
    assert sem.dtype == torch.float32 and bool(torch.isfinite(sem).all())
    assert pre.shape == (BATCH, SIZE // 16, SIZE // 16, 256)
    assert pre.dtype == pre_old.dtype == torch.bfloat16
    out = {}
    for name, c in (("fused", cfg), ("dense", dataclasses.replace(
            cfg, fused_loss=False, bf16_upsample=False,
            use_pallas_contrastive=False))):
        z = sem.clone().requires_grad_(True)
        f = pre.clone().requires_grad_(True)
        terms = compute_train_losses(
            c, None, {"sem": z, "pre_logits": f}, labels, None,
            {"sem": sem_old, "pre_logits": pre_old})
        g, gf = torch.autograd.grad(terms["loss_tot"], (z, f))
        out[name] = ({k: float(v.detach()) for k, v in terms.items()}, g,
                     gf.float())
    (tf, gf, cf), (td, gd, cd) = out["fused"], out["dense"]
    for k in ("loss", "lkd"):
        # lkd carries the x10 weight, so its absolute bound scales with it
        scale = cfg.loss_kd if k == "lkd" else 1.0
        assert abs(tf[k] - td[k]) <= scale * LOSS_ATOL + LOSS_RTOL * abs(
            td[k]), (k, tf[k], td[k])
    rel = float((gf - gd).abs().max()) / (float(gd.abs().max()) + 1e-12)
    assert rel <= GRAD_TOL, rel
    assert td["l_con"] > 0, td
    con_rel = abs(tf["l_con"] - td["l_con"]) / td["l_con"]
    con_grad = float((cf - cd).abs().max()) / (float(cd.abs().max()) + 1e-30)
    assert con_rel <= CON_BF16_VS_DENSE[0], (tf["l_con"], td["l_con"])
    assert con_grad <= CON_BF16_VS_DENSE[1], con_grad
    for t in (tf, td):
        assert abs(t["loss_tot"] - (t["loss"] + t["lkd"] + t["l_con"]
                                    + t["lde"])) <= 1e-5 * abs(t["loss_tot"])
    log(f"[train] first batch, kernels vs dense: loss {tf['loss']:.6f} / "
        f"{td['loss']:.6f}, lkd {tf['lkd']:.6f} / {td['lkd']:.6f}, "
        f"d loss_tot / d sem max rel err {rel:.3g}; l_con (bf16 kernels vs "
        f"dense f32) {tf['l_con']:.6f} / {td['l_con']:.6f} (rel "
        f"{con_rel:.3g}), d loss_tot / d pre_logits max err {con_grad:.3g} "
        f"of its largest entry")


BN_STAT_TOL = 2e-5


def watch_batch_stats(model):
    """Forward pre-hooks on every BatchNorm of `model`: each recomputes its
    input's batch mean and biased variance in plain f32 on the card and
    keeps them beside the running statistics as they stood before the
    forward. Returns (records, hook handles)."""
    records, handles = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            def hook(mod, args, name=name):
                x = args[0].detach().float()
                records[name] = (
                    mod.running_mean.clone(), mod.running_var.clone(),
                    x.mean(dim=(0, 2, 3)),
                    x.var(dim=(0, 2, 3), unbiased=False))
            handles.append(m.register_forward_pre_hook(hook))
    return records, handles


def check_running_stats(model, records, momentum=0.1) -> float:
    """After one train step, every BN's running mean and variance equal
    old + momentum * (batch statistic - old), with the *biased* batch
    variance, within BN_STAT_TOL of the tensor's largest entry. Returns
    the largest such error."""
    mods = dict(model.named_modules())
    worst = 0.0
    for name, (mean0, var0, mean, var) in records.items():
        bn = mods[name]
        for got, old, new, what in ((bn.running_mean, mean0, mean, "mean"),
                                    (bn.running_var, var0, var, "var")):
            want = torch.lerp(old, new, momentum)
            err = float((got - want).abs().max()) / (
                float(want.abs().max()) + 1e-12)
            assert err <= BN_STAT_TOL, (
                f"{name}.running_{what}: {err:.3g} of its largest entry "
                f"from the plain f32 update")
            worst = max(worst, err)
    return worst


def check_eval_equals_train_mode(tr, eval_step, batch, dev):
    """With the running statistics set to one batch's, the validate step
    on that batch (eval mode: running statistics, sliding pool of the map's
    own size) computes the function the train-mode forward computes on it,
    so both criterion losses agree within 5 % (bf16 convolutions; cuDNN's
    training and inference norms round differently)."""
    cfg, model, old_vars = tr["cfg"], tr["model"], tr["old_vars"]
    x = torch.from_numpy(batch["image"]).to(dev).permute(0, 3, 1, 2)
    labels = torch.from_numpy(batch["label"]).to(dev)
    set_bn_stats_to_batch(model, x)
    model.train()
    with torch.no_grad():
        sem = model.forward_feats(x)["sem"].permute(0, 2, 3, 1).contiguous()
        train_loss = float(compute_train_losses(
            cfg, None, {"sem": sem}, labels)["loss"])
    _, terms, _ = eval_step(None, batch, empty_confusion(cfg.tot_classes),
                            old_vars)
    eval_loss = float(terms["loss"])
    log(f"[train] running statistics reset to the repeated batch's: "
        f"validate loss {eval_loss:.5f} (eval mode) beside {train_loss:.5f} "
        f"(train-mode forward of the same weights)")
    assert abs(eval_loss - train_loss) <= 0.05 * train_loss + 0.01, (
        eval_loss, train_loss)
    return {"eval_loss": eval_loss, "train_mode_loss": train_loss}


def phase_train(dev) -> dict:
    cfg = C.make_config(**TRAIN)
    assert cfg.classes_per_step == [16, 1] and cfg.old_classes == 16
    assert cfg.unce and cfg.unkd and cfg.init_balanced and cfg.loss_kd == 10
    assert cfg.dtype == "bfloat16" and cfg.fused_loss
    assert cfg.contrastive and cfg.use_pallas_contrastive
    assert cfg.contrastive_weight == 0.01 and cfg.contrastive_capacity == 0
    step0 = calibrated_model(dev, (16,), backbone=cfg.backbone, seed=5)
    prev_sd = {k: v.clone() for k, v in step0.state_dict().items()}
    del step0
    model, model_old, state, old_vars = build_train(dev, cfg, prev_sd)
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the imprint: the new classifier starts from cls_0's background row
    assert torch.equal(model.cls_1.weight[0], model.cls_0.weight[0])
    n_steps = TRAIN_STEPS_FRESH + TRAIN_STEPS_REPEAT
    batches = train_batches(TRAIN_STEPS_FRESH + 1, BATCH, SIZE,
                            cfg.tot_classes, seed=30)
    val = train_batches(2, BATCH, SIZE, cfg.tot_classes, seed=50)
    check_fused_vs_dense(cfg, model, model_old, old_vars, batches[0], dev)

    train_step = make_train_step(cfg, model, model_old, total_iters=100)
    eval_step = make_eval_step(cfg, model, model_old)
    _, terms, _ = eval_step(None, val[0], empty_confusion(cfg.tot_classes),
                            old_vars)
    log(f"[train] validate step before training: loss "
        f"{float(terms['loss']):.5f}, lkd {float(terms['lkd']):.5f}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    donor_before = {k: v.clone() for k, v in old_vars.items()}
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts set to 0 here, read right after it ----
    FL.fused_ce_kd.launches_fwd = FL.fused_ce_kd.launches_bwd = 0
    FE.fused_argmax.launches = 0
    con = TT.pixel_contrastive_loss_tiled
    con.launches_pass1 = con.launches_pass2 = con.launches_bwd = 0
    con.launches_pass1_mma = con.launches_pass2_mma = 0
    con.launches_bwd_mma = 0
    history = []
    bn_records, hooks = watch_batch_stats(model)  # over the first step
    for i in range(n_steps):
        batch = batches[min(i, TRAIN_STEPS_FRESH)]
        state, metrics = train_step(state, batch, old_vars)
        history.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            for h in hooks:
                h.remove()
            bn_err = check_running_stats(model, bn_records)
    train_counts = {"fused_loss_fwd": FL.fused_ce_kd.launches_fwd,
                    "fused_loss_bwd": FL.fused_ce_kd.launches_bwd,
                    "contrastive_pass1": con.launches_pass1,
                    "contrastive_pass2": con.launches_pass2,
                    "contrastive_bwd": con.launches_bwd}
    hist = empty_confusion(cfg.tot_classes)
    val_terms = []
    for batch in val:
        hist, terms, preds = eval_step(None, batch, hist, old_vars)
        val_terms.append({k: float(v) for k, v in terms.items()})
    torch.cuda.synchronize()
    counts = {"fused_loss_fwd": FL.fused_ce_kd.launches_fwd,
              "fused_loss_bwd": FL.fused_ce_kd.launches_bwd,
              "fused_argmax": FE.fused_argmax.launches,
              "contrastive_pass1": con.launches_pass1,
              "contrastive_pass2": con.launches_pass2,
              "contrastive_bwd": con.launches_bwd}
    # ------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for i, m in enumerate(history):
        assert all(np.isfinite(v) for v in m.values()), (i, m)
        assert m["l_con"] > 0, (i, m)
        assert abs(m["loss_tot"] - (m["loss"] + m["lkd"] + m["l_con"])) \
            <= 1e-5 * abs(m["loss_tot"]), (i, m)
        log(f"[train] step {i}: " + ", ".join(
            f"{k} {m[k]:.5f}" for k in ("loss", "lkd", "l_con", "loss_tot",
                                        "lr")))
    assert set(train_counts.values()) == {n_steps}, train_counts
    # bf16 training runs all three contrastive kernels on the tensor cores:
    # every one of their launches was the "mma" variant
    assert TT.kernel_variant(torch.bfloat16) == "mma"
    mma_counts = (con.launches_pass1_mma, con.launches_pass2_mma,
                  con.launches_bwd_mma)
    assert mma_counts == (n_steps,) * 3, mma_counts
    log(f"[train] after the first step, the {len(bn_records)} BNs' running "
        f"statistics equal old + 0.1 * (batch mean / biased batch variance "
        f"recomputed in plain f32 - old): worst error {bn_err:.3g} of a "
        f"tensor's largest entry (bound {BN_STAT_TOL})")
    # the validate step computes no contrastive term
    assert counts == {"fused_loss_fwd": n_steps + len(val),
                      "fused_loss_bwd": n_steps,
                      "fused_argmax": len(val),
                      "contrastive_pass1": n_steps,
                      "contrastive_pass2": n_steps,
                      "contrastive_bwd": n_steps}, counts
    assert state.step == n_steps and state.opt_state["count"] == n_steps
    after = model.state_dict()
    params = dict(model.named_parameters())
    for k in before:
        same = torch.equal(before[k], after[k])
        if k.startswith("cls_0."):
            assert same, f"{k} is frozen but changed"
        elif k in params:
            assert not same, f"{k} did not change"
        elif k.endswith(("running_mean", "running_var")):
            assert not same, f"BN statistic {k} did not change"
    for k, v in donor_before.items():
        assert torch.equal(v, old_vars[k]), f"donor tensor {k} changed"
    first, last = history[TRAIN_STEPS_FRESH], history[-1]
    log(f"[train] repeated batch: loss_tot {first['loss_tot']:.5f} at its "
        f"first visit, {last['loss_tot']:.5f} at its last")
    assert last["loss_tot"] < first["loss_tot"], (first, last)

    n_valid = sum(int((b["label"] != 255).sum()) for b in val)
    assert int(hist.sum()) == n_valid, (int(hist.sum()), n_valid)
    assert preds.shape == (BATCH, SIZE, SIZE) and preds.dtype == torch.int32
    res = results_from_confusion(hist, total_samples=len(val) * BATCH)
    for t in val_terms:
        assert all(np.isfinite(v) for v in t.values()), t
    log(f"[train] validate: {len(val)} batches, {n_valid} labelled pixels "
        f"in the confusion matrix, mIoU {res['Mean IoU']:.4f}, overall acc "
        f"{res['Overall Acc']:.4f}, loss {val_terms[-1]['loss']:.5f}, lkd "
        f"{val_terms[-1]['lkd']:.5f}")
    log(f"[train] launches on the train path: {json.dumps(counts)}; every "
        f"cls_0 tensor and the donor bit-unchanged, every other parameter "
        f"and BN statistic changed; peak memory {peak_gb:.2f} GB")
    tr = {"cfg": cfg, "model": model, "model_old": model_old,
          "state": state, "old_vars": old_vars, "batch": batches[-1],
          "counts": counts, "train_counts": train_counts,
          "n_steps": n_steps, "peak_gb": peak_gb}
    check_eval_equals_train_mode(tr, eval_step, batches[-1], dev)
    return tr


def phase_train_small(dev):
    """One f32 ResNet-50 UCD step at 64x64, batch 2, on the card (kernels,
    the contrastive ones in f32 mode, TF32 off) against the same step on
    the CPU (plain versions): loss terms within 1e-4 relative (`l_con`
    within 1e-3: adc = a.c / tau amplifies the forward's card-vs-CPU
    rounding 14 times), and the new classifier's gradient (well
    conditioned, unlike the gradients below the BN stack) within 1e-3 of
    its largest entry."""
    kw = dict(TRAIN, backbone="resnet50", batch_size=2, crop_size=64,
              dtype="float32")
    cfg = C.make_config(**kw)
    step0 = calibrated_model("cpu", (16,), backbone="resnet50", size=64,
                             batch=2, seed=6)
    prev_sd = {k: v.clone() for k, v in step0.state_dict().items()}
    batch = train_batches(1, 2, 64, cfg.tot_classes, seed=70)[0]
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model, model_old, state, old_vars = build_train(d, cfg, prev_sd)
        step = make_train_step(cfg, model, model_old, total_iters=100,
                               device=d)
        con = TT.pixel_contrastive_loss_tiled

        def launches():
            return (FL.fused_ce_kd.launches_fwd, FL.fused_ce_kd.launches_bwd,
                    con.launches_pass1, con.launches_pass2,
                    con.launches_bwd)
        before = launches()
        _, metrics = step(state, batch, old_vars)
        used = tuple(a - b for a, b in zip(launches(), before))
        assert used == ((1,) * 5 if d.type == "cuda" else (0,) * 5), (
            name, used)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     model.cls_1.weight.grad.detach().cpu().flatten(),
                     model.cls_1.bias.grad.detach().cpu())
    (tc, wc, bc), (tg, wg, bg) = out["cpu"], out["card"]
    assert tc["l_con"] > 0, tc
    for k, tol in (("loss", 1e-4), ("lkd", 1e-4), ("l_con", 1e-3),
                   ("loss_tot", 1e-4)):
        assert abs(tg[k] - tc[k]) <= tol * abs(tc[k]), (k, tg[k], tc[k])
    g_cpu, g_card = torch.cat([wc, bc]), torch.cat([wg, bg])
    rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    log(f"[train] f32 ResNet-50 step at 64x64, card (kernels) vs CPU "
        f"(plain): loss_tot {tg['loss_tot']:.6f} / {tc['loss_tot']:.6f}, "
        f"l_con {tg['l_con']:.6f} / {tc['l_con']:.6f}, new-classifier gradient max rel err {rel:.3g}")
    assert rel <= 1e-3, rel


# ---------------------------------------------------------------------------
# phase 3c: the experiment around the step, through the port's CLI
# ---------------------------------------------------------------------------

# VOC 15-5 (heads [16] then [16, 5]) under --method UCD at full width: two
# incremental steps of one epoch on 16 synthetic 512x512 images (two
# iterations of batch 8 each), validate, save, final test
EXPERIMENT_ARGS = ["--dataset", "voc", "--task", "15-5", "--method", "UCD",
                   "--backbone", "resnet101", "--crop_size", str(SIZE),
                   "--batch_size", str(BATCH), "--epochs", "1",
                   "--synthetic", "16", "--no_pretrained", "--lr", "0.001",
                   "--dtype", "bfloat16"]


def kernel_counts() -> dict:
    con = TT.pixel_contrastive_loss_tiled
    return {"fused_loss_fwd": FL.fused_ce_kd.launches_fwd,
            "fused_loss_bwd": FL.fused_ce_kd.launches_bwd,
            "fused_argmax": FE.fused_argmax.launches,
            "contrastive_pass1": con.launches_pass1,
            "contrastive_pass2": con.launches_pass2,
            "contrastive_bwd": con.launches_bwd,
            "contrastive_pass1_mma": con.launches_pass1_mma,
            "contrastive_pass2_mma": con.launches_pass2_mma,
            "contrastive_bwd_mma": con.launches_bwd_mma}


def zero_kernel_counts():
    FL.fused_ce_kd.launches_fwd = FL.fused_ce_kd.launches_bwd = 0
    FE.fused_argmax.launches = 0
    con = TT.pixel_contrastive_loss_tiled
    con.launches_pass1 = con.launches_pass2 = con.launches_bwd = 0
    con.launches_pass1_mma = con.launches_pass2_mma = 0
    con.launches_bwd_mma = 0


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class ExperimentWatch:
    """Observes the CLI's run without changing it: the kernels' launches
    per incremental step and per eval call, every train iteration's
    metrics (kept on the device until the run ends), each step's wall time,
    epoch metrics and checkpoint writes, the donor each step restored, and
    the host time the train loader takes per batch."""

    def __init__(self):
        self.steps, self.evals, self.iters, self.saves = {}, [], [], []
        self.donors, self.epochs, self.loader_ms = {}, {}, None
        self._patched = []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._patched.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        watch = self

        def run_one_step(orig):
            def wrapped(cfg, *a, **kw):
                before, t0 = kernel_counts(), time.perf_counter()
                score = orig(cfg, *a, **kw)
                torch.cuda.synchronize()
                watch.steps[cfg.step] = {
                    "seconds": time.perf_counter() - t0,
                    "launches": _delta(kernel_counts(), before),
                    "mean_iou": score["Mean IoU"]}
                return score
            return wrapped

        def run(orig):
            def wrapped(exp, *a, **kw):
                step = exp.cfg.step
                if step == 0:
                    # the loader alone: decode-free synthetic images through
                    # the train transform (512x512 random resized crop)
                    t0, n = time.perf_counter(), 0
                    for _ in exp.train_loader.epoch(99):
                        n += 1
                    watch.loader_ms = (time.perf_counter() - t0) / n * 1e3
                if exp.old_vars is not None:
                    watch.donors[step] = {k: v.detach().cpu().clone()
                                          for k, v in exp.old_vars.items()}
                inner = exp.train_step

                def recording(state, batch, old_vars=None):
                    state, m = inner(state, batch, old_vars)
                    watch.iters.append((step, m))
                    return state, m
                exp.train_step = recording
                out = orig(exp, *a, **kw)
                watch.epochs[step] = dict(exp.last_train_metrics)
                return out
            return wrapped

        def validate(orig):
            def wrapped(exp, loader=None):
                before = kernel_counts()
                out = orig(exp, loader)
                watch.evals.append(
                    ("final_test" if loader is not None else "validate",
                     exp.cfg.step, _delta(kernel_counts(), before)))
                return out
            return wrapped

        def save(orig):
            def wrapped(path, *a, **kw):
                t0 = time.perf_counter()
                orig(path, *a, **kw)
                watch.saves.append((path, time.perf_counter() - t0))
            return wrapped

        from ucd_torch import cli as CLI
        from ucd_torch.engine import checkpoint as CK
        from ucd_torch.engine import experiment as EX
        self._patch(CLI, "_run_one_step", run_one_step)
        self._patch(EX.Experiment, "run", run)
        self._patch(EX.Experiment, "validate", validate)
        self._patch(CK, "save_checkpoint", save)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._patched):
            setattr(owner, name, orig)
        return False


def phase_experiment(dev, where) -> dict:
    """The port's CLI on the card: `run-task` of VOC 15-5 under UCD at
    full width (two incremental steps, the second restoring its donor from
    the first's checkpoint), `export` of the step-1 checkpoint at f32 (its
    tensors bit for bit) and bf16, and `predict --save_ids` with the bf16
    npz on four val images (the id maps equal `predict_labels` of the same
    model on the same images). B1-B6 each launch in the phase; B3-B5 only
    in step 1 and only as the tensor-core variant; B6 in validate,
    final_test and predict."""
    from ucd_torch import cli as CLI
    from ucd_torch.data import SyntheticSegmentation
    from ucd_torch.engine import checkpoint as CK
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        logs, ckdir = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        # ---- the main path: counts set to 0 here, read right after it ----
        zero_kernel_counts()
        with ExperimentWatch() as watch:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = CLI.main(["run-task", *EXPERIMENT_ARGS, "--device",
                               dev.type, "--logdir", logs, "--ckpt_dir",
                               ckdir])
            task_s = time.perf_counter() - t0
        assert rc == 0, rc
        train_counts = kernel_counts()
        text = out.getvalue()
        steps = [json.loads(ln) for ln in text.splitlines()
                 if ln.startswith('{"step"')]
        assert [s["step"] for s in steps] == [0, 1], text[-2000:]
        assert "Final mIoU" in text, text[-2000:]
        for ln in text.splitlines():
            if "End of Epoch" in ln or "[!]" in ln:
                log("[experiment] " + ln)
        log("[experiment] run-task: " + json.dumps(steps) + "; "
            + " / ".join(ln for ln in text.splitlines()
                         if ln.startswith(("Final mIoU", "All-step"))))
        ck = [os.path.join(ckdir, f"15-5-voc_Experiment_{s}") for s in (0, 1)]
        for p in ck:
            assert os.path.isfile(p), p
        ck_bytes = os.path.getsize(ck[1])

        # step 1 restored its donor from step 0's checkpoint, bit for bit
        donor = CK.state_dict_of(CK.load_model_state(ck[0]))
        assert set(watch.donors) == {1}, set(watch.donors)
        assert set(donor) == set(watch.donors[1])
        for k, v in donor.items():
            assert torch.equal(v, watch.donors[1][k]), k
        metrics = [(s, {k: float(v) for k, v in m.items()})
                   for s, m in watch.iters]
        assert [s for s, _ in metrics] == [0, 0, 1, 1], metrics
        for s, m in metrics:
            assert all(np.isfinite(v) for v in m.values()), (s, m)
            assert (m["l_con"] > 0) == (s == 1), (s, m)
        # the kernels of each step, each eval call
        s0, s1 = watch.steps[0]["launches"], watch.steps[1]["launches"]
        for k in ("contrastive_pass1", "contrastive_pass2",
                  "contrastive_bwd"):
            assert s0[k] == 0 and s1[k] == 2 and s1[k + "_mma"] == 2, (
                k, s0, s1)
        for s in (s0, s1):
            assert s["fused_loss_fwd"] >= 2 and s["fused_loss_bwd"] == 2, s
        kinds = {(kind, step) for kind, step, d in watch.evals
                 if d["fused_argmax"] > 0}
        assert kinds == {("validate", 0), ("final_test", 0),
                         ("validate", 1), ("final_test", 1)}, watch.evals

        # export the step-1 checkpoint, f32 and bf16
        npz = {d: os.path.join(tmp, f"m_{d}.npz")
               for d in ("float32", "bfloat16")}
        saved = CK.state_dict_of(CK.load_model_state(ck[1]))
        backbone = EXPERIMENT_ARGS[EXPERIMENT_ARGS.index("--backbone") + 1]
        for d, path in npz.items():
            extra = ["--export_dtype", "float32"] if d == "float32" else []
            with contextlib.redirect_stdout(io.StringIO()):
                assert CLI.main(["export", "--ckpt", ck[1], "--out", path,
                                 "--task", "15-5", "--step", "1",
                                 "--backbone", backbone, "--device",
                                 dev.type, *extra]) == 0
        m32, meta = load_inference(npz["float32"], device=dev)
        assert meta["classes"] == [16, 5] and meta["dtype"] == "float32"
        n_equal = 0
        for k, v in m32.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            assert v.dtype == saved[k].dtype and torch.equal(
                v.cpu(), saved[k]), k
            n_equal += 1
        del m32

        # predict --save_ids with the bf16 npz on four val images
        val = SyntheticSegmentation(n=4, size=SIZE, n_classes=21,
                                    seed=C.Config.random_seed + 1000)
        img_dir, pred_dir = os.path.join(tmp, "imgs"), os.path.join(
            tmp, "preds")
        os.makedirs(img_dir)
        for i in range(4):
            Image.fromarray(val.images[i]).save(
                os.path.join(img_dir, f"val{i}.png"))
        before = kernel_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            assert CLI.main(["predict", "--model", npz["bfloat16"],
                             "--images", img_dir, "--out", pred_dir,
                             "--bucket", str(SIZE), "--save_ids",
                             "--device", dev.type]) == 0
        predict_launches = _delta(kernel_counts(), before)
        assert predict_launches["fused_argmax"] >= 1, predict_launches
        counts = kernel_counts()
        # ------------------------------------------------------------------
        m16, _ = load_inference(npz["bfloat16"], device=dev)
        want = Predictor(m16, device=dev).predict_labels(
            val.images).cpu().numpy()
        for i in range(4):
            ids = np.asarray(Image.open(os.path.join(pred_dir,
                                                     f"val{i}_ids.png")))
            assert np.array_equal(ids, want[i]), (i, (ids != want[i]).sum())
            assert os.path.exists(os.path.join(pred_dir, f"val{i}_color.png"))
        del m16
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name in ("fused_loss_fwd", "fused_loss_bwd", "fused_argmax",
                 "contrastive_pass1", "contrastive_pass2", "contrastive_bwd"):
        assert counts[name] > 0, (name, counts)
    for k in ("pass1", "pass2", "bwd"):
        assert counts[f"contrastive_{k}_mma"] == counts[f"contrastive_{k}"]
    r = {"task": "voc 15-5, UCD, ResNet-101, batch 8, 512x512, bf16",
         "task_s": task_s,
         "seconds_per_step": [watch.steps[s]["seconds"] for s in (0, 1)],
         "images_per_s": [watch.epochs[s]["images_per_s"] for s in (0, 1)],
         "epoch_time_s": [watch.epochs[s]["epoch_time_s"] for s in (0, 1)],
         "data_wait_s": [watch.epochs[s]["data_wait_s"] for s in (0, 1)],
         "loader_ms_per_batch": watch.loader_ms,
         "checkpoint_save_s": [t for _, t in watch.saves],
         "checkpoint_bytes": ck_bytes,
         "mean_iou": [s["mean_iou"] for s in steps],
         "f32_export_tensors_equal": n_equal,
         "launches": counts, "launches_train_run_task": train_counts,
         "launches_predict": predict_launches,
         "peak_mem_gb": peak_gb}
    log(f"[experiment] on {where}: run-task {task_s:.1f} s (steps "
        f"{r['seconds_per_step'][0]:.1f} / {r['seconds_per_step'][1]:.1f} s),"
        f" epoch img/s {r['images_per_s'][0]:.2f} / "
        f"{r['images_per_s'][1]:.2f}, loader {watch.loader_ms:.1f} ms per "
        f"batch alone, checkpoint writes "
        + ", ".join(f"{t:.2f}" for _, t in watch.saves)
        + f" s ({ck_bytes / 1e9:.3f} GB each); f32 export holds the "
        f"checkpoint's {n_equal} tensors bit for bit; predict ids equal "
        f"predict_labels; launches {json.dumps(counts)}; peak memory "
        f"{peak_gb:.2f} GB")
    return r


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------

def time_fused_argmax(dev, where) -> dict:
    B, h, w, C, H, W = BATCH, SIZE // 16, SIZE // 16, sum(CLASSES), SIZE, SIZE
    z = torch.randn(B, h, w, C, generator=torch.Generator().manual_seed(2)
                    ).to(dev)
    names = BFK.KERNEL_NAMES["fused_argmax"]
    t = BFK.three_ways(lambda: FE.fused_argmax(z, (H, W)), names, 200)
    zb = z.bfloat16()
    tb = BFK.three_ways(lambda: FE.fused_argmax(zb, (H, W)), names, 200)
    kernel_ms = t["kernel_ms"]
    for three in (t, tb):  # one launch a call, one kernel
        assert three["kernel_launches_per_call"] == 1 and len(
            three["kernels"]) == 1, three
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
    r = {"ms": kernel_ms, "kernel_ms": kernel_ms,
         "wrapper_ms": t["wrapper_ms"], "enqueue_ms": t["enqueue_ms"],
         "kernel_ms_split": t["kernels"], "kernel_ms_bf16": tb["kernel_ms"],
         "wrapper_ms_bf16": tb["wrapper_ms"],
         "enqueue_ms_bf16": tb["enqueue_ms"],
         "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log(f"[time] fused_argmax (8,32,32,21) f32 -> 512x512 on {where}: "
        f"kernel {kernel_ms:.5f} ms on the device ({t['kernels']}), "
        f"wrapper {t['wrapper_ms']:.5f} ms (events), host enqueue "
        f"{t['enqueue_ms']:.5f} ms a call; bf16 input: kernel "
        f"{tb['kernel_ms']:.5f}, wrapper {tb['wrapper_ms']:.5f}, enqueue "
        f"{tb['enqueue_ms']:.5f} ms; plain {plain_ms:.4f} ms, library "
        f"(F.interpolate + argmax) {library_ms:.4f} ms, bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {n_bytes} B, "
        f"{n_ops} flop)")
    return r


def fused_loss_work(B, h, w, C, Co, H, W, old_cl, backward: bool):
    """(bytes, operations, special-function operations) that the fused
    loss must move and do at least, for the unce+unkd modes. Bytes: the two
    logit tensors and the uint8 labels read once; the backward also writes
    dz once. Operations, per output pixel: the separable bilinear
    interpolation of C + Co logits (3 flops per class for the height lerp,
    and the width lerp of the h source rows shared by H/h output rows); per
    member of each stabilized log-sum-exp subset (all C, the old_cl old
    classes, {0} u new = C-Co+1, and the Co old-model classes) one compare,
    one subtract, one exp and one add = 4; 2 per old class for the KD
    products; 4 logs and ~10 flops to combine. The backward needs the
    subsets' maxima and sums again (nothing is kept from the forward) and
    adds per class ~8 flops for the gradient and 4 for the separable fold
    back to low-res. Its gradient terms are the sums' own exps times the
    subsets' reciprocals, so it needs the forward's exp count, the 4 logs
    becoming 4 reciprocals. exp and log count as one operation each at the
    f32 rate, and once more, on their own, at the special function units'
    rate (one exp2 / log2 / reciprocal each)."""
    n_bytes = B * h * w * (C + Co) * 4 + B * H * W
    px = B * H * W
    interp = px * (C + Co) * 3 + B * h * W * (C + Co) * 3
    members = C + old_cl + (C - Co + 1) + Co
    n_ops = interp + px * (members * 4 + Co * 2 + 14)
    n_sfu = px * (members + 4)
    if backward:
        n_bytes += B * h * w * C * 4 + 8
        n_ops += px * C * 12
    return n_bytes, n_ops, n_sfu


def time_fused_loss(dev, where) -> dict:
    """B1 and B2 at the train shape, unce+unkd, uint8 labels."""
    B, h, w, C, Co, H, W = BATCH, SIZE // 16, SIZE // 16, 17, 16, SIZE, SIZE
    g = torch.Generator().manual_seed(4)
    z = torch.randn(B, h, w, C, generator=g).to(dev)
    t = torch.randn(B, h, w, Co, generator=g).to(dev)
    lab = torch.from_numpy(make_labels(B, H, W, C, seed=40)).to(dev)
    kw = dict(old_cl=16, ce_mode="unce", kd_mode="unkd", alpha=1.0)
    coefs = torch.tensor([1.0 / (B * H * W), -10.0 / (Co * B * H * W)],
                         device=dev)
    out = {}
    fwd = BFK.three_ways(lambda: FL.launch_fwd(z, t, lab, **kw),
                         BFK.KERNEL_NAMES["fused_loss_fwd"], 50)
    fwd_ms = fwd["kernel_ms"]
    fwd_full_ms = cuda_ms(lambda: FL.fused_ce_kd(z, lab, t, **kw), iters=50)
    bwd = BFK.three_ways(lambda: FL.launch_bwd(z, t, lab, coefs, **kw),
                         BFK.KERNEL_NAMES["fused_loss_bwd"], 20)
    bwd_ms = bwd["kernel_ms"]
    plain_fwd_ms = cuda_ms(lambda: FL.fused_ce_kd_plain(z, lab, t, **kw),
                           iters=10, warmup=3)
    plain_both_ms = cuda_ms(
        lambda: FL.fused_ce_kd_grad_plain(z, lab, t, ct_kd=10.0, **kw),
        iters=10, warmup=3)
    # yardstick for the ce/none mode only: no single PyTorch call computes
    # unCE + unKD. The port never calls it.
    lab64 = lab.long()
    zc = z.permute(0, 3, 1, 2)
    library_ms = cuda_ms(lambda: F.cross_entropy(
        F.interpolate(zc, size=(H, W), mode="bilinear", align_corners=False),
        lab64, ignore_index=255, reduction="sum"), iters=10, warmup=3)
    ce_none = BFK.three_ways(lambda: FL.launch_fwd(
        z, None, lab, old_cl=0, ce_mode="ce", kd_mode="none", alpha=1.0),
        BFK.KERNEL_NAMES["fused_loss_fwd"], 50)
    ce_none_ms = ce_none["kernel_ms"]
    for name, ms, plain, backward, three in (
            ("fused_loss_fwd", fwd_ms, plain_fwd_ms, False, fwd),
            ("fused_loss_bwd", bwd_ms, plain_both_ms, True, bwd)):
        n_bytes, n_ops, n_sfu = fused_loss_work(B, h, w, C, Co, H, W, 16,
                                                backward)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        fma_ms = n_ops / F32_FLOP_PER_S * 1e3
        sfu_ms = n_sfu / SFU_OP_PER_S * 1e3
        ops_ms = max(fma_ms, sfu_ms)
        out[name] = {"ms": ms, "kernel_ms": ms,
                     "wrapper_ms": three["wrapper_ms"],
                     "enqueue_ms": three["enqueue_ms"],
                     "kernel_ms_split": three["kernels"], "plain_ms": plain,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "library_ms": None,
                     "bytes": n_bytes, "operations": n_ops,
                     "sfu_operations": n_sfu,
                     "bound_rate": "SFU 4.18e12 op/s" if sfu_ms >= fma_ms
                     else "f32 FMA 67e12 flop/s",
                     "fma_bound_ms": fma_ms, "sfu_bound_ms": sfu_ms}
    out["fused_loss_fwd"].update(
        with_partial_sum_ms=fwd_full_ms, ce_none_ms=ce_none_ms,
        ce_none_wrapper_ms=ce_none["wrapper_ms"],
        ce_none_library_ms=library_ms)
    f, b = out["fused_loss_fwd"], out["fused_loss_bwd"]
    log(f"[time] fused_loss forward (8,32,32,17/16) -> 512x512 unce+unkd on "
        f"{where}: kernel {fwd_ms:.5f} ms on the device, wrapper "
        f"{f['wrapper_ms']:.5f} ms (events), host enqueue "
        f"{f['enqueue_ms']:.5f} ms a call ({fwd_full_ms:.4f} ms through "
        f"fused_ce_kd), plain (dense forward) "
        f"{plain_fwd_ms:.4f} ms, bound {f['bound_ms']:.5f} ms "
        f"({f['bound_by']} at {f['bound_rate']}: {f['bytes']} B, "
        f"{f['operations']} op, {f['sfu_operations']} exp/log); ce/none "
        f"mode kernel {ce_none_ms:.5f} ms, wrapper "
        f"{ce_none['wrapper_ms']:.5f} ms beside F.interpolate + "
        f"F.cross_entropy {library_ms:.4f} ms")
    log(f"[time] fused_loss backward (cell + fold kernels), same shape, on "
        f"{where}: kernel {bwd_ms:.5f} ms on the device ({bwd['kernels']}), "
        f"wrapper {b['wrapper_ms']:.5f} ms, host enqueue "
        f"{b['enqueue_ms']:.5f} ms, plain (dense forward + backward) "
        f"{plain_both_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
        f"({b['bound_by']} at {b['bound_rate']}: {b['bytes']} B, "
        f"{b['operations']} op, {b['sfu_operations']} exp/log)")
    return out


def tiled_contrastive_work(P, M, D, C, dtype=torch.float32) -> dict:
    """name -> (bytes, operations) that each tiled contrastive kernel must
    move and do at least. Operations: the matrix products alone, 2 per
    multiply-add (pass 1 one P x M x D similarity product; pass 2 that plus
    the P x M x C joint-probability product; the backward both plus the
    second P x M x D product with the contrast features); the masked
    exp / log epilogue (a few operations per pair beside 2 D) is left out.
    Bytes: features and probabilities (4 bytes a value; 2 in bf16 mode,
    whose kernels read bfloat16) and the 6-byte slot records read once, the
    per-anchor rows read and written once, dA written once."""
    wide = 2 if dtype == torch.bfloat16 else 4
    feats, probs = (P + M) * D, (P + M) * C
    slots, row = (P + M) * 6, P * 4
    sim, jm = 2 * P * M * D, 2 * P * M * C
    return {"contrastive_pass1": (feats * wide + slots + 2 * row, sim),
            "contrastive_pass2": ((feats + probs) * wide + slots + 3 * row,
                                  sim + jm),
            "contrastive_bwd": ((feats + probs) * wide + slots + 3 * row
                                + P * D * 4, 2 * sim + jm)}


def time_contrastive(dev, where) -> dict:
    """B3, B4, B5 at the train shape in both modes beside their plain
    versions and their bounds: operations at the f32 rate outside the
    tensor cores in f32 mode, at the dense bf16 tensor rate in bf16 mode
    (the least time the card could take for bf16 products). No single
    PyTorch call computes any of the three: library_ms is None."""
    batch = contrastive_batch(dev, 80, **CON_MAIN)
    P, D = batch.anchor_feat.shape
    M, C = batch.contrast_feat.shape[0], batch.anchor_prob.shape[1]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        prep = TT.prepare(batch, dtype)
        neg, num = TT.launch_pass1(prep, TAU)
        _, g = TT.launch_pass2(prep, neg, TAU)
        coef = TT.backward_coef(num, torch.ones((), device=dev))
        ms = {
            "contrastive_pass1": (
                lambda: TT.launch_pass1(prep, TAU),
                cuda_ms(lambda: TT.pass1_plain(batch, TAU, dtype), 3, 1)),
            "contrastive_pass2": (
                lambda: TT.launch_pass2(prep, neg, TAU),
                cuda_ms(lambda: TT.pass2_plain(batch, neg, TAU, dtype), 3,
                        1)),
            "contrastive_bwd": (
                lambda: TT.launch_bwd(prep, neg, g, coef, TAU),
                cuda_ms(lambda: TT.bwd_plain(batch, neg, g, coef, TAU,
                                             dtype), 3, 1))}
        rate = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
        work = tiled_contrastive_work(P, M, D, C, dtype)
        variants = {name: prep.variant for name in ms}
        launch = {}
        if prep.variant == "mma":
            (Pp, Dp), Cp = prep.mma.af.shape, prep.mma.ap.shape[1]
            n_tiles = prep.mma.cf.shape[0] // TT.MMA_TILE_C
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            for name, kernel, c in (("contrastive_pass1", "pass1", 0),
                                    ("contrastive_pass2", "pass2", Cp),
                                    ("contrastive_bwd", "bwd", Cp)):
                tile_a = TT.anchor_tile(kernel, Dp, c)
                launch[name] = {
                    "anchors_per_block": tile_a,
                    "ring_stages": TT.ring_stages(Dp, c, tile_a),
                    "parts_of_m": TT.m_parts(Pp // tile_a, n_tiles, n_sm)}
        for name, (launch_fn, plain_ms) in ms.items():
            three = BFK.three_ways(launch_fn, BFK.KERNEL_NAMES[name], 10)
            kernel_ms = three["kernel_ms"]
            n_bytes, n_ops = work[name]
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / rate * 1e3
            r = {"ms": kernel_ms, "kernel_ms": kernel_ms,
                 "wrapper_ms": three["wrapper_ms"],
                 "enqueue_ms": three["enqueue_ms"], "plain_ms": plain_ms,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "library_ms": None, "bytes": n_bytes, "operations": n_ops,
                 "tflop_per_s": n_ops / kernel_ms / 1e9,
                 "variant": variants[name], **launch.get(name, {})}
            out.setdefault(name, {})["bf16" if bf16 else "f32"] = r
            how = variants[name] + " variant" + (
                " " + json.dumps(launch[name]) if name in launch else "")
            log(f"[time] {name} P={P} M={M} D={D} C={C} "
                f"{'bf16' if bf16 else 'f32'} mode ({how}) on {where}: kernel "
                f"{kernel_ms:.4f} ms on the device ({r['tflop_per_s']:.2f} "
                f"TFLOP/s), wrapper {r['wrapper_ms']:.4f} ms, host enqueue "
                f"{r['enqueue_ms']:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}: {n_bytes} B, {n_ops} flop), library: "
                f"none")
    return out


def time_training(dev, tr, where, profile_dir) -> dict:
    """Train-step throughput under UCD and, with the same model and batch,
    under MiB (the UCD preset minus the contrastive term: their difference
    is what the term costs), in windows ordered UCD, MiB, MiB, UCD, twice;
    both steps' device time between the marks of their parts; UCD at batch
    16."""
    cfg, model, model_old = tr["cfg"], tr["model"], tr["model_old"]
    cfg_mib = C.make_config(**dict(TRAIN, method="MiB"))
    assert not cfg_mib.contrastive and cfg_mib.loss_kd == cfg.loss_kd
    steps = {"ucd": make_train_step(cfg, model, model_old, total_iters=100),
             "mib": make_train_step(cfg_mib, model, model_old,
                                    total_iters=100)}
    state, old_vars, batch = tr["state"], tr["old_vars"], tr["batch"]
    r = {"peak_mem_gb": tr["peak_gb"]}

    def img_per_s(step, st, ov, b, n=10):
        for _ in range(2):
            step(st, b, ov)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(st, b, ov)
        torch.cuda.synchronize()
        return len(b["label"]) * n / (time.perf_counter() - t0)

    # the host clock of a shared host spreads by tens of percent between
    # windows: four windows of 10 steps each, interleaved
    runs = {"ucd": [], "mib": []}
    for name in ("ucd", "mib", "mib", "ucd") * 2:
        runs[name].append(img_per_s(steps[name], state, old_vars, batch))
    r["img_per_s"] = sum(runs["ucd"]) / len(runs["ucd"])
    r["img_per_s_runs"] = runs["ucd"]
    r["step_ms"] = BATCH / r["img_per_s"] * 1e3
    r["img_per_s_mib"] = sum(runs["mib"]) / len(runs["mib"])
    r["img_per_s_mib_runs"] = runs["mib"]
    r["step_ms_mib"] = BATCH / r["img_per_s_mib"] * 1e3
    r["contrastive_term_ms"] = r["step_ms"] - r["step_ms_mib"]

    # the same steps with a CUDA event recorded between their parts
    events = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    n = 5
    for key, c in (("device_ms", cfg), ("device_ms_mib", cfg_mib)):
        marked_step = make_train_step(c, model, model_old, total_iters=100,
                                      mark=mark)
        sums = {}
        for _ in range(n):
            events.clear()
            marked_step(state, batch, old_vars)
            torch.cuda.synchronize()
            for (_, a), (k, b) in zip(events, events[1:]):
                sums[k] = sums.get(k, 0.0) + a.elapsed_time(b) / n
        r[key] = sums
    log(f"[time] train step, UCD VOC 15-5s step 1, ResNet-101, batch "
        f"{BATCH}, {SIZE}x{SIZE}, bf16 with f32 masters on {where}: "
        f"{r['img_per_s']:.2f} img/s ({r['step_ms']:.2f} ms per step, host "
        f"clock, synchronized per 10 steps, mean of windows "
        f"{', '.join(f'{v:.2f}' for v in runs['ucd'])}); under MiB (no "
        f"contrastive term) {r['img_per_s_mib']:.2f} img/s "
        f"({r['step_ms_mib']:.2f} ms, windows "
        f"{', '.join(f'{v:.2f}' for v in runs['mib'])}); device ms between "
        f"events, UCD: "
        + ", ".join(f"{k} {v:.2f}" for k, v in r["device_ms"].items())
        + "; MiB: "
        + ", ".join(f"{k} {v:.2f}" for k, v in r["device_ms_mib"].items())
        + f"; peak memory {r['peak_mem_gb']:.2f} GB")
    if profile_dir:
        profile(lambda: steps["ucd"](state, batch, old_vars), profile_dir,
                "train_step", n=3)

    # batch 16, the JAX package's headline batch; no assertion on it
    del steps
    big = train_batches(1, 16, SIZE, cfg.tot_classes, seed=90)[0]
    cfg16 = dataclasses.replace(cfg, batch_size=16)
    torch.cuda.reset_peak_memory_stats()
    step16 = make_train_step(cfg16, model, model_old, total_iters=100)
    r["img_per_s_batch16"] = img_per_s(step16, state, old_vars, big, n=5)
    r["peak_mem_gb_batch16"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[time] UCD train step at batch 16 on {where}: "
        f"{r['img_per_s_batch16']:.2f} img/s, peak memory "
        f"{r['peak_mem_gb_batch16']:.2f} GB")
    return r


def time_experiment(dev, where) -> dict:
    """The experiment loop in steady state, beside phase 4's raw step: a
    step-1 UCD `Experiment` (VOC 15-5, ResNet-101, batch 8, 512x512, bf16)
    over 64 synthetic images, three epochs of 8 iterations through
    `train_epoch` (img/s, the host's wait for the loader), then one more
    pass over batches loaded beforehand (no loader threads); the train loader
    alone at 1, 4 and 8 worker threads; one checkpoint write, synchronous
    and asynchronous (the time the loop is held)."""
    from ucd_torch.data import DataLoader, SyntheticSegmentation
    from ucd_torch.engine import checkpoint as CK
    from ucd_torch.engine.experiment import Experiment

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(dataset="voc", task="15-5", backbone="resnet101",
                  crop_size=SIZE, batch_size=BATCH, lr=0.001, epochs=3,
                  pretrained=False, visualize=False, print_interval=1000,
                  logdir=os.path.join(tmp, "logs"),
                  ckpt_dir=os.path.join(tmp, "ckpt"))
        base0 = SyntheticSegmentation(n=BATCH, size=SIZE, n_classes=16,
                                      seed=1)
        exp0 = Experiment(C.make_config(step=0, method="FT", **kw),
                          base_train=base0, base_val=base0, device=dev)
        exp0.save(0, 0.0)  # the donor of step 1, untrained
        exp0.close()
        del exp0
        base1 = SyntheticSegmentation(n=8 * BATCH, size=SIZE, n_classes=21,
                                      seed=2)
        exp = Experiment(C.make_config(step=1, method="UCD", **kw),
                         base_train=base1, base_val=base1, device=dev)
        assert len(exp.train_loader) == 8
        epochs = [exp.train_epoch(e) for e in range(3)]
        # the same steps over batches loaded beforehand: no loader threads
        # compete with the step's host work
        batches = list(exp.train_loader.epoch(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            exp.state, _ = exp.train_step(exp.state, b, exp.old_vars)
        torch.cuda.synchronize()
        preloaded = len(batches) * BATCH / (time.perf_counter() - t0)
        loader_ms = {}
        for w in (1, 4, 8):
            loader = DataLoader(exp.train_dst, BATCH, seed=1, workers=w,
                                prefetch=0)
            t0 = time.perf_counter()
            n = sum(1 for _ in loader.epoch(0))
            loader_ms[w] = (time.perf_counter() - t0) / n * 1e3
            loader.close()
        path = os.path.join(tmp, "ck")
        save_s = {}
        for mode in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CK.save_checkpoint(path, exp.state, 0, 0.0, async_write=mode)
            save_s["async" if mode else "sync"] = time.perf_counter() - t0
            CK.wait_pending()
        exp.close()
    r = {"epoch_img_per_s": [e["images_per_s"] for e in epochs],
         "epoch_time_s": [e["epoch_time_s"] for e in epochs],
         "data_wait_s": [e["data_wait_s"] for e in epochs],
         "loss_tot": [e["loss_tot"] for e in epochs],
         "preloaded_img_per_s": preloaded,
         "loader_ms_per_batch_by_workers": loader_ms,
         "checkpoint_call_s": save_s}
    log(f"[time] experiment loop, UCD VOC 15-5 step 1, ResNet-101, batch "
        f"{BATCH}, {SIZE}x{SIZE}, bf16 on {where}: epochs of 8 iterations "
        + ", ".join(f"{e['images_per_s']:.2f}" for e in epochs)
        + " img/s (waiting for the loader "
        + ", ".join(f"{e['data_wait_s']:.3f}" for e in epochs)
        + " s of " + ", ".join(f"{e['epoch_time_s']:.3f}" for e in epochs)
        + f" s); over batches loaded beforehand {preloaded:.2f} img/s; "
        "the loader alone "
        + ", ".join(f"{v:.1f} ms a batch at {w} threads"
                    for w, v in loader_ms.items())
        + f"; a checkpoint write holds the loop {save_s['sync']:.2f} s "
        f"(sync) / {save_s['async']:.2f} s (async)")
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
        arg = BFK.three_ways(lambda: FE.fused_argmax(z, (SIZE, SIZE)),
                             BFK.KERNEL_NAMES["fused_argmax"], 50)
    r = {"img_per_s": BATCH / sync_s, "batch_ms": sync_s * 1e3,
         "forward_sem_ms": fwd_ms, "logits_dtype": str(z.dtype),
         "fused_argmax_ms": arg["kernel_ms"],
         "fused_argmax_wrapper_ms": arg["wrapper_ms"],
         "peak_mem_gb": served["peak_gb"]}
    log(f"[time] predict_labels batch 8, 512x512, bf16 on {where}: "
        f"{r['img_per_s']:.2f} img/s ({r['batch_ms']:.2f} ms per batch incl. "
        f"upload and fetch); device: forward_sem {fwd_ms:.2f} ms, "
        f"fused_argmax on its {z.dtype} logits {arg['kernel_ms']:.5f} ms "
        f"(wrapper {arg['wrapper_ms']:.5f} ms); peak memory over the "
        f"serving phase {r['peak_mem_gb']:.2f} GB")
    if profile_dir:
        profile(lambda: predictor.predict_labels(imgs).cpu(), profile_dir,
                "predict_labels")
    return r


def profile(fn, out_dir, name, n=5):
    """torch.profiler table of n calls of fn(), by device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    os.makedirs(out_dir, exist_ok=True)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    try:
        table = avg.table(sort_by="device_time_total", row_limit=100)
    except (KeyError, AttributeError, RuntimeError):
        table = avg.table(sort_by="cuda_time_total", row_limit=100)
    path = os.path.join(out_dir, f"{name}_profile.txt")
    with open(path, "w") as f:
        f.write(table)
    log(f"[profile] {n} x {name} -> {path}")
    log("\n".join(table.splitlines()[:20]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also write torch.profiler tables of "
                         "predict_labels and of the train step into DIR")
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="stop after the kernel checks (prints no result)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clock = [time.time()]

    def lap(name):
        clock.append(time.time())
        log(f"[phase] {name}: {clock[-1] - clock[-2]:.1f} s")

    # phase 1: build
    build.build(build.kernel_sources())
    where = card()
    log(f"[build] {build.kernel_sources()} built for {where}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    for name in (FE.KERNEL, FL.KERNEL, TT.KERNEL):
        ptxas = build.library_path(name).with_suffix(".log").read_text()
        # registers, shared memory, stack and spills of each kernel
        log("\n".join(ln for ln in ptxas.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry function" in ln))
        spills = [ln for ln in ptxas.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        assert not spills, f"{name}: register spills: {spills}"
    lap("1 build")

    # phase 2: every kernel against its plain version
    err = phase_kernels(dev)
    loss_err = phase_loss_kernels(dev)
    con_err = phase_contrastive_kernels(dev)
    lap("2 kernels vs plain versions")
    if args.only == "kernels":
        return 0

    # phase 3a: the serving path, with every launch count read over it alone
    with tempfile.TemporaryDirectory() as tmp:
        npz = build_model(dev, tmp)
        FE.fused_argmax.launches = 0
        served = phase_serving(dev, npz)
        serve_launches = FE.fused_argmax.launches
    assert serve_launches > 0, "the serving path never launched fused_argmax"
    log(f"[serve] fused_argmax launches on the serving path: "
        f"{serve_launches}")
    lap("3a serving path")

    # phase 3b: the train path (it sets the counts to 0 and reads them)
    phase_train_small(dev)
    trained = phase_train(dev)
    counts = trained["counts"]
    assert min(counts.values()) > 0, counts
    lap("3b train path")

    # phase 3c: the experiment around the step, through the CLI (it sets
    # the counts to 0 and reads them)
    experiment = phase_experiment(dev, where)
    lap("3c experiment")

    # phase 4: timings
    timing = time_fused_argmax(dev, where)
    loss_timing = time_fused_loss(dev, where)
    con_timing = time_contrastive(dev, where)
    serving = time_serving(dev, served, where, args.profile)
    log(json.dumps({"serving": {"card": where, **serving}}))
    training = time_training(dev, trained, where, args.profile)
    log(json.dumps({"training": {"card": where, **training}}))
    loop = time_experiment(dev, where)
    lap("4 timings")
    log(json.dumps({"experiment": {
        "card": where, **experiment,
        "raw_ucd_step_img_per_s": training["img_per_s"],
        "raw_ucd_step_img_per_s_runs": training["img_per_s_runs"],
        "steady_state": loop}}))
    exp_counts = experiment["launches"]

    kernels = [{
        "name": "fused_argmax", "route": "cuda",
        "source": "ucd_torch/ops/csrc/fused_argmax.cu",
        "replaces": "ucd_tpu/ops/fused_eval.py:76",
        "replaces_fn": "ucd_tpu/ops/fused_eval.py::_argmax_kernel",
        "launches": serve_launches + counts["fused_argmax"],
        "launches_serving": serve_launches,
        "launches_train": counts["fused_argmax"],
        "launches_experiment": exp_counts["fused_argmax"],
        "max_abs_err": err["max_abs_err"],
        "mismatch_rate": err["mismatch_rate"],
        **timing}]
    for name, line, fn, err_key in (
            ("fused_loss_fwd", 181, "_loss_kernel", "loss_err"),
            ("fused_loss_bwd", 224, "_grad_kernel", "grad_err")):
        t = loss_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ucd_torch/ops/csrc/fused_loss.cu",
            "replaces": f"ucd_tpu/ops/fused_loss.py:{line}",
            "replaces_fn": f"ucd_tpu/ops/fused_loss.py::{fn}",
            "launches": counts[name], "launches_serving": 0,
            "launches_train": counts[name],
            "launches_experiment": exp_counts[name],
            "launches_per_train_step":
                trained["train_counts"][name] / trained["n_steps"],
            "max_abs_err": loss_err[err_key],
            "max_rel_grad_err": loss_err["grad_rel_err"],
            **t})
    # the full-width train path runs the contrastive kernels in bf16 mode:
    # ms / plain_ms / bound_ms are that mode's, the f32 mode's follow
    for name, line, fn, abs_key, rel_key in (
            ("contrastive_pass1", 77, "_pass1_kernel", "neg_abs", "neg_rel"),
            ("contrastive_pass2", 98, "_pass2_kernel", "s_abs", "s_rel"),
            ("contrastive_bwd", 126, "_bwd_kernel", "da_abs", "da_rel")):
        t = con_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ucd_torch/ops/csrc/tiled_contrastive.cu",
            "replaces": f"ucd_tpu/ops/pallas_contrastive.py:{line}",
            "replaces_fn": f"ucd_tpu/ops/pallas_contrastive.py::{fn}",
            "launches": counts[name], "launches_serving": 0,
            "launches_train": counts[name],
            "launches_experiment": exp_counts[name],
            "launches_per_train_step":
                trained["train_counts"][name] / trained["n_steps"],
            "max_abs_err": con_err[abs_key], "max_rel_err": con_err[rel_key],
            "mode": "bf16", **t["bf16"],
            **{f"{k}_f32": t["f32"][k] for k in (
                "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                "operations",
                "bytes", "tflop_per_s", "variant")}})
    log(json.dumps({"kernels": kernels}))
    log(where)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
