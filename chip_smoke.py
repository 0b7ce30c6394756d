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
     d. K train steps a call: from one snapshot of 3b's state, 12 UCD
        steps eagerly (twice) and through make_train_bundle(k=4), one step
        captured in a CUDA graph and replayed, and once more with eager
        steps between bundle calls, under torch.use_deterministic_algorithms
        (an op without a deterministic kernel is named): the same bits in
        every parameter, statistic, momentum buffer, count and per-step
        metric, B1-B5 once a step in the replays' tally; nan_guard's select
        on CUDA tensors;
     e. the other method families at full width: RW over VOC 15-5s step 0
        -> 1 (3 iterations each; step 0's export feeds step 1's importance;
        `l_reg` > 0; B1/B2 only) and its k=3 bundle bit for bit, one LWF-MC
        step (iCaRL's dense BCE criterion, no fused kernel), and one f32
        ResNet-50 RW step on the card against the CPU;
     f. (run after phase 4) data parallelism (ucd_torch/parallel) on a
        process group of one rank over NCCL (a file:// rendezvous), from
        one snapshot of 3b's state: the synchronized BatchNorm against
        the plain one at three of the step's shapes; one validate step
        and one train step inside the group against the same outside it,
        at bf16 and at f32 (loss terms and updates within 3b's bf16 bound
        or twice what a rounding-only change of the plain step moves
        them, cuDNN off; the confusion matrix exact; B1-B6 counted on the
        path); 12 steps eagerly and through make_train_bundle(k=4), NCCL
        inside the captured graph, bit for bit; img/s eager and captured, capture
        seconds, NCCL device time and the model's train-mode forward +
        backward outside the group, inside it and outside it again;
     g. (run after 3f) the host ops' C++ build on this host
        (ucd_torch/data/native.py, g++ at first use) held against the
        numpy/PIL versions at VOC's shapes (375x500 sources, 512x512
        crops, flips: geometry exact, normalize within 1e-6), its host
        time a batch against theirs, and PERF.md's experiment loop at
        steps_per_call 4 with and without it; then, with the launch counts
        set to 0 just before and read just after, one full-width UCD step
        from 3b's variables under each execution option (remat,
        remat_early, stem_s2d, bf16_norm, bf16_norm_early) beside the
        plain step (remat's with the plain step's bits under deterministic
        algorithms; the others within 3b's bf16 bound or twice a
        rounding-only change, cuDNN off), a validate step each, peak
        memory and img/s eager and captured (K 4), 12 captured remat steps
        bit for bit against 12 eager ones, the stem_s2d model exported and
        served; GroupNorm ABN and the off-path modules (v1 contrastive
        losses, Sinkhorn-Knopp, the non-local block) on the card against
        the CPU;
     h. (run after 3g) two gloo ranks on the one card (gloo stages CUDA
        tensors through the host; one card cannot host two NCCL ranks),
        from 3b's variables with a fresh optimizer, at bf16 and in the
        f32 twin: the 1-D data axis (4 images a rank) and the 1 x 2 data
        x model mesh (ucd_torch/parallel/mesh.py: the wide convs' output
        channels, >= 256, sharded over the two ranks, with their
        BatchNorms, momentum and the donor's variables; all 8 images),
        each held to the plain step by `check_dp_deviation` (the loss
        terms, the update and the worst tensor's update within 3b's bf16
        bound or twice a rounding-only change, cuDNN off); the mesh's
        replicated tensors the same bits on both ranks, B1-B5 once in its
        bf16 step (counts set to 0 just before, read just after); on the
        mesh also the validate step against the plain one (each labelled
        pixel counted once, predictions by phase 2's tie rule for B6,
        the loss within 3b's bf16 bound; B1 and B6 once at bf16), a
        `nan_guard` step with a NaN gradient on model rank 1 only (both
        ranks skip; parameters, momentum and update count keep their
        bits), an EWC step and a `bf16_norm` step, each at bf16 and f32
        against its plain step by `check_dp_deviation`; each rank's bytes
        of parameters + momentum + donor against the plain step's, peak
        memory, seconds a step (recorded, not judged);
     i. (run after 3h) the accuracy path: the six-step VOC 15-5s
        `run-task` under UCD and FT at the JAX retention test's sizes
        (tests/test_torch_retention_curve.py: ResNet-50 64x64 os 8, f32,
        48 learnable synthetic images) with the kernels on, cut to 2
        epochs a step; B1, B2 and B6 launch in every step, the f32
        variants of B3-B5 in UCD's steps 1-5 only (counts set to 0 before
        the phase, read after it); six finite rows of IoU a method, its
        per-step table logged. The JAX bars are `--only bars`'s;
  4. time each kernel three ways (its own device time from a
     torch.profiler window, CUDA events around the wrapper calls, the
     host's enqueue time a call) beside its plain version, one library
     call (where one exists) and its roofline bound, the serving throughput
     and the
     train-step throughput under UCD and under MiB at batch 8 (UCD also at
     16), 512x512, bf16; then the experiment loop in steady state (three
     epochs of 8 UCD iterations through `Experiment.train_epoch`, at
     steps_per_call 1 and 4), the train loader alone at 1, 4 and 8
     threads, a checkpoint write, sync and async; the UCD step eager
     against captured at K = 1, 4, 8 (img/s, device busy and idle share,
     capture seconds, memory); and a capture that must fail (a step that
     synchronizes, in a process of its own) ending its process non-zero.

After phase 4 come `{"serving": ...}`, `{"training": ...}`, `{"bundle":
...}` (phase 3d's verdict and launches, the eager-vs-captured timing, the
failing capture, the loop at steps_per_call 1 and 4), `{"families": ...}`,
`{"dp": ...}` (phase 3f), `{"experiment": ...}` (phase 3c's seconds per
step, epoch img/s, loader
and checkpoint times, launches and peak memory, beside phase 4's raw UCD
step img/s), `{"options": ...}` (phase 3g), `{"mesh2d": ...}` (phase
3h) and `{"accuracy": ...}` (phase 3i). The last three lines of stdout
are the `{"kernels": [...]}` record (each row's `ms` / `kernel_ms` the
device time, `wrapper_ms` the events', `launches_experiment` its
launches in phase 3c, `launches_options` in 3g's option steps,
`launches_mesh2d` in 3h's bf16 mesh sides: the validate, train,
nan_guard, EWC and bf16_norm steps, `launches_accuracy` in 3i), the
card's name and power limit (nvidia-smi), and `{"ok": true, "device":
...}`.
`--profile DIR` also writes torch.profiler tables of predict_labels and of
the train step there. `--only kernels` stops after phase 2, `--only dp`
runs phases 1, 3b and 3f, `--only options` phases 1, 3b and 3g,
`--only mesh2d` phases 1, 3b and 3h, `--only bars` phase 1 and the
port's functional tests at their sizes and bars with the kernels on,
under deterministic cuDNN and torch algorithms (the learnability run, the
incremental run with the contrastive kernels, the 15-5s `run-task` of UCD
and FT at the JAX list less `--no_pallas`, 25 epochs a step; readings and
margins logged before a bar is judged, a missed bar fails), `--only
accuracy` phase 1 and the
VOC 15-5s retention curve at full width (ResNet-101, os 16, 512x512,
batch 8, bf16, 48 learnable synthetic images, UCD and FT, plain and
under `bf16_norm`, the epoch count fixed first from plain step 0 alone);
none prints a result (for bringing a kernel, the data-parallel path, the
options, the mesh or the accuracy path up).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

# cuBLAS takes a fixed workspace, so that the bundle phase may run under
# torch.use_deterministic_algorithms (read when cuBLAS starts)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ucd_torch import config as C  # noqa: E402
from ucd_torch import parallel as P  # noqa: E402
from ucd_torch.engine.export import (_bucket_hw, load_inference,  # noqa: E402
                                     save_inference)
from ucd_torch.engine.metrics import (empty_confusion,  # noqa: E402
                                      results_from_confusion)
from ucd_torch.engine.predictor import Predictor  # noqa: E402
from ucd_torch.engine.server import (MicroBatcher, make_server,  # noqa: E402
                                     shutdown_server)
from ucd_torch.engine.state import build_train_state  # noqa: E402
from ucd_torch.engine.train import (_launch_counters,  # noqa: E402
                                    compute_train_losses, make_eval_step,
                                    make_optimizer, make_train_bundle,
                                    make_train_step)
from ucd_torch.models import (IncrementalSegmentationModel,  # noqa: E402
                              make_model)
from ucd_torch.models.segmentation import resize_bilinear  # noqa: E402
from ucd_torch.ops import build  # noqa: E402
from ucd_torch.ops import contrastive as CT  # noqa: E402
from ucd_torch.ops import fused_eval as FE  # noqa: E402
from ucd_torch.ops import fused_loss as FL  # noqa: E402
from ucd_torch.ops import regularizers as R  # noqa: E402
from ucd_torch.ops import tiled_contrastive as TT  # noqa: E402
from ucd_torch.utils import tracing  # noqa: E402

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
# phase 3d: K train steps a call through a CUDA graph (make_train_bundle)
# ---------------------------------------------------------------------------

BUNDLE_STEPS, BUNDLE_K = 12, 4
TRAIN_COUNTERS = ("fused_loss_fwd", "fused_loss_bwd", "contrastive_pass1",
                  "contrastive_pass2", "contrastive_bwd")


def state_tensors(state, model) -> dict:
    """Every tensor of the train state by name: parameters and buffers,
    momentum, the optimizer's counts, the call count and the regularizer's
    accumulators."""
    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    opt = state.opt_state
    out.update({f"trace.{k}": v for k, v in opt["trace"].items()})
    out.update(count=opt["count"], nonfinite=opt["nonfinite"],
               step=state.step)
    rs = state.reg_state
    if rs is not None:
        out["reg.count"] = rs.count
        for field in R.MEMBER_FIELDS:
            for k, v in (getattr(rs, field) or {}).items():
                out[f"reg.{field}.{k}"] = v
    return out


def snapshot(state, model) -> dict:
    return {k: v.detach().clone() for k, v in
            state_tensors(state, model).items()}


@torch.no_grad()
def restore(state, model, snap):
    """Copy `snap` into the live state's own tensors (a captured step keeps
    reading them)."""
    for k, v in state_tensors(state, model).items():
        v.copy_(snap[k])


def stacked(batches):
    return {key: np.stack([b[key] for b in batches]) for key in batches[0]}


def run_steps(step, bundle, k, state, batches, old_vars, plan):
    """Train over `batches` by `plan`, a string of "e" (one eager step)
    and "b" (one bundle call of k steps). Returns the per-step metrics,
    (n, keys) in sorted key order."""
    rows, i = [], 0
    for what in plan:
        if what == "e":
            _, m = step(state, batches[i], old_vars)
            rows.append(torch.stack([m[key] for key in sorted(m)])[None])
            i += 1
        else:
            _, m = bundle(state, stacked(batches[i:i + k]), old_vars)
            rows.append(torch.stack([m[key] for key in sorted(m)], dim=1))
            i += k
    assert i == len(batches), (i, len(batches))
    return torch.cat(rows)


def compare_runs(ref, other, spread=None) -> list:
    """Names where `other` differs from `ref` (dicts of tensors): in any bit,
    or, given `spread` (the largest |difference| of two eager runs by
    name), by more than that spread."""
    bad = []
    for k, v in ref.items():
        if spread is None:
            if not torch.equal(v, other[k]):
                bad.append(k)
        elif float((v.double() - other[k].double()).abs().max()) \
                > spread[k]:
            bad.append(k)
    return bad


def spread_of(a, b) -> dict:
    return {k: float((v.double() - b[k].double()).abs().max())
            for k, v in a.items()}


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms (warn_only: an op without a
    deterministic implementation warns and is named) and cuDNN's
    deterministic algorithms, for the bit comparisons only."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def nondeterministic_ops(caught) -> list:
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught
                   if "does not have a deterministic" in str(w.message)})


def bits_eager_vs_bundle(step, bundle, k, state, model, batches, old_vars,
                         plans) -> dict:
    """From one snapshot of the state: the eager run twice, then each
    bundled plan of `plans` (name -> plan), every run restored to the
    snapshot first. With two eager runs bit-equal and no op named
    nondeterministic, every plan must give the same bits as the eager run
    in every state tensor and per-step metric; otherwise it must stay
    within the two eager runs' spread (and the run names why). Returns
    the plans' launch counts, the mismatches and the deterministic
    verdict."""
    n = len(batches)
    snap = snapshot(state, model)
    with deterministic() as caught:
        runs = {}
        for name, plan in (("eager", "e" * n), ("eager_again", "e" * n),
                           *plans.items()):
            restore(state, model, snap)
            before = kernel_counts()
            m = run_steps(step, bundle, k, state, batches, old_vars, plan)
            torch.cuda.synchronize()
            runs[name] = ({**snapshot(state, model), "metrics": m},
                          _delta(kernel_counts(), before))
        restore(state, model, snap)
    ops = nondeterministic_ops(caught)
    ref, again = runs["eager"][0], runs["eager_again"][0]
    eager_diff = compare_runs(ref, again)
    exact = not ops and not eager_diff
    spread = None if exact else spread_of(ref, again)
    out = {"exact": exact, "nondeterministic_ops": ops,
           "eager_vs_eager_differs": eager_diff[:20],
           "n_tensors": len(ref) - 1, "n_steps": n}
    for name in plans:
        bad = compare_runs(ref, runs[name][0], spread)
        assert not bad, (f"{name}: {len(bad)} tensors differ from the eager "
                         f"run ({'bits' if exact else 'beyond the spread'})"
                         f": {bad[:10]}")
        out[f"launches_{name}"] = runs[name][1]
    return out


def phase_bundle(dev, tr) -> dict:
    """12 full-width UCD steps (phase 3b's model and state, VOC 15-5s step
    1, ResNet-101, batch 8, 512x512, bf16 with f32 masters) eagerly and
    through make_train_bundle(k=4) from one snapshot, with the same bits in
    every parameter, BN statistic, momentum buffer, count and per-step
    metric; B1-B5 once per step in the replays' tally; and again with an
    eager step between two bundle calls. Then nan_guard's select on the
    card."""
    cfg, model, model_old = tr["cfg"], tr["model"], tr["model_old"]
    state, old_vars = tr["state"], tr["old_vars"]
    batches = train_batches(BUNDLE_STEPS, BATCH, SIZE, cfg.tot_classes,
                            seed=110)
    step = make_train_step(cfg, model, model_old, total_iters=100)
    bundle = make_train_bundle(cfg, model, model_old, total_iters=100,
                               k=BUNDLE_K)
    # bundle, bundle, bundle; then bundle, eager, bundle, eager x 3
    res = bits_eager_vs_bundle(
        step, bundle, BUNDLE_K, state, model, batches, old_vars,
        {"bundle": "bbb", "interleaved": "bebeee"})
    for name, n in (("bundle", BUNDLE_STEPS), ("interleaved", BUNDLE_STEPS)):
        counts = res[f"launches_{name}"]
        for key in TRAIN_COUNTERS + ("contrastive_pass1_mma",
                                     "contrastive_pass2_mma",
                                     "contrastive_bwd_mma"):
            assert counts[key] == n, (name, key, counts)
        assert counts["fused_argmax"] == 0, counts
    cap = bundle.capture
    res["capture_s"] = cap.capture_s
    res["launches_per_replay"] = dict(zip(
        [f"{fn.__name__}.{a}" for fn, a in _launch_counters()],
        cap.launches))
    log(f"[bundle] {BUNDLE_STEPS} UCD steps eager and through "
        f"make_train_bundle(k={BUNDLE_K}) from one snapshot: "
        + (f"the same bits in all {res['n_tensors']} state tensors and "
           f"every per-step metric" if res["exact"] else
           f"within the spread of two eager runs (nondeterministic ops: "
           f"{res['nondeterministic_ops']}; eager runs differ at "
           f"{res['eager_vs_eager_differs']})")
        + f", also with eager steps between bundle calls; launches in the "
        f"replays' tally {json.dumps(res['launches_bundle'])}; capture "
        f"{cap.capture_s:.3f} s")
    del bundle, cap
    res["nan_guard"] = check_nan_guard(dev)
    return res


def check_nan_guard(dev) -> dict:
    """The optimizer's non-finite select on CUDA tensors: a NaN and an
    -inf gradient are skipped (parameters, momentum and count unchanged,
    the skip count up), a finite gradient of 3e38 is applied and resets
    the skip count."""
    cfg = C.make_config(**dict(TRAIN, nan_guard=True))
    tx = make_optimizer(cfg, 100)
    g = torch.Generator().manual_seed(3)
    params = {k: torch.randn(shape, generator=g).to(dev) for k, shape in
              (("a", (64, 3)), ("b", (1000,)))}
    opt = tx.init(params)
    seen = []
    for bad in (float("nan"), float("-inf"), 3e38):
        grads = {k: torch.randn(p.shape, generator=g).to(dev)
                 for k, p in params.items()}
        grads["b"][17] = bad
        before = {k: v.clone() for k, v in params.items()}
        tx.update(params, grads, opt)
        same = all(torch.equal(before[k], params[k]) for k in params)
        seen.append((same, int(opt["count"]), int(opt["nonfinite"])))
    assert seen == [(True, 0, 1), (True, 0, 2), (False, 1, 0)], seen
    log(f"[bundle] nan_guard on the card: NaN and -inf gradients skipped, "
        f"a finite 3e38 applied: (unchanged, count, skips) {seen}")
    return {"skips": seen}


CAPTURE_FAILURE = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from ucd_torch import config as C
from ucd_torch.engine.state import build_train_state
from ucd_torch.engine.train import make_train_bundle
from ucd_torch.models import make_model
from ucd_torch.ops import fused_loss as FL
import numpy as np
cfg = C.make_config(dataset="voc", task="15-5s", step=0, method="FT",
                    backbone="resnet50", batch_size=2, crop_size=64,
                    dtype="float32")
model = make_model(cfg)
state, _ = build_train_state(cfg, model, torch.Generator().manual_seed(0),
                             10, device="cuda")
real = FL.launch_fwd
def syncing(*a, **kw):
    torch.cuda.synchronize()  # not allowed while a stream captures
    return real(*a, **kw)
FL.launch_fwd = syncing
rs = np.random.RandomState(0)
batches = {"image": rs.randint(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8),
           "label": rs.randint(0, 16, (2, 2, 64, 64)).astype(np.uint8)}
make_train_bundle(cfg, model, None, 10, k=2)(state, batches)
print("NO FAILURE")
"""


def check_capture_failure() -> dict:
    """A bundle whose step synchronizes with the host (which a capture
    refuses) in a process of its own: the capture's error ends it with a
    non-zero exit, naming the capture; nothing falls back to eager."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", CAPTURE_FAILURE,
         os.path.dirname(os.path.abspath(__file__))],
        capture_output=True, text=True, timeout=600)
    msg = [ln for ln in out.stderr.splitlines()
           if "CUDA-graph capture of the train step failed" in ln]
    assert out.returncode != 0 and msg and "NO FAILURE" not in out.stdout, (
        out.returncode, out.stdout[-2000:], out.stderr[-3000:])
    log(f"[bundle] a capture that fails ends its process with exit code "
        f"{out.returncode}: {msg[-1][:200]}")
    return {"returncode": out.returncode, "message": msg[-1][:300],
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 3e: the other method families at full width
# ---------------------------------------------------------------------------

FAMILY_ITERS = 3


def finite_terms(history, what):
    for i, m in enumerate(history):
        assert all(np.isfinite(v) for v in m.values()), (what, i, m)


# ---------------------------------------------------------------------------
# phase 3f: the data-parallel path on a process group of one rank (NCCL)
# ---------------------------------------------------------------------------

# the bound of phase 3b's kernels-vs-dense check (bf16 rounding): loss
# terms relative, each parameter's update against its largest entry
DP_VS_PLAIN = CON_BF16_VS_DENSE


def step_and_validate(cfg, model, model_old, state, old_vars, batch, val):
    """One validate step on `val`, then one train step on `batch` (both
    built here, so inside a process group they take its collectives).
    Returns (the step's metrics, the state after it, the confusion matrix,
    the validate losses)."""
    step = make_train_step(cfg, model, model_old, total_iters=100)
    eval_step = make_eval_step(cfg, model, model_old)
    hist, terms, _ = eval_step(None, val, empty_confusion(cfg.tot_classes),
                               old_vars)
    _, m = step(state, batch, old_vars)
    after = snapshot(state, model)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in m.items()}, after, hist.cpu(),
            {k: float(v) for k, v in terms.items()})


def img_per_s_windows(fn, images, n_windows=2) -> list:
    """img/s of `n_windows` windows of fn() (`images` a call), host clock,
    synchronized at each window's ends."""
    out = []
    for _ in range(n_windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(images / (time.perf_counter() - t0))
    return out


def nccl_device_ms(fn, n) -> dict:
    """The device time a call of fn() spends in NCCL kernels (torch.profiler
    by kernel name, over n calls), their count a call, and every kernel's
    time a call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    nccl_us = busy_us = 0.0
    calls = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += evt.self_device_time_total
        if "nccl" in evt.key.lower():
            nccl_us += evt.self_device_time_total
            calls += evt.count
    return {"nccl_ms": nccl_us / 1e3 / n, "nccl_kernels": calls / n,
            "busy_ms": busy_us / 1e3 / n}


def time_dp_side(tr, batches, name) -> dict:
    """One side of the data-parallel timing (`name` "plain" outside a
    process group, "dist" inside one): the UCD step's img/s eager (windows
    of 8 steps) and through make_train_bundle(k=4) (windows of 2 calls),
    the capture's seconds, the device busy time a step (eager: profiler;
    captured: the graph replayed back to back, CUDA events), the NCCL
    kernels' device time a step (eager), and the device time of the
    model's train-mode forward + backward alone (the synchronized
    BatchNorm's cost, inside a group). The state is restored after."""
    cfg, model, model_old = tr["cfg"], tr["model"], tr["model_old"]
    state, old_vars = tr["state"], tr["old_vars"]
    snap = snapshot(state, model)
    step = make_train_step(cfg, model, model_old, total_iters=100)
    bundle = make_train_bundle(cfg, model, model_old, total_iters=100,
                               k=BUNDLE_K)
    stack = stacked(batches[:BUNDLE_K])
    bundle(state, stack, old_vars)          # slot 0 eager, then capture
    step(state, batches[0], old_vars)
    r = {"capture_s": bundle.capture.capture_s}

    def eager():
        for i in range(8):
            step(state, batches[i % len(batches)], old_vars)

    def captured():
        for _ in range(2):
            bundle(state, stack, old_vars)

    r["eager_img_per_s_runs"] = img_per_s_windows(eager, 8 * BATCH)
    r["captured_img_per_s_runs"] = img_per_s_windows(
        captured, 2 * BUNDLE_K * BATCH)
    prof = nccl_device_ms(lambda: step(state, batches[0], old_vars), 3)
    # the captured step's device time: its graph replayed back to back
    # (CUDA events; no profiler window over a graph's replay)
    r["busy_ms"] = {"eager": prof["busy_ms"],
                    "captured": cuda_ms(bundle.capture.graph.replay,
                                        iters=10, warmup=2)}
    r["nccl_ms"], r["nccl_kernels"] = prof["nccl_ms"], prof["nccl_kernels"]
    x = torch.from_numpy(batches[0]["image"]).to(
        next(model.parameters()).device).permute(0, 3, 1, 2)

    def fwd_bwd():
        model.train()
        feats = model.forward_feats(x)
        feats["sem"].float().sum().backward()
        for p in model.parameters():
            p.grad = None

    r["fwd_bwd_busy_ms"] = busy_ms(fwd_bwd, 3)
    del bundle
    restore(state, model, snap)
    torch.cuda.empty_cache()
    log(f"[dp] {name}: eager img/s {r['eager_img_per_s_runs']}, captured "
        f"(K={BUNDLE_K}) img/s {r['captured_img_per_s_runs']}, capture "
        f"{r['capture_s']:.3f} s, device busy a step {r['busy_ms']}, NCCL "
        f"kernels a step {r['nccl_kernels']} taking {r['nccl_ms']:.4f} ms, "
        f"train-mode forward + backward {r['fwd_bwd_busy_ms']:.2f} ms")
    return r


def dp_deviation(before, ref, other) -> dict:
    """How far `other` (metrics, state after a step from `before`) is from
    `ref`: the loss terms' largest relative difference; each parameter
    update's largest difference against the update's largest entry (the
    worst tensor, and its name), and over all parameters, the difference's
    norm against the update's; whether the bits are equal. The frozen `cls_0` must be
    unchanged on both sides."""
    (rm, ra), (om, oa) = ref, other
    terms = max(abs(om[k] - rm[k]) / abs(rm[k])
                for k in ("loss", "lkd", "l_con", "loss_tot"))
    worst, num, den, n_params, equal = 0.0, 0.0, 0.0, 0, True
    worst_name = None
    for k, v in ra.items():
        equal = equal and torch.equal(v, oa[k])
        if not k.startswith("model.") or not v.is_floating_point() or \
                k.endswith(("running_mean", "running_var")):
            continue
        up_r, up_o = (v - before[k]).double(), (oa[k] - before[k]).double()
        if k.startswith("model.cls_0."):
            assert not up_r.any() and not up_o.any(), k
            continue
        n_params += 1
        err = float((up_o - up_r).abs().max()) / (
            float(up_r.abs().max()) + 1e-30)
        if err > worst:
            worst, worst_name = err, k
        num += float((up_o - up_r).norm()) ** 2
        den += float(up_r.norm()) ** 2
    assert den > 0, "the reference step updated no parameter"
    return {"terms_rel_err": terms, "worst_update_err": worst,
            "worst_tensor": worst_name,
            "update_rel_err": (num / max(den, 1e-300)) ** 0.5,
            "n_params": n_params, "bits_equal": equal}


# the synchronized BatchNorm against the plain one on the card, f32, one
# rank: output and running statistics against their largest entry, the
# gradients (dx cancellation-dominated) against theirs
SYNC_BN_TOL = (1e-5, 1e-4)
SYNC_BN_SHAPES = ((BATCH, 256, SIZE // 4, SIZE // 4),   # the largest
                  (BATCH, 2048, SIZE // 16, SIZE // 16),
                  (BATCH, 256, 1, 1))                   # ASPP pooling


def batchnorm_run(shape, dev, seed) -> dict:
    """A train-mode `BatchNorm2d` forward + backward on a seeded f32
    channels_last input (channel 0 constant: no variance): output, input
    gradient, weight and bias gradients, running statistics. Outside a
    process group the plain path (cuDNN), inside one the synchronized
    one."""
    from ucd_torch.models.layers import BatchNorm2d
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).contiguous(
        memory_format=torch.channels_last)
    x[:, 0] = 0.0
    dy = torch.randn(shape, device=dev, generator=g).contiguous(
        memory_format=torch.channels_last)
    bn = BatchNorm2d(c, eps=1e-5, momentum=0.1).to(dev)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, device=dev, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, device=dev, generator=g))
    x.requires_grad_(True)
    y = bn(x)
    y.backward(dy)
    torch.cuda.synchronize()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def check_sync_batchnorm(refs, dev) -> float:
    """Inside a process group of one rank: `batchnorm_run` of each
    SYNC_BN_SHAPES against `refs`, the same runs outside it. Returns the
    largest error against its bound's scale, as a share of the bound."""
    worst = 0.0
    for i, shape in enumerate(SYNC_BN_SHAPES):
        got = batchnorm_run(shape, dev, seed=160 + i)
        for k, want in refs[i].items():
            tol = SYNC_BN_TOL[1] if k in ("dx", "dw", "db") \
                else SYNC_BN_TOL[0]
            err = float((got[k] - want).abs().max()) / (
                float(want.abs().max()) + 1e-30)
            assert err <= tol, (shape, k, err, tol)
            worst = max(worst, err / tol)
    return worst


def check_dp_deviation(dp, rounding, what) -> None:
    """The data-parallel step may move from the plain step by no more than
    DP_VS_PLAIN (phase 3b's bf16 bound) or twice what a rounding-only
    change of the plain step moves it (cuDNN off), whichever is larger:
    the loss terms, the update overall and the worst tensor's update."""
    for key, floor in (("terms_rel_err", DP_VS_PLAIN[0]),
                       ("update_rel_err", DP_VS_PLAIN[1]),
                       ("worst_update_err", DP_VS_PLAIN[1])):
        bound = max(floor, 2 * rounding[key])
        assert dp[key] <= bound, (what, key, dp[key], bound, dp, rounding)


def f32_twin(tr, dev):
    """Phase 3b's model and donor at float32 compute (TF32 off), from the
    same variables, with a fresh optimizer: (cfg, model, donor, state,
    donor variables). The bf16 step's gradient is dominated by rounding
    (a rounding-only change moves it by its own size), so the comparison
    that can tell a fault from rounding runs in f32."""
    cfg = dataclasses.replace(tr["cfg"], dtype="float32")
    model, model_old, state, old_vars = build_train(
        dev, cfg, {k: v for k, v in tr["old_vars"].items()})
    with torch.no_grad():
        model.load_state_dict(tr["model"].state_dict())
    return cfg, model, model_old, state, old_vars


def f64_twin(twin, dev):
    """An f32 twin (`f32_twin`) at float64, with the dense losses (no
    kernel): (cfg, model, donor, state, donor variables). Its plain step
    is the reference that tells an f32 step's rounding from a fault."""
    cfg, model, _, _, old_vars = twin
    cfg = dataclasses.replace(cfg, dtype="float64", fused_loss=False,
                              use_pallas_contrastive=False)
    m64, old64, state, vars64 = build_train(
        dev, cfg, {k: v.double() if v.is_floating_point() else v
                   for k, v in old_vars.items()})
    with torch.no_grad():
        m64.load_state_dict(model.state_dict())
    return cfg, m64, old64, state, vars64


def phase_dp(dev, tr, where) -> dict:
    """The data-parallel path (ucd_torch/parallel) on a process group of
    one rank over NCCL, at phase 3b's full width: its collectives carry
    identity values but launch (the communicator, the synchronized
    BatchNorm's all-gathers and all-reduces, the contrastive term's gather,
    the gradient all-reduce, the confusion all-reduce). From one snapshot
    of 3b's state: one validate step + one step outside the group and
    inside it, at bf16 and again at f32 (`check_dp_deviation`: loss terms
    and updates within DP_VS_PLAIN or twice a rounding-only change of the
    plain step; the validate step's confusion matrix and losses exact, as
    it synchronizes no BatchNorm; B1-B6 counted on the path); 12 steps
    inside it eagerly and through make_train_bundle(k=4), NCCL in the
    captured graph, bit
    for bit; img/s eager and captured, NCCL device time and the model's
    forward + backward, outside the group, inside it and outside it again.
    The group is destroyed at the end."""
    cfg, model, model_old = tr["cfg"], tr["model"], tr["model_old"]
    state, old_vars = tr["state"], tr["old_vars"]
    batches = train_batches(BUNDLE_STEPS, BATCH, SIZE, cfg.tot_classes,
                            seed=130)
    val = train_batches(1, BATCH, SIZE, cfg.tot_classes, seed=150)[0]
    # the schedule restarts: the earlier phases' steps take the count past
    # total_iters, where the poly rate is 0 and a step updates nothing
    with torch.no_grad():
        state.opt_state["count"].zero_()
        state.step.zero_()
    snap = snapshot(state, model)
    assert not P.is_distributed()
    plain = step_and_validate(cfg, model, model_old, state, old_vars,
                              batches[0], val)
    restore(state, model, snap)
    # the same step with other rounding (cuDNN off: PyTorch's own
    # convolutions and BatchNorm), for the size of a rounding-only change
    with torch.backends.cudnn.flags(enabled=False):
        alt = step_and_validate(cfg, model, model_old, state, old_vars,
                                batches[0], val)
    restore(state, model, snap)
    bn_refs = [batchnorm_run(sh, dev, seed=160 + i)
               for i, sh in enumerate(SYNC_BN_SHAPES)]
    # the same two at float32
    twin = f32_twin(tr, dev)
    snap32 = snapshot(twin[3], twin[1])
    plain32 = step_and_validate(*twin, batches[0], val)
    restore(twin[3], twin[1], snap32)
    with torch.backends.cudnn.flags(enabled=False):
        alt32 = step_and_validate(*twin, batches[0], val)
    restore(twin[3], twin[1], snap32)
    timing = {"plain": time_dp_side(tr, batches, "plain")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        P.init_group(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            assert P.is_distributed() and P.world_size() == 1
            assert torch.distributed.get_backend() == P.distributed \
                .backend_for(dev) == "nccl" if dev.type == "cuda" else True
            out["sync_batchnorm_worst_share_of_bound"] = \
                check_sync_batchnorm(bn_refs, dev)
            del bn_refs
            # ---- the main path: counts set to 0 here, read right after
            zero_kernel_counts()
            dist = step_and_validate(cfg, model, model_old, state,
                                     old_vars, batches[0], val)
            counts = kernel_counts()
            # ---------------------------------------------------------
            restore(state, model, snap)
            out["launches"] = counts
            for key in TRAIN_COUNTERS + ("contrastive_pass1_mma",
                                         "contrastive_pass2_mma",
                                         "contrastive_bwd_mma"):
                want = 2 if key == "fused_loss_fwd" else 1  # + validate
                assert counts[key] == want, (key, counts)
            assert counts["fused_argmax"] == 1, counts
            dist32 = step_and_validate(*twin, batches[0], val)
            out["vs_plain"] = dp_deviation(snap, plain[:2], dist[:2])
            out["rounding_only"] = dp_deviation(snap, plain[:2], alt[:2])
            out["vs_plain_f32"] = dp_deviation(snap32, plain32[:2],
                                               dist32[:2])
            out["rounding_only_f32"] = dp_deviation(snap32, plain32[:2],
                                                    alt32[:2])
            log(f"[dp] against the plain step, bf16: {out['vs_plain']}; "
                f"the plain step with cuDNN off: {out['rounding_only']}; "
                f"f32: {out['vs_plain_f32']}; f32 with cuDNN off: "
                f"{out['rounding_only_f32']}")
            check_dp_deviation(out["vs_plain"], out["rounding_only"],
                               "bf16")
            check_dp_deviation(out["vs_plain_f32"],
                               out["rounding_only_f32"], "f32")
            assert torch.equal(plain32[2], dist32[2])
            del twin, snap32, plain32, alt32, dist32
            assert torch.equal(plain[2], dist[2]), "confusion matrices differ"
            assert int(dist[2].sum()) == int((val["label"] != 255).sum())
            out["confusion_total"] = int(dist[2].sum())
            assert dist[3] == plain[3], (dist[3], plain[3])
            out["metrics_plain"], out["metrics_dist"] = plain[0], dist[0]
            step = make_train_step(cfg, model, model_old, total_iters=100)
            bundle = make_train_bundle(cfg, model, model_old,
                                       total_iters=100, k=BUNDLE_K)
            bits = bits_eager_vs_bundle(step, bundle, BUNDLE_K, state, model,
                                        batches, old_vars,
                                        {"bundle": "b" * (BUNDLE_STEPS //
                                                          BUNDLE_K)})
            for key in TRAIN_COUNTERS:
                assert bits["launches_bundle"][key] == BUNDLE_STEPS, bits
            out["bundle"] = {k: v for k, v in bits.items()}
            out["bundle"]["capture_s"] = bundle.capture.capture_s
            del bundle, step
            torch.cuda.empty_cache()
            timing["dist"] = time_dp_side(tr, batches, "dist")
        finally:
            P.shutdown()
    assert not P.is_distributed()
    timing["plain_again"] = time_dp_side(tr, batches, "plain, again")
    out["timing"] = timing
    v, r = out["vs_plain"], out["rounding_only"]
    log(f"[dp] one NCCL rank, UCD VOC 15-5s step 1, ResNet-101, batch "
        f"{BATCH}, {SIZE}x{SIZE}, bf16, on {where}: one step against the "
        f"plain step from one state: loss terms within "
        f"{v['terms_rel_err']:.3g} (bound {DP_VS_PLAIN[0]}), the "
        f"{v['n_params']} parameters' updates within "
        f"{v['update_rel_err']:.3g} overall, the worst tensor "
        f"{v['worst_update_err']:.3g} of its largest entry (the plain step "
        f"with cuDNN off: {r['terms_rel_err']:.3g}, "
        f"{r['update_rel_err']:.3g}, {r['worst_update_err']:.3g}), bits "
        f"equal: {v['bits_equal']}; at f32: "
        + ", ".join(f"{out['vs_plain_f32'][k]:.3g}" for k in (
            "terms_rel_err", "update_rel_err", "worst_update_err"))
        + " (cuDNN off: " + ", ".join(
            f"{out['rounding_only_f32'][k]:.3g}" for k in (
                "terms_rel_err", "update_rel_err", "worst_update_err"))
        + f"); the synchronized BatchNorm against the plain one at "
        f"{len(SYNC_BN_SHAPES)} shapes within "
        f"{out['sync_batchnorm_worst_share_of_bound']:.3g} of its bounds "
        f"{SYNC_BN_TOL}; the validate step's confusion matrix "
        f"equal ({out['confusion_total']} pixels); launches "
        f"{json.dumps(out['launches'])}; {BUNDLE_STEPS} steps eager and "
        f"through make_train_bundle(k={BUNDLE_K}) with NCCL in the graph: "
        + ("the same bits in all state tensors and per-step metrics"
           if out["bundle"]["exact"] else "within two eager runs' spread")
        + f", replays' tally {json.dumps(out['bundle']['launches_bundle'])}")
    return out


def phase_families(dev) -> dict:
    """RW at full width (ResNet-101, batch 8, 512x512, bf16 with f32
    masters): 3 iterations of VOC 15-5s step 0, its `export_state` fed to
    step 1's `init_reg_state`, 3 iterations of step 1 (every term finite,
    `l_reg` > 0 once the parameters left the donor's, B1/B2 once per step
    in ce mode, no contrastive kernel), and the same 3 step-1 iterations
    through make_train_bundle(k=3) with the same bits; one LWF-MC step
    (iCaRL's dense BCE criterion and term, no fused kernel) finite and
    moving the parameters; one f32 ResNet-50 RW step on the card against
    the CPU."""
    out = {}
    cfg0 = C.make_config(**dict(TRAIN, step=0, method="RW"))
    cfg1 = C.make_config(**dict(TRAIN, method="RW"))
    assert cfg1.regularizer == "rw" and cfg1.loss_kd == 0
    batches0 = train_batches(FAMILY_ITERS, BATCH, SIZE, cfg0.tot_classes,
                             seed=120)
    batches = train_batches(FAMILY_ITERS, BATCH, SIZE, cfg1.tot_classes,
                            seed=130)
    zero_kernel_counts()
    model0 = make_model(cfg0)
    state0, _ = build_train_state(cfg0, model0,
                                  torch.Generator().manual_seed(21),
                                  total_iters=100, device=dev)
    step0 = make_train_step(cfg0, model0, None, total_iters=100)
    hist0 = []
    for b in batches0:
        _, m = step0(state0, b)
        hist0.append({k: float(v) for k, v in m.items()})
    finite_terms(hist0, "RW step 0")
    saved = R.export_state(state0.reg_state, state0.params)
    assert set(saved) == {"score", "fisher"}
    prev_sd = {k: v.clone() for k, v in model0.state_dict().items()}
    del model0, state0, step0
    torch.cuda.empty_cache()

    model = make_model(cfg1)
    model_old = make_model(cfg1, cfg1.classes_per_step[:-1]).to(
        device=dev, memory_format=torch.channels_last)
    state, old_vars = build_train_state(
        cfg1, model, torch.Generator().manual_seed(22), total_iters=100,
        prev_model_state=prev_sd, prev_reg_saved=saved, device=dev)
    rs = state.reg_state
    assert rs.penalize and float(rs.penalty_w["cls_1.weight"].abs().sum()) \
        == 0
    step = make_train_step(cfg1, model, model_old, total_iters=100)
    snap = snapshot(state, model)
    hist1 = []
    for b in batches:
        _, m = step(state, b, old_vars)
        hist1.append({k: float(v) for k, v in m.items()})
    counts = kernel_counts()
    finite_terms(hist1, "RW step 1")
    assert hist1[0]["l_reg"] == 0.0 and all(
        m["l_reg"] > 0 for m in hist1[1:]), hist1
    n = 2 * FAMILY_ITERS
    assert counts["fused_loss_fwd"] == counts["fused_loss_bwd"] == n, counts
    assert counts["contrastive_pass1"] == counts["fused_argmax"] == 0, \
        counts
    restore(state, model, snap)
    bundle = make_train_bundle(cfg1, model, model_old, total_iters=100,
                               k=FAMILY_ITERS)
    bits = bits_eager_vs_bundle(step, bundle, FAMILY_ITERS, state, model,
                                batches, old_vars, {"bundle": "b"})
    for key in ("fused_loss_fwd", "fused_loss_bwd"):
        assert bits["launches_bundle"][key] == FAMILY_ITERS, bits
    out["rw"] = {"step0": hist0, "step1": hist1, "launches": counts,
                 "bundle": {k: v for k, v in bits.items()
                            if k != "eager_vs_eager_differs"},
                 "capture_s": bundle.capture.capture_s}
    log(f"[families] RW VOC 15-5s step 0 -> 1 at full width, 3 iterations "
        f"each: step 1 " + ", ".join(
            f"loss {m['loss']:.5f} l_reg {m['l_reg']:.6g}" for m in hist1)
        + f"; B1/B2 {counts['fused_loss_fwd']}/{counts['fused_loss_bwd']} "
        f"launches; bundle(k=3) vs eager: "
        + ("the same bits" if bits["exact"] else
           f"within the eager spread ({bits['nondeterministic_ops']}, "
           f"{bits['eager_vs_eager_differs']})"))
    del bundle, model, model_old, state, old_vars, step, snap
    torch.cuda.empty_cache()

    # LWF-MC: iCaRL's BCE criterion and term on the dense path
    cfg_l = C.make_config(**dict(TRAIN, method="LWF-MC"))
    model, model_old, state, old_vars = build_train(dev, cfg_l, prev_sd)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    zero_kernel_counts()
    _, m = make_train_step(cfg_l, model, model_old, total_iters=100)(
        state, batches[0], old_vars)
    m = {k: float(v) for k, v in m.items()}
    counts = kernel_counts()
    finite_terms([m], "LWF-MC")
    assert m["l_icarl"] > 0 and m["loss"] > 0, m
    assert set(counts.values()) == {0}, counts
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(before[k], p)]
    assert "cls_1.weight" in moved and len(moved) > 100, len(moved)
    assert "cls_0.weight" not in moved
    out["lwf_mc"] = {"metrics": m, "moved_parameters": len(moved)}
    log(f"[families] one LWF-MC step at full width (dense BCE, no fused "
        f"kernel): loss {m['loss']:.5f}, l_icarl {m['l_icarl']:.5f}, "
        f"{len(moved)} parameters moved, cls_0 frozen")
    del model, model_old, state, old_vars
    torch.cuda.empty_cache()
    out["rw_small"] = phase_rw_small(dev)
    return out


def phase_rw_small(dev) -> dict:
    """One f32 ResNet-50 RW step at 64x64, batch 2 (VOC 15-5s step 1, the
    penalty on: a seeded previous-step export, the parameters moved off the
    donor's by a seeded 1e-3 draw) on the card against the CPU, under
    phase 3b's card-vs-CPU bounds: loss terms and `l_reg` within 1e-4
    relative, the new classifier's gradient within 1e-3 of its largest
    entry, and its RW fisher (alpha g^2 + (1 - alpha) F) within 2e-3 of
    its largest entry (g^2 doubles the gradient's relative error)."""
    kw = dict(TRAIN, method="RW", backbone="resnet50", batch_size=2,
              crop_size=64, dtype="float32")
    cfg = C.make_config(**kw)
    step0 = calibrated_model("cpu", (16,), backbone="resnet50", size=64,
                             batch=2, seed=6)
    prev_sd = {k: v.clone() for k, v in step0.state_dict().items()}
    g = torch.Generator().manual_seed(8)
    saved = {name: {k: torch.rand(p.shape, generator=g) * 1e-2 for k, p in
                    step0.named_parameters()} for name in ("score",
                                                           "fisher")}
    noise = {k: torch.randn(p.shape, generator=g) * 1e-3
             for k, p in step0.named_parameters()}
    batch = train_batches(1, 2, 64, cfg.tot_classes, seed=71)[0]
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = make_model(cfg)
        model_old = make_model(cfg, cfg.classes_per_step[:-1]).to(
            device=d, memory_format=torch.channels_last)
        state, old_vars = build_train_state(
            cfg, model, torch.Generator().manual_seed(1), total_iters=100,
            prev_model_state=prev_sd, prev_reg_saved=saved, device=d)
        with torch.no_grad():
            for k, p in model.named_parameters():
                if k in noise:
                    p.add_(noise[k].to(d))
        before = kernel_counts()
        _, metrics = make_train_step(cfg, model, model_old, total_iters=100,
                                     device=d)(state, batch, old_vars)
        used = _delta(kernel_counts(), before)
        assert (used["fused_loss_fwd"], used["fused_loss_bwd"]) == (
            (1, 1) if d.type == "cuda" else (0, 0)), (name, used)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     torch.cat([model.cls_1.weight.grad.detach().cpu()
                                .flatten(),
                                model.cls_1.bias.grad.detach().cpu()]),
                     state.reg_state.fisher["cls_1.weight"].cpu().flatten())
    (tc, gc, fc), (tg, gg, fg) = out["cpu"], out["card"]
    assert tc["l_reg"] > 0, tc
    for k in ("loss", "l_reg", "loss_tot"):
        assert abs(tg[k] - tc[k]) <= 1e-4 * abs(tc[k]), (k, tg[k], tc[k])
    rel = float((gg - gc).abs().max() / gc.abs().max())
    rel_f = float((fg - fc).abs().max() / fc.abs().max())
    log(f"[families] f32 ResNet-50 RW step at 64x64, card (kernels) vs CPU "
        f"(plain): loss {tg['loss']:.6f} / {tc['loss']:.6f}, l_reg "
        f"{tg['l_reg']:.6g} / {tc['l_reg']:.6g}, new-classifier gradient "
        f"max rel err {rel:.3g} (bound 1e-3), its fisher {rel_f:.3g} "
        f"(bound 2e-3)")
    assert rel <= 1e-3, rel
    assert rel_f <= 2e-3, rel_f
    return {"grad_rel_err": rel, "fisher_rel_err": rel_f,
            "l_reg": [tg["l_reg"], tc["l_reg"]]}


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
# phase 3i: the end-to-end accuracy path
# ---------------------------------------------------------------------------

TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def functional_test(name):
    """The port's functional test module `tests/<name>.py`: its runs and
    bars are what phase 3i holds the card to (it imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TESTS_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONTRASTIVE = ("contrastive_pass1", "contrastive_pass2", "contrastive_bwd")
PATH_EPOCHS = 2   # epochs a step of the default run's 15-5s drive


def retention_run(dev, ret, epochs=None) -> dict:
    """The six-step VOC 15-5s `run-task` of UCD and FT through the port's
    CLI, with the JAX retention test's argument list less `--no_pallas`
    (the contrastive kernels on); `epochs` replaces the list's 25. Returns
    each method's per-step curve, each step's launches and the run's."""
    from ucd_torch import cli as CLI
    t0, before, by_step, curves = time.perf_counter(), kernel_counts(), {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for method in ("UCD", "FT"):
            logdir = os.path.join(tmp, f"logs_{method}")
            args = ret.run_task_args(method, logdir,
                                     os.path.join(tmp, f"ckpt_{method}"))
            args.remove("--no_pallas")
            if epochs is not None:
                args[args.index("--epochs") + 1] = str(epochs)
            with ExperimentWatch() as watch, \
                    contextlib.redirect_stdout(io.StringIO()):
                assert CLI.main(args + ["--device", dev.type]) == 0
            by_step.update({(method, step): r["launches"]
                            for step, r in watch.steps.items()})
            curves[method] = ret._per_step_breakdown(ret.csv_path(logdir))
    return {"curves": curves, "by_step": by_step,
            "seconds": time.perf_counter() - t0,
            "launches": _delta(kernel_counts(), before)}


def check_retention_launches(by_step) -> None:
    """B1, B2 and B6 in every step of both methods; the f32 variants of
    B3-B5 in UCD's steps 1-5 only, in no FT step."""
    assert set(by_step) == {(m, s) for m in ("UCD", "FT")
                            for s in range(6)}, sorted(by_step)
    for (method, step), d in by_step.items():
        for k in CONTRASTIVE:
            assert (d[k] > 0) == (method == "UCD" and step > 0), (
                method, step, k, d)
            assert d[k + "_mma"] == 0, (method, step, k, d)
        assert d["fused_loss_fwd"] > 0 and d["fused_loss_bwd"] > 0, d
        assert d["fused_argmax"] > 0, (method, step, d)


def phase_accuracy_path(dev) -> dict:
    """This slice's path in the default run: the six-step VOC 15-5s
    `run-task` of UCD and FT at the JAX retention test's sizes with the
    kernels on, cut to PATH_EPOCHS epochs a step (counts set to 0 just
    before, read just after). It checks the path, not the JAX bars: each
    step's launches, six rows a method, each reading a finite IoU in
    [0, 1] (the new classes none at step 0). At these sizes the bars' verdict
    moves with cuDNN's reduction order from run to run; `--only bars`
    judges them (phase_accuracy)."""
    ret = functional_test("test_torch_retention_curve")
    zero_kernel_counts()
    r = retention_run(dev, ret, PATH_EPOCHS)
    curves = r["curves"]
    log(f"[accuracy-path] VOC 15-5s run-task, ResNet-50 64x64 os 8, f32, "
        f"kernels on, {PATH_EPOCHS} epochs a step; {r['seconds']:.1f} s\n"
        + ret.retention_table(curves["UCD"], curves["FT"]))
    log(f"[accuracy-path] launches: {json.dumps(r['launches'])}")
    check_retention_launches(r["by_step"])
    for method, curve in curves.items():
        assert [row[0] for row in curve] == list(range(6)), (method, curve)
        for step, old, new, every in curve:
            for v in (old, every) + ((new,) if step else ()):
                assert math.isfinite(v) and 0.0 <= v <= 1.0, (
                    method, step, old, new, every)
            assert step or math.isnan(new), (method, step, new)
    return {"retention": ret.retention_record(curves["UCD"], curves["FT"]),
            "epochs": PATH_EPOCHS, "seconds": r["seconds"],
            "launches": r["launches"],
            "launches_by_step": {f"{m} {s}": d for (m, s), d in
                                 sorted(r["by_step"].items())}}


def phase_accuracy(dev) -> dict:
    """`--only bars`: the port learns and keeps old classes on the card,
    held to the JAX tests' bars at their sizes with the kernels on, under
    deterministic cuDNN and torch algorithms, so that a run gives one
    verdict that the next run repeats: (a) the learnability run
    (tests/test_torch_learnability.py), (b) the incremental-retention run
    with the contrastive kernels (tests/test_torch_incremental_
    learnability.py), (c) the six-step VOC 15-5s `run-task`, UCD and FT,
    with the JAX test's argument list less `--no_pallas`
    (tests/test_torch_retention_curve.py). The counts are set to 0 before
    (a) and read after (c): B1, B2 and B6 launch in each run, the f32
    variants of B3-B5 in (b) and in UCD's steps 1-5 of (c), in no FT
    step and never on the tensor cores (the runs are float32). Every
    reading is logged before any bar is judged; a missed bar fails."""
    learn = functional_test("test_torch_learnability")
    incr = functional_test("test_torch_incremental_learnability")
    ret = functional_test("test_torch_retention_curve")
    seconds, counts = {}, {}
    zero_kernel_counts()
    with deterministic() as caught:
        t0, before = time.perf_counter(), kernel_counts()
        a = learn.run_learnability(dev)
        seconds["a"], counts["a"] = time.perf_counter() - t0, _delta(
            kernel_counts(), before)
        log(f"[accuracy] (a) learnability: loss {a['first_loss']:.4f} -> "
            f"{a['last_loss']:.4f} (bar < 0.3x: "
            f"{0.3 * a['first_loss']:.4f}), mIoU {a['miou']:.4f} "
            f"(bar > 0.6); {seconds['a']:.1f} s")

        t0, before = time.perf_counter(), kernel_counts()
        b = incr.run_incremental(dev, use_pallas_contrastive=True)
        seconds["b"], counts["b"] = time.perf_counter() - t0, _delta(
            kernel_counts(), before)
        old = (b["iou1"][1] + b["iou1"][2]) / 2
        log(f"[accuracy] (b) incremental: step 0 IoU {b['iou0']} (bars > "
            f"0.3); step 1 IoU {b['iou1']}, old mean {old:.4f} (bar > "
            f"0.2), old min {min(b['iou1'][1], b['iou1'][2]):.4f} (> 0.1), "
            f"new {b['iou1'][3]:.4f} (> 0.25); lkd {b['lkd']:.4g}, l_con "
            f"{b['l_con']:.4g}; {seconds['b']:.1f} s")

        c = retention_run(dev, ret)
    curves, by_step = c["curves"], c["by_step"]
    seconds["c"], counts["c"] = c["seconds"], c["launches"]
    log(f"[accuracy] nondeterministic ops: {nondeterministic_ops(caught)}")
    log("[accuracy] (c) VOC 15-5s run-task, ResNet-50 64x64 os 8, f32, "
        f"kernels on; {seconds['c']:.1f} s\n"
        + ret.retention_table(curves["UCD"], curves["FT"]))
    log("[accuracy] RETENTION " + json.dumps(
        ret.retention_record(curves["UCD"], curves["FT"])))
    bars = ret.retention_bars(curves["UCD"], curves["FT"])
    log("[accuracy] (c) bars (value, margin): " + json.dumps(bars))
    total = kernel_counts()
    log(f"[accuracy] launches over the phase: {json.dumps(total)}")

    # the kernels of each run, and of each step of (c)
    for run in ("a", "b", "c"):
        for k in ("fused_loss_fwd", "fused_loss_bwd", "fused_argmax"):
            assert counts[run][k] > 0, (run, k, counts[run])
    for k in CONTRASTIVE:
        assert counts["a"][k] == 0 and counts["b"][k] > 0, (k, counts)
        assert total[k + "_mma"] == 0, (k, total)
    check_retention_launches(by_step)

    # every bar, judged after the three runs are logged; a miss fails
    missed = []
    for run, check in (
            ("(a)", lambda: learn.check_learnability(a)),
            ("(b)", lambda: incr.check_incremental(b)),
            ("(c)", lambda: ret.check_retention(curves["UCD"],
                                                curves["FT"]))):
        try:
            check()
        except AssertionError as e:
            missed.append(f"{run} {e}")
    log(json.dumps({"accuracy_bars": {
        "learnability": a, "incremental": b,
        "retention": ret.retention_record(curves["UCD"], curves["FT"]),
        "retention_bars": bars, "seconds": seconds, "launches": total,
        "launches_by_run": counts, "missed": missed}}))
    assert not missed, "JAX bars missed: " + "; ".join(missed)


# `--only accuracy`: the retention curve at full width, plain and under
# bf16_norm, through `Experiment` step by step as `run-task` drives it
FULL_TASK = dict(dataset="voc", task="15-5s", overlap=True,
                 backbone="resnet101", output_stride=16, crop_size=SIZE,
                 batch_size=BATCH, dtype="bfloat16", pretrained=False)
FULL_IMAGES = 48               # --synthetic_learnable 48
FULL_LR = (0.01, 0.001)        # examples/voc_15-5s_ucd.sh: step 0, after
FULL_EPOCHS = (5, 10, 15, 20, 30, 40, 60)   # step 0's candidates
STEP0_BAR = 0.3   # the JAX test's step-0 old-class bar


def full_width_step(dev, root, method, step, epochs, bf16_norm) -> dict:
    """One step of VOC 15-5s at full width through `Experiment`, as
    `run-task` runs it (validate and checkpoint once, at the step's end);
    its class IoU goes into the curve's results.csv."""
    from ucd_torch import cli as CLI
    from ucd_torch.engine.experiment import Experiment
    from ucd_torch.utils.reporting import write_step_csv
    cfg = C.make_config(
        step=step, method=method, lr=FULL_LR[min(step, 1)], epochs=epochs,
        bf16_norm=bf16_norm, val_interval=epochs, ckpt_interval=epochs,
        logdir=os.path.join(root, "logs"), ckpt_dir=os.path.join(root, "ckpt"),
        **FULL_TASK)
    base_train, base_val = CLI._make_bases(cfg, 0, FULL_IMAGES)
    exp = Experiment(cfg, base_train=base_train, base_val=base_val,
                     device=dev)
    try:
        exp.run()
        score = exp.final_test()
    finally:
        exp.close()
    write_step_csv(os.path.join(root, "logs", cfg.task_name, cfg.name,
                                "results.csv"), step, score["Class IoU"])
    old = [v for c, v in score["Class IoU"].items()
           if 1 <= c <= 15 and v != "X"]
    return {"old": float(np.mean(old)),
            "img_per_s": exp.last_train_metrics["images_per_s"],
            "iters": len(exp.train_loader)}


def full_width_curve(dev, root, method, epochs, bf16_norm,
                     first=0) -> dict:
    """Steps `first`..5 of the curve in `root`; a `first` of 1 continues
    from the step-0 checkpoint and results.csv row already there."""
    ret = functional_test("test_torch_retention_curve")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps = [full_width_step(dev, root, method, s, epochs, bf16_norm)
             for s in range(first, 6)]
    torch.cuda.synchronize()
    curve = ret._per_step_breakdown(os.path.join(
        root, "logs", "15-5s-voc", "Experiment", "results.csv"))
    return {"curve": curve, "seconds": time.perf_counter() - t0,
            "first_step": first,
            "img_per_s": [s["img_per_s"] for s in steps],
            "iters_per_epoch": [s["iters"] for s in steps],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_accuracy_full(dev, where) -> dict:
    """The VOC 15-5s retention curve at full width (ResNet-101, os 16,
    512x512, batch 8, the bf16 policy, 48 learnable synthetic images, no
    pretrained body, lr 0.01 at step 0 and 0.001 after, B3-B5 on the
    tensor cores), UCD and FT, plain and under `bf16_norm`. The epoch
    count is fixed first, from plain UCD step 0 alone: the fewest of
    FULL_EPOCHS at which its old-class mIoU clears the JAX bar (> 0.3);
    that step-0 run is step 0 of the plain UCD curve. Then the JAX test's
    bars for each option; every curve is logged before any bar is judged,
    and a missed bar fails the run."""
    ret = functional_test("test_torch_retention_curve")
    sweep, epochs, runs = [], None, {}
    with tempfile.TemporaryDirectory() as tmp:
        for e in FULL_EPOCHS:
            root = os.path.join(tmp, f"sweep_{e}")
            r = full_width_step(dev, root, "UCD", 0, e, False)
            sweep.append((e, r["old"]))
            log(f"[accuracy-full] step 0, {e} epochs: old-class mIoU "
                f"{r['old']:.4f}, {r['img_per_s']:.1f} img/s")
            if r["old"] > STEP0_BAR:
                epochs = e
                break
            shutil.rmtree(root)
        assert epochs is not None, (
            f"step 0 never cleared {STEP0_BAR}: {sweep}")
        log(f"[accuracy-full] epochs fixed from step 0 alone: {epochs}")
        for bf16_norm in (False, True):
            for method in ("UCD", "FT"):
                reuse = not bf16_norm and method == "UCD"
                with tempfile.TemporaryDirectory() as own:
                    runs[bf16_norm, method] = full_width_curve(
                        dev, root if reuse else own, method, epochs,
                        bf16_norm, first=1 if reuse else 0)
                r = runs[bf16_norm, method]
                log(f"[accuracy-full] bf16_norm={bf16_norm} {method} (steps "
                    f"{r['first_step']}-5): {r['seconds']:.1f} s, img/s "
                    f"{r['img_per_s']}, peak {r['peak_mem_gb']:.2f} GB")
    out, failed = {"card": where, "epochs": epochs, "step0_sweep": sweep}, []
    for bf16_norm in (False, True):
        ucd, ft = runs[bf16_norm, "UCD"], runs[bf16_norm, "FT"]
        tag = "bf16_norm" if bf16_norm else "plain"
        log(f"[accuracy-full] {tag} ({epochs} epochs a step)\n"
            + ret.retention_table(ucd["curve"], ft["curve"]))
        out[tag] = {"retention": ret.retention_record(ucd["curve"],
                                                      ft["curve"]),
                    **{m: {k: v for k, v in runs[bf16_norm, m].items()
                           if k != "curve"} for m in ("UCD", "FT")}}
    for bf16_norm, tag in ((False, "plain"), (True, "bf16_norm")):
        ucd = runs[bf16_norm, "UCD"]["curve"]
        ft = runs[bf16_norm, "FT"]["curve"]
        out[tag]["bars"] = ret.retention_bars(ucd, ft)
        log(f"[accuracy-full] {tag} bars: {json.dumps(out[tag]['bars'])}")
        try:
            ret.check_retention(ucd, ft)
        except AssertionError as e:
            failed.append(f"{tag}: {e}")
    log(json.dumps({"accuracy_full": out}))
    assert not failed, failed
    return out


# ---------------------------------------------------------------------------
# phase 3g: the host ops' binding, the model's execution options, GroupNorm
# ABN and the off-path modules
# ---------------------------------------------------------------------------

VOC_HW = (375, 500)      # VOC's most common source size
HOST_BATCHES = 4         # timed batches a side, taken in turns
OPTIONS = ("remat", "remat_early", "stem_s2d", "bf16_norm",
           "bf16_norm_early")
OPTION_STEPS = 12        # captured remat steps held against eager ones
A10_TOL = 1e-4           # card (true f32) against the CPU, of max|ref|


@contextlib.contextmanager
def host_ops(native: bool):
    """The data pipeline's host ops through the C++ build (`native`) or
    their numpy/PIL versions, within a block."""
    from ucd_torch.data import native as N
    saved = N._LIB
    if not native:
        N._LIB = False
    try:
        yield
    finally:
        N._LIB = saved


def check_host_ops() -> dict:
    """The C++ build against the numpy/PIL versions at VOC's shapes: 375x500
    sources, random crops resized to 512x512 with and without the flip,
    whole-image resizes (geometry exact), the normalize (within 1e-6: one
    FMA a value against (x / 255 - mean) / std), the remap into int32 and
    the confusion update (exact)."""
    from ucd_torch.data import native as N
    from ucd_torch.data import transforms as DT

    prebuilt = N.library_path().exists()
    t0 = time.perf_counter()
    assert N.has_native(), "the host ops did not build"
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(7)
    n_geo = 0
    for i in range(8):
        img = make_images(1, *VOC_HW, seed=200 + i)[0]
        lbl = make_labels(1, *VOC_HW, 21, seed=300 + i)[0]
        ch, cw = rs.randint(100, VOC_HW[0] + 1), rs.randint(100,
                                                             VOC_HW[1] + 1)
        crops = [(rs.randint(0, VOC_HW[0] - ch + 1),
                  rs.randint(0, VOC_HW[1] - cw + 1), ch, cw), None]
        for crop in crops:
            for flip in (False, True):
                got = N.pil_resize_pair(img, lbl, SIZE, SIZE, crop, flip)
                with host_ops(False):
                    want = N.pil_resize_pair(img, lbl, SIZE, SIZE, crop,
                                             flip)
                for g, w in zip(got, want):
                    assert g.shape == w.shape and np.array_equal(g, w), (
                        i, crop, flip)
                n_geo += 1
        got = N.normalize_image(img, DT.IMAGENET_MEAN, DT.IMAGENET_STD)
        with host_ops(False):
            want = N.normalize_image(img, DT.IMAGENET_MEAN, DT.IMAGENET_STD)
        norm_err = float(np.abs(got - want).max())
        assert norm_err <= 1e-6, norm_err
    lut = np.arange(256, dtype=np.int32)
    lut[3] = 300
    got = N.remap_labels(lbl, lut)
    with host_ops(False):
        assert np.array_equal(got, N.remap_labels(lbl, lut))
    pred = rs.randint(0, 21, lbl.shape)
    hist = N.confusion_update(np.zeros((21, 21), np.int64), lbl, pred)
    with host_ops(False):
        assert np.array_equal(hist, N.confusion_update(
            np.zeros((21, 21), np.int64), lbl, pred))
    return {"build_s": build_s, "prebuilt": prebuilt,
            "geometry_cases": n_geo,
            "normalize_max_abs_diff": norm_err}


def time_host_ops() -> dict:
    """The train pipeline's host work a batch (8 VOC-sized sources -> random
    resized 512x512 crops with the flip, then the uint8 pass-through of
    device normalize, or the host normalize), through the C++ build and
    through the numpy/PIL versions, batches taken in turns."""
    from ucd_torch.data import transforms as DT

    srcs = [(make_images(1, *VOC_HW, seed=400 + i)[0],
             make_labels(1, *VOC_HW, 21, seed=500 + i)[0])
            for i in range(BATCH)]
    out = {}
    for device_normalize in (True, False):
        tf = DT.train_transform(SIZE, device_normalize)
        ms = {True: [], False: []}
        for b in range(HOST_BATCHES):
            for native in (True, False):
                rng = np.random.default_rng(b)
                with host_ops(native):
                    t0 = time.perf_counter()
                    for img, lbl in srcs:
                        tf(img, lbl, rng)
                    ms[native].append((time.perf_counter() - t0) * 1e3)
        key = "device_normalize" if device_normalize else "host_normalize"
        out[key] = {"native_ms_per_batch": ms[True],
                    "numpy_pil_ms_per_batch": ms[False]}
    return out


def time_loop_native(dev) -> dict:
    """PERF.md's experiment loop at steps_per_call 4 (a step-1 UCD
    `Experiment`, VOC 15-5, ResNet-101, batch 8, 512x512, bf16, 64
    synthetic images, three epochs of 8 iterations; its first epoch
    captures) with the host ops through the C++ build and through
    numpy/PIL, epochs taken in turns: img/s and the wait for the loader."""
    from ucd_torch.data import SyntheticSegmentation
    from ucd_torch.engine.experiment import Experiment

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(dataset="voc", task="15-5", backbone=TRAIN["backbone"],
                  crop_size=SIZE, batch_size=BATCH, lr=0.001, epochs=3,
                  pretrained=False, visualize=False, print_interval=1000,
                  logdir=os.path.join(tmp, "logs"),
                  ckpt_dir=os.path.join(tmp, "ckpt"))
        base0 = SyntheticSegmentation(n=BATCH, size=SIZE, n_classes=16,
                                      seed=1)
        exp0 = Experiment(C.make_config(step=0, method="FT", **kw),
                          base_train=base0, base_val=base0, device=dev)
        exp0.save(0, 0.0)
        exp0.close()
        del exp0
        base1 = SyntheticSegmentation(n=8 * BATCH, size=SIZE, n_classes=21,
                                      seed=2)
        cfg = C.make_config(step=1, method="UCD", steps_per_call=4, **kw)
        exps = {n: Experiment(cfg, base_train=base1, base_val=base1,
                              device=dev) for n in (True, False)}
        epochs = {True: [], False: []}
        for e in range(3):
            for native in (True, False):
                with host_ops(native):
                    epochs[native].append(exps[native].train_epoch(e))
        for exp in exps.values():
            exp.close()
        del exps
    torch.cuda.empty_cache()
    return {name: {"img_per_s": [e["images_per_s"] for e in epochs[n]],
                   "data_wait_s": [e["data_wait_s"] for e in epochs[n]],
                   "epoch_time_s": [e["epoch_time_s"] for e in epochs[n]]}
            for name, n in (("cpp", True), ("numpy_pil", False))}


def option_cfg(cfg, option):
    return cfg if option == "plain" else dataclasses.replace(
        cfg, **{option: True})


def option_side(dev, tr, option, batches, val, rounding_only=False) -> dict:
    """Phase 3b's model and variables under `option` ("plain": none) with
    a fresh optimizer: one eager step from that start under deterministic
    algorithms (its metrics and state after), one validate step, then
    img/s eager (windows of 4 steps) and captured (make_train_bundle(k=4),
    windows of 2 calls) with the peak memory of each, the device's busy
    time a step (torch.profiler over two eager steps), and for remat the
    12-step eager-vs-captured bit check. `rounding_only`: the plain step
    with cuDNN off instead, nothing else."""
    cfg = option_cfg(tr["cfg"], option)
    model, model_old, state, old_vars = build_train(dev, cfg,
                                                    tr["old_vars"])
    with torch.no_grad():
        model.load_state_dict(tr["model"].state_dict())
    before = snapshot(state, model)
    r = {}
    if rounding_only:
        with torch.backends.cudnn.flags(enabled=False):
            _, m = make_train_step(cfg, model, model_old, 100)(
                state, batches[0], old_vars)
        return {"before": before, "after": snapshot(state, model),
                "metrics": {k: float(v) for k, v in m.items()}}
    step = make_train_step(cfg, model, model_old, total_iters=100)
    with deterministic() as caught:
        _, m = step(state, batches[0], old_vars)
        torch.cuda.synchronize()
    r["nondeterministic_ops"] = nondeterministic_ops(caught)
    r["metrics"] = {k: float(v) for k, v in m.items()}
    r["before"], r["after"] = before, snapshot(state, model)
    hist, terms, _ = make_eval_step(cfg, model, model_old)(
        None, val, empty_confusion(cfg.tot_classes), old_vars)
    r["validate_loss"] = float(terms["loss"])
    assert int(hist.sum()) == int((val["label"] != 255).sum())
    if option == "remat":
        bundle = make_train_bundle(cfg, model, model_old, total_iters=100,
                                   k=BUNDLE_K)
        bits = bits_eager_vs_bundle(
            step, bundle, BUNDLE_K, state, model, batches[:OPTION_STEPS],
            old_vars, {"bundle": "b" * (OPTION_STEPS // BUNDLE_K)})
        for key in TRAIN_COUNTERS:
            assert bits["launches_bundle"][key] == OPTION_STEPS, bits
        r["bundle_bits"] = bits
        del bundle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r["eager_img_per_s_runs"] = img_per_s_windows(
        lambda: [step(state, batches[i], old_vars) for i in range(4)],
        4 * BATCH)
    r["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    r["busy_ms"] = busy_ms(lambda: step(state, batches[0], old_vars), 2)
    torch.cuda.reset_peak_memory_stats()
    bundle = make_train_bundle(cfg, model, model_old, total_iters=100,
                               k=BUNDLE_K)
    stack = stacked(batches[:BUNDLE_K])
    bundle(state, stack, old_vars)            # slot 0 eager, then capture
    r["capture_s"] = bundle.capture.capture_s
    r["captured_img_per_s_runs"] = img_per_s_windows(
        lambda: [bundle(state, stack, old_vars) for _ in range(2)],
        2 * BUNDLE_K * BATCH)
    r["peak_gb_captured"] = torch.cuda.max_memory_allocated() / 1e9
    r["reserved_gb_captured"] = torch.cuda.memory_reserved() / 1e9
    if option == "stem_s2d":
        r["serve"] = serve_s2d(model, dev)
    del bundle, step, model, model_old, state, old_vars
    gc.collect()              # the step's closures hold the model in cycles
    torch.cuda.empty_cache()
    return r


def serve_s2d(model, dev) -> dict:
    """The stem_s2d model exported (f32 npz) and served: load_inference
    builds the space-to-depth stem from the header, and its logits equal,
    within 1e-3 of max|ref|, those of the same npz with a plain stem."""
    from ucd_torch.models.resnet import S2DStemConv
    x = torch.from_numpy(make_images(2, SIZE, SIZE, seed=600)).to(
        dev).permute(0, 3, 1, 2)
    with tempfile.TemporaryDirectory() as tmp:
        meta = save_inference(model, os.path.join(tmp, "s2d.npz"),
                              export_dtype="float32")
        assert meta["stem_s2d"] is True
        served, _ = load_inference(meta["path"], device=dev)
        assert isinstance(served.body.mod1_conv1, S2DStemConv)
        plain = IncrementalSegmentationModel(
            served.classes, backbone=served.backbone,
            output_stride=served.output_stride,
            head_channels=served.head_channels,
            pooling_size=served.pooling_size).to(
                device=dev, memory_format=torch.channels_last).eval()
        plain.load_state_dict(served.state_dict())
        with torch.no_grad():
            got, want = served.forward_sem(x), plain.forward_sem(x)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-3, err
    return {"vs_plain_stem_logits_rel_err": err}


def check_a10_and_gn(dev) -> dict:
    """GroupNorm ABN, the v1 contrastive losses, Sinkhorn-Knopp and the
    non-local block on CUDA tensors against the CPU, in value and
    gradient, f32 (TF32 off): each value within A10_TOL of its largest
    entry, each gradient within A10_TOL of the call's largest gradient
    entry."""
    from ucd_torch.models import NonLocalBlock2D
    from ucd_torch.models.layers import ABN
    from ucd_torch.ops import (pixel_con_loss_v1, sinkhorn_knopp,
                               sup_con_loss)

    g = torch.Generator().manual_seed(17)

    def run(fn, inputs, modules=()):
        """fn on CPU and on card copies of `inputs` and `modules`; the
        largest error of its value and of every gradient (inputs and
        parameters; the loss of a tensor output weights it by a ramp)."""
        out = {}
        for d in ("cpu", dev):
            xs = [t.detach().clone().to(d).requires_grad_(
                t.is_floating_point()) for t in inputs]
            mods = [copy.deepcopy(m).to(d) for m in modules]
            y = fn(*xs, *mods)
            if y.ndim:
                y = y * torch.linspace(-1, 1, y.numel(),
                                       device=y.device).view_as(y)
            y.sum().backward()
            grads = [x.grad for x in xs if x.grad is not None]
            grads += [p.grad for m in mods for p in m.parameters()
                      if p.grad is not None]
            out[str(d)] = [y.detach().cpu()] + [t.cpu() for t in grads]
        # the value against its largest entry, every gradient against the
        # largest gradient entry of the call (the non-local block's phi
        # bias has a zero gradient in exact arithmetic)
        ref, got = out["cpu"], out[str(dev)]
        gmax = max(float(t.abs().max()) for t in ref[1:])
        worst = float((ref[0] - got[0]).abs().max()
                      / (ref[0].abs().max() + 1e-30))
        for a, b in zip(ref[1:], got[1:]):
            worst = max(worst, float((a - b).abs().max()) / gmax)
        return worst

    feats = torch.nn.functional.normalize(
        torch.randn(256, 2, 128, generator=g), dim=-1)
    labels = torch.randint(0, 16, (256,), generator=g)
    pix = torch.nn.functional.normalize(
        torch.randn(2048, 1, 256, generator=g), dim=-1)
    pix_lab = torch.randint(0, 17, (2048,), generator=g)
    logits = torch.randn(4096, 128, generator=g) * 0.2
    gn = ABN(256, norm_type="gn").train()
    with torch.no_grad():
        gn.gn.weight.uniform_(0.5, 1.5, generator=g)
        gn.gn.bias.normal_(generator=g)
    nl = NonLocalBlock2D(2048).init_weights(g).train()
    with torch.no_grad():
        nl.W_bn.weight.uniform_(0.5, 1.5, generator=g)
    res = {
        "groupnorm_abn": run(lambda x, m: m(x), [
            torch.randn(2, 256, 128, 128, generator=g)], [gn]),
        "sup_con_loss_all": run(lambda f, lab: sup_con_loss(f, lab),
                                [feats, labels]),
        "sup_con_loss_one_simclr": run(
            lambda f: sup_con_loss(f, contrast_mode="one"), [feats]),
        "pixel_con_loss_v1": run(
            lambda f, lab: pixel_con_loss_v1(f, lab, temperature=0.1),
            [pix, pix_lab]),
        "sinkhorn_knopp": run(lambda q: sinkhorn_knopp(q), [logits]),
        # features at 0.2 a channel: the attention logits, sums over 1024
        # channels, then have a spread of ~1.3 (at 1 a channel the softmax
        # is a hard argmax that any rounding flips)
        "nonlocal_block": run(lambda x, m: m(x), [
            torch.randn(2, 2048, SIZE // 16, SIZE // 16, generator=g) * 0.2],
            [nl]),
    }
    for k, v in res.items():
        assert v <= A10_TOL, (k, v)
    return res


def phase_exec_options(dev, tr, where) -> dict:
    """Phase 3g: (a) the host ops' C++ build on this host, held against the
    numpy/PIL versions, its host time a batch and the experiment loop at
    steps_per_call 4 with and without it; (b) one full-width UCD step
    (phase 3b's model and variables, VOC 15-5s step 1, ResNet-101, batch 8,
    512x512, bf16) under each execution option beside the plain step, with
    the kernels' launch counts set to 0 just before the option steps and
    read just after: remat and remat_early with the plain step's bits
    (under deterministic algorithms) or within twice a rounding-only
    change (the plain step with cuDNN off), stem_s2d within twice that
    change, bf16_norm and bf16_norm_early within phase 3b's bf16 bound or
    twice that change; peak memory and eager / captured img/s of each, 12
    captured remat steps bit for bit against 12 eager ones, the stem_s2d
    model exported and served; (c) GroupNorm ABN and the off-path modules
    on the card against the CPU."""
    out = {"host_ops": check_host_ops()}
    out["host_ops"]["timing"] = time_host_ops()
    out["loop_steps_per_call_4"] = time_loop_native(dev)
    h, lp = out["host_ops"], out["loop_steps_per_call_4"]
    log("[3g] host ops " + ("found built" if h["prebuilt"] else
                             f"built in {h['build_s']:.2f} s")
        + f", {h['geometry_cases']} "
        f"VOC-shaped crop/resize/flip cases equal to PIL, normalize within "
        f"{h['normalize_max_abs_diff']:.3g} of numpy; host ms a batch "
        f"(C++ / numpy+PIL): " + "; ".join(
            f"{k} {json.dumps([round(x, 2) for x in v['native_ms_per_batch']])}"
            f" / {json.dumps([round(x, 2) for x in v['numpy_pil_ms_per_batch']])}"
            for k, v in h["timing"].items())
        + f"; loop at steps_per_call 4 img/s (C++ / numpy+PIL): "
        f"{json.dumps(lp['cpp']['img_per_s'])} / "
        f"{json.dumps(lp['numpy_pil']['img_per_s'])}, loader wait s "
        f"{json.dumps(lp['cpp']['data_wait_s'])} / "
        f"{json.dumps(lp['numpy_pil']['data_wait_s'])}")

    cfg = tr["cfg"]
    batches = train_batches(OPTION_STEPS, BATCH, SIZE, cfg.tot_classes,
                            seed=170)
    val = train_batches(1, BATCH, SIZE, cfg.tot_classes, seed=190)[0]
    rounding = option_side(dev, tr, "plain", batches, val,
                           rounding_only=True)
    sides, devs = {}, {}
    # ---- this phase's path: counts set to 0 here, read right after it
    zero_kernel_counts()
    for option in ("plain",) + OPTIONS + ("plain_again",):
        s = sides[option] = option_side(dev, tr, option.replace("_again", ""),
                                        batches, val)
        if option != "plain":
            # against the plain step from the same start; the snapshots
            # go, so that no side's peak memory holds an earlier one's
            devs[option] = dp_deviation(sides["plain"]["before"],
                                        (sides["plain"]["metrics"],
                                         sides["plain"]["after"]),
                                        (s["metrics"], s.pop("after")))
            del s["before"]
        log(f"[3g] {option}: eager img/s "
            f"{json.dumps(s['eager_img_per_s_runs'])}, captured"
            f" (K={BUNDLE_K}) {json.dumps(s['captured_img_per_s_runs'])}"
            f", peak GB eager {s['peak_gb_eager']:.2f} / captured "
            f"{s['peak_gb_captured']:.2f}, device busy a step "
            f"{s['busy_ms']:.2f} ms")
    counts = kernel_counts()
    # ----------------------------------------------------------------
    n_sides = len(OPTIONS) + 2
    for key in TRAIN_COUNTERS:
        assert counts[key] > 0, (key, counts)
    assert counts["fused_argmax"] == n_sides, counts
    plain = sides["plain"]
    exact = not plain["nondeterministic_ops"] and \
        devs["plain_again"]["bits_equal"]
    rnd = dp_deviation(plain["before"], (plain["metrics"], plain["after"]),
                       (rounding["metrics"], rounding["after"]))
    del plain["before"], plain["after"], rounding
    out["rounding_only"] = rnd
    out["deterministic_plain_bits_equal"] = exact
    out["launches"] = counts
    for option in OPTIONS:
        s = sides[option]
        dv = devs[option]
        if option in ("remat", "remat_early") and exact:
            assert dv["bits_equal"], (option, dv)
        else:
            check_dp_deviation(dv, rnd, option)
        out[option] = {
            "vs_plain": dv,
            **{k: s[k] for k in ("eager_img_per_s_runs",
                                 "captured_img_per_s_runs", "peak_gb_eager",
                                 "peak_gb_captured", "reserved_gb_captured",
                                 "busy_ms", "capture_s", "validate_loss")}}
        if "serve" in s:
            out[option]["serve"] = s["serve"]
        if "bundle_bits" in s:
            b = s["bundle_bits"]
            out[option]["bundle_bits"] = {
                k: b[k] for k in ("exact", "n_tensors", "n_steps",
                                  "nondeterministic_ops")}
        log(f"[3g] {option} against the plain step: loss terms "
            f"{dv['terms_rel_err']:.3g}, update {dv['update_rel_err']:.3g}, "
            f"worst tensor {dv['worst_update_err']:.3g}, bits equal "
            f"{dv['bits_equal']}")
    for option in ("plain", "plain_again"):
        out[option] = {k: sides[option][k] for k in (
            "eager_img_per_s_runs", "captured_img_per_s_runs",
            "peak_gb_eager", "peak_gb_captured", "reserved_gb_captured",
            "busy_ms", "capture_s")}
    b = out["remat"]["bundle_bits"]
    log(f"[3g] {b['n_steps']} remat steps eager and through "
        f"make_train_bundle(k={BUNDLE_K}): "
        + ("the same bits in all state tensors and per-step metrics"
           if b["exact"] else "within two eager runs' spread")
        + f"; the plain step with cuDNN off moves it {json.dumps(rnd)}; "
        f"launches {json.dumps(counts)}")
    out["a10_gn_card_vs_cpu"] = check_a10_and_gn(dev)
    log(f"[3g] GroupNorm ABN and the off-path modules, card vs CPU (max err "
        f"of the largest entry, bound {A10_TOL}): "
        f"{json.dumps(out['a10_gn_card_vs_cpu'])}")
    return out


# ---------------------------------------------------------------------------
# phase 3h: two gloo ranks on one card: the 1-D data axis and the 1 x 2 mesh
# ---------------------------------------------------------------------------

MESH2D_MIN_SIZE = 256      # the JAX package's `channel_sharding` default
MESH2D_TIMED_STEPS = 2     # host-staged (gloo) steps timed a rank


MESH2D_NAN_PARAM = "body.mod4_block1.conv2.weight"   # 256 outputs: sharded
# phase 2's rule for B6 (gap below which two argmaxes may differ, rate)
ARGMAX_TIES = {"bfloat16": (0.08, 2e-2), "float32": (1e-4, 1e-3)}


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def ewc_cfg(cfg):
    """`cfg` under the EWC regularizer, at the EWC preset's importance."""
    return dataclasses.replace(cfg, regularizer="ewc", reg_importance=500.0)


def ewc_export(model, old_vars, seed=171) -> dict:
    """A seeded EWC export (the previous step's fisher) over the donor's
    parameters, on the host."""
    g = torch.Generator().manual_seed(seed)
    return {"fisher": {k: torch.rand(p.shape, generator=g)
                       for k, p in model.named_parameters()
                       if k in old_vars}}


def ewc_state(cfg, model, old_vars, export):
    """The EWC state of `model` from `export`, anchored at the donor's
    parameters; its penalty weights normalized whole."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return R.init_reg_state(
        "ewc", params,
        old_params={k: v for k, v in old_vars.items() if k in params},
        saved=export, alpha=cfg.reg_alpha, iterations=cfg.reg_iterations,
        normalize=cfg.reg_normalize)


def validate_ref(cfg, model, model_old, old_vars, batch) -> dict:
    """The plain validate step on `batch`: the confusion matrix, the loss,
    the predictions and, for phase 2's tie rule, the top-2 gap of the
    upsampled logits at each pixel; then the same step with cuDNN off (a
    rounding-only change): its predictions and loss."""
    dev = next(model.parameters()).device
    step = make_eval_step(cfg, model, model_old, device=dev)
    hist, terms, preds = step(None, batch,
                              empty_confusion(cfg.tot_classes, dev),
                              old_vars)
    with torch.backends.cudnn.flags(enabled=False):
        _, alt_terms, alt_preds = step(
            None, batch, empty_confusion(cfg.tot_classes, dev), old_vars)
    x = torch.from_numpy(batch["image"]).to(dev).permute(0, 3, 1, 2)
    with torch.no_grad():
        up = F.interpolate(model.forward_sem(x).float(),
                           size=batch["label"].shape[1:], mode="bilinear",
                           align_corners=False)
        top2 = up.topk(2, dim=1).values
    return {"hist": hist.cpu(), "loss": float(terms["loss"]),
            "preds": preds.cpu(), "gap": (top2[:, 0] - top2[:, 1]).cpu(),
            "alt_preds": alt_preds.cpu(), "alt_loss": float(alt_terms["loss"])}


def _argmax_diff(preds, ref) -> tuple:
    """(mismatched pixels, their largest top-2 gap under the plain
    logits, their rate) of `preds` against the plain validate step's."""
    mism = preds != ref["preds"]
    n_bad = int(mism.sum())
    return (n_bad, float(ref["gap"][mism].max()) if n_bad else 0.0,
            n_bad / mism.numel())


def check_mesh_validate(v, ref, batch, dtype) -> dict:
    """A mesh rank's validate step (`v`) against the plain one (`ref`):
    the confusion matrix counts each labelled pixel once; predictions
    differ at a rate below phase 2's bound for B6 (ARGMAX_TIES), each at
    a top-2 gap of the plain logits below phase 2's gap or twice the
    largest gap a rounding-only change of the plain step flips (at bf16
    the convolutions' own rounding moves the logits, not only the
    upsample's), the confusion matrix by at most those pixels; the loss
    within 3b's bf16 bound or twice the rounding-only change's."""
    hist = v["hist"].cpu()
    labelled = int((batch["label"] != 255).sum())
    assert int(hist.sum()) == labelled, (int(hist.sum()), labelled)
    gap_tol, rate_tol = ARGMAX_TIES[dtype]
    _, alt_gap, alt_rate = _argmax_diff(ref["alt_preds"], ref)
    n_bad, worst, rate = _argmax_diff(v["preds"].cpu(), ref)
    assert worst < max(gap_tol, 2 * alt_gap) and rate < rate_tol, (
        dtype, n_bad, worst, rate, alt_gap, alt_rate)
    hist_diff = int((hist - ref["hist"]).abs().sum())
    assert hist_diff <= 2 * n_bad, (hist_diff, n_bad)
    loss_err = abs(v["terms"]["loss"] - ref["loss"]) / abs(ref["loss"])
    alt_err = abs(ref["alt_loss"] - ref["loss"]) / abs(ref["loss"])
    assert loss_err <= max(DP_VS_PLAIN[0], 2 * alt_err), (
        dtype, v["terms"], ref["loss"], alt_err)
    return {"labelled_pixels": labelled, "mismatches": n_bad,
            "mismatch_rate": rate, "worst_gap": worst,
            "rounding_only_gap": alt_gap, "rounding_only_rate": alt_rate,
            "hist_l1_diff": hist_diff, "loss_rel_err": loss_err,
            "rounding_only_loss_err": alt_err,
            "loss": v["terms"]["loss"], "loss_plain": ref["loss"]}


def state_bytes(state, model, old_vars, shell=None) -> int:
    """Bytes of the parameters, the momentum and the donor's variables,
    plus what the donor `shell` still holds on a device (on the 2-D mesh,
    once the step is built: nothing, it lies on the meta device)."""
    tensors = [*model.parameters(), *state.opt_state["trace"].values(),
               *old_vars.values()]
    if shell is not None:
        tensors += [t for t in [*shell.parameters(), *shell.buffers()]
                    if t.device.type != "meta"]
    return sum(t.numel() * t.element_size() for t in tensors)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _rank_state(cfg, start, dev, export=None):
    """A rank's full state of `cfg` from the start the parent saved (its
    model's variables and the donor's) with a fresh optimizer, under
    `export` an EWC state from it: (model, donor shell, state, donor
    variables)."""
    model = make_model(cfg)
    model.init_weights = lambda generator: model  # loaded below
    model_old = make_model(cfg, cfg.classes_per_step[:-1]).to(
        device=dev, memory_format=torch.channels_last)
    state, old_vars = build_train_state(
        cfg, model, torch.Generator(), total_iters=100,
        prev_model_state=start["old"], device=dev)
    with torch.no_grad():
        model.load_state_dict(start["model"])
    if export is not None:
        state.reg_state = ewc_state(cfg, model, old_vars, export)
    return model, model_old, state, old_vars


def _mesh_step(cfg, model, model_old, state, old_vars, batch) -> dict:
    """One train step on the mesh, the launch counts set to 0 just before
    and read just after: its metrics, launches and the state after (the
    model's and the momentum's shards)."""
    step = make_train_step(cfg, model, model_old, total_iters=100,
                           device=next(model.parameters()).device)
    zero_kernel_counts()
    _, m = step(state, batch, old_vars)
    counts = kernel_counts()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "launches": counts,
            "after": _cpu({k: v for k, v in snapshot(state, model).items()
                           if not k.startswith("reg.")})}


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def mesh2d_rank(rank, rdzv, work, device):
    """One of phase 3h's two gloo ranks on `device`, cuda:0 (gloo stages
    CUDA tensors through the host; one card cannot host two NCCL ranks;
    "cpu" rehearses the phase at a small size). For
    bf16 and then the f32 twin, from the start the parent saved: (a) the
    1-D step on this rank's 4 images; (b) the same start put on the 1 x 2
    mesh (`shard_train_state`, min_size 256): the validate step and one
    train step on all 8 images, each with the kernels' launch counts set
    to 0 just before it and read just after; at bf16, MESH2D_TIMED_STEPS
    more steps timed, then one `nan_guard` step with model rank 1's
    gradient of MESH2D_NAN_PARAM made NaN; (c) one EWC step from the
    start and the parent's export on the mesh. Then (d) one `bf16_norm`
    step on the mesh at bf16 and in the f32 twin. Saves each side's
    metrics, launches and state (rank 0's 1-D state; each rank's
    shards)."""
    from ucd_torch.engine.state import shard_train_state
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=rdzv,
                                         world_size=2, rank=rank)
    try:
        start = torch.load(os.path.join(work, "start.pt"),
                           map_location=dev, weights_only=False)
        batch = start["batch"]
        mesh = P.make_mesh_2d(1, 2)
        out = {"place": (mesh.data_index, mesh.model_index)}
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(start["cfg"], dtype=dtype)
            model, model_old, state, old_vars = _rank_state(
                cfg, start[dtype], dev)
            before = snapshot(state, model)
            step = make_train_step(cfg, model, model_old, total_iters=100,
                                   device=dev)
            t0 = time.perf_counter()
            _, m = step(state, P.shard_batch(batch), old_vars)
            _sync(dev)
            side = {"step_s_1d": time.perf_counter() - t0,
                    "metrics_1d": {k: float(v) for k, v in m.items()}}
            if rank == 0:
                side["after_1d"] = _cpu(snapshot(state, model))
            restore(state, model, before)
            del before
            state, old_vars = shard_train_state(state, old_vars, mesh,
                                                MESH2D_MIN_SIZE)
            eval_step = make_eval_step(cfg, model, model_old, device=dev)
            zero_kernel_counts()
            hist, terms, preds = eval_step(
                None, batch, empty_confusion(cfg.tot_classes, dev),
                old_vars)
            side["validate"] = {
                "launches": kernel_counts(), "hist": hist.cpu(),
                "preds": preds.cpu(),
                "terms": {k: float(v) for k, v in terms.items()}}
            step = make_train_step(cfg, model, model_old, total_iters=100,
                                   device=dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            _, m = step(state, batch, old_vars)
            counts = kernel_counts()
            _sync(dev)
            side.update(
                launches=counts, sharded=sorted(model.sharded),
                metrics_2d={k: float(v) for k, v in m.items()},
                after_2d=_cpu(snapshot(state, model)),
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else None),
                state_bytes=state_bytes(state, model, old_vars, model_old))
            if dtype == "bfloat16":
                times = []
                for _ in range(MESH2D_TIMED_STEPS):
                    _sync(dev)
                    t0 = time.perf_counter()
                    step(state, batch, old_vars)
                    _sync(dev)
                    times.append(time.perf_counter() - t0)
                side["step_s_2d"] = times
                side["nan_guard"] = _nan_guard_side(
                    cfg, model, model_old, state, old_vars, batch, mesh)
            del model, model_old, state, old_vars, step, eval_step
            _free(dev)
            cfg_e = ewc_cfg(cfg)
            model, model_old, state, old_vars = _rank_state(
                cfg_e, start[dtype], dev, start["ewc_export"])
            state, old_vars = shard_train_state(state, old_vars, mesh,
                                                MESH2D_MIN_SIZE)
            side["ewc"] = _mesh_step(cfg_e, model, model_old, state,
                                     old_vars, batch)
            out[dtype] = side
            del model, model_old, state, old_vars
            _free(dev)
        out["bf16_norm"] = {}
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(start["cfg"], bf16_norm=True,
                                      dtype=dtype)
            model, model_old, state, old_vars = _rank_state(
                cfg, start[dtype], dev)
            state, old_vars = shard_train_state(state, old_vars, mesh,
                                                MESH2D_MIN_SIZE)
            out["bf16_norm"][dtype] = _mesh_step(
                cfg, model, model_old, state, old_vars, batch)
            del model, model_old, state, old_vars
            _free(dev)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _nan_guard_side(cfg, model, model_old, state, old_vars, batch,
                    mesh) -> dict:
    """One `nan_guard` step on the mesh with model rank 1's gradient of
    MESH2D_NAN_PARAM (a sharded conv) made NaN, the launch counts set to
    0 just before and read just after: the count of skipped updates, and
    which of the parameters, momentum and applied-update count changed
    (none may: every rank skips; the BatchNorm statistics move in the
    forward, as in the JAX step, whose `apply_if_finite` guards the
    update)."""
    step = make_train_step(dataclasses.replace(cfg, nan_guard=True), model,
                           model_old, total_iters=100,
                           device=next(model.parameters()).device)
    param = dict(model.named_parameters())[MESH2D_NAN_PARAM]
    assert MESH2D_NAN_PARAM in model.sharded
    hook = param.register_hook(lambda g: torch.full_like(
        g, float("nan"))) if mesh.model_index == 1 else None
    before = snapshot(state, model)
    zero_kernel_counts()
    _, m = step(state, batch, old_vars)
    counts = kernel_counts()
    after = snapshot(state, model)
    if hook is not None:
        hook.remove()
    kept = [k for k in before if k not in ("step", "nonfinite")
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]
    return {"launches": counts, "kept": len(kept),
            "changed": [k for k in kept
                        if not torch.equal(before[k], after[k])],
            "nonfinite": int(state.opt_state["nonfinite"]),
            "loss_tot": float(m["loss_tot"])}


def unshard_snapshot(snaps, like, min_size) -> dict:
    """The full `snapshot` of a model group's shard snapshots (`snaps[i]`
    model rank i's): the model's and the momentum's tensors put back
    together (`unshard_state`; `like` is the model's full state dict), the
    counts model rank 0's."""
    from ucd_torch.engine.state import unshard_state
    out = dict(snaps[0])
    for prefix in ("model.", "trace."):
        names = [k[len(prefix):] for k in out if k.startswith(prefix)]
        full = unshard_state([{n: s[prefix + n] for n in names}
                              for s in snaps],
                             {n: like[n] for n in names}, min_size)
        out.update({prefix + n: v for n, v in full.items()})
    return out


def plain_and_rounding(cfg, model, model_old, state, old_vars, batch):
    """The plain step from the current state, and the same with cuDNN off
    (a rounding-only change); the state is restored after each:
    (metrics, state after) twice, and the plain step's peak GB."""
    dev = next(model.parameters()).device
    snap = snapshot(state, model)
    step = make_train_step(cfg, model, model_old, total_iters=100,
                           device=dev)
    out, peak = [], None
    for cudnn in (True, False):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # cuDNN off only for the second step: `cudnn.flags` would also turn
        # TF32 back on for the first
        with torch.backends.cudnn.flags(enabled=False) if not cudnn \
                else contextlib.nullcontext():
            _, m = step(state, batch, old_vars)
            _sync(dev)
        out.append(({k: float(v) for k, v in m.items()},
                    snapshot(state, model)))
        if cudnn and dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated() / 1e9
        restore(state, model, snap)
    return snap, out[0], out[1], peak


def phase_mesh2d(dev, tr, where) -> dict:
    """Phase 3h: two gloo ranks on cuda:0 (`mesh2d_rank`), from phase 3b's
    model and variables (VOC 15-5s step 1, ResNet-101, batch 8, 512x512)
    with a fresh schedule, at bf16 and in the f32 twin: (a) the 1-D data
    axis, 4 images a rank, and (b) the 1 x 2 data x model mesh, the wide
    convs' output channels sharded over the two ranks (min_size 256), on
    all 8 images: its validate step against the plain one
    (`check_mesh_validate`: each labelled pixel counted once, predictions
    by phase 2's tie rule, the loss within 3b's bf16 bound), and its
    train step; at bf16 a `nan_guard` step with a NaN gradient on model
    rank 1 only, which both ranks must skip; (c) an EWC step on the mesh
    against the plain EWC step; (d) a `bf16_norm` step on the mesh
    against the plain `bf16_norm` step, at bf16 and f32 compute (the f32
    side tells a fault from rounding). Each train step is held to its
    plain step by `check_dp_deviation` (the loss terms, the update overall
    and the worst tensor's, within DP_VS_PLAIN or twice a rounding-only
    change; EWC's penalty within DP_VS_PLAIN's terms bound); the mesh's
    replicated tensors and momentum must have the same bits on both
    ranks, B1 and B6 must launch once in its bf16 validate step and B1-B5
    once in each of its bf16 train steps, and each rank's bytes of
    parameters + momentum + donor, peak memory and seconds a step
    (host-staged, recorded, not judged) are reported."""
    import torch.multiprocessing as mp

    cfg, model, model_old = tr["cfg"], tr["model"], tr["model_old"]
    state, old_vars = tr["state"], tr["old_vars"]
    batch = train_batches(1, BATCH, SIZE, cfg.tot_classes, seed=170)[0]
    # a fresh optimizer on 3b's variables, as the ranks build it (and as
    # the f32 twin has); 3b's state is restored at the end
    entry = snapshot(state, model)
    with torch.no_grad():
        opt = state.opt_state
        for t in [*opt["trace"].values(), opt["count"], opt["nonfinite"],
                  state.step]:
            t.zero_()
    export = ewc_export(model, old_vars)
    sides = {"bfloat16": (cfg, model, model_old, state, old_vars)}
    ref, ref_ewc, ref_val = {}, {}, {}
    start = {"batch": batch, "cfg": cfg, "ewc_export": export}
    plain_bytes = plain_peak = None
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            sides[dtype] = f32_twin(tr, dev)
        c, m, mo, st, ov = sides[dtype]
        ref[dtype] = plain_and_rounding(c, m, mo, st, ov, batch)
        if dtype == "bfloat16":
            plain_bytes = state_bytes(st, m, ov)
            plain_peak = ref[dtype][3]
        ref_val[dtype] = validate_ref(c, m, mo, ov, batch)
        start[dtype] = {"model": _cpu(m.state_dict()), "old": _cpu(ov)}
        st.reg_state = ewc_state(ewc_cfg(c), m, ov, export)
        ref_ewc[dtype] = plain_and_rounding(ewc_cfg(c), m, mo, st, ov, batch)
        st.reg_state = None
    del sides["float32"]
    # bf16_norm at both compute dtypes (make_model rounds the ABNs'
    # outputs at any): at bf16 a rounding-only change moves the step by
    # about its size, so only the f32 side can tell a fault from rounding
    ref_bn = {}
    for dtype in ("bfloat16", "float32"):
        cfg_bn = dataclasses.replace(cfg, bf16_norm=True, dtype=dtype)
        m_bn, mo_bn, st_bn, ov_bn = build_train(dev, cfg_bn,
                                                start[dtype]["old"])
        with torch.no_grad():
            m_bn.load_state_dict(start[dtype]["model"])
        ref_bn[dtype] = plain_and_rounding(cfg_bn, m_bn, mo_bn, st_bn, ov_bn,
                                           batch)
        del m_bn, mo_bn, st_bn, ov_bn
        gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"card": where, "min_size": MESH2D_MIN_SIZE,
           "plain_state_bytes": plain_bytes, "plain_peak_gb": plain_peak}
    with tempfile.TemporaryDirectory() as work:
        torch.save(start, os.path.join(work, "start.pt"))
        del start
        t0 = time.perf_counter()
        mp.spawn(mesh2d_rank, args=(f"file://{work}/rendezvous", work,
                                    str(dev)), nprocs=2, join=True)
        out["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            map_location=dev, weights_only=False)
                 for r in (0, 1)]
    assert [r["place"] for r in ranks] == [(0, 0), (0, 1)], ranks
    like = model.state_dict()
    on_card = dev.type == "cuda"

    def vs_plain(plain_ref, got, what) -> dict:
        """One mesh train step (both ranks' `got`) against its plain step
        and a rounding-only change of it."""
        # the plain side's regularizer accumulators are not compared
        snap, plain, alt = (
            {k: v for k, v in d.items() if not k.startswith("reg.")}
            for d in (plain_ref[0], plain_ref[1][1], plain_ref[2][1]))
        plain, alt = (plain_ref[1][0], plain), (plain_ref[2][0], alt)
        assert got[0]["metrics"] == got[1]["metrics"], what
        after = unshard_snapshot([g["after"] for g in got], like,
                                 MESH2D_MIN_SIZE)
        res = {"rounding_only": dp_deviation(snap, plain, alt),
               "vs_plain": dp_deviation(snap, plain,
                                        (got[0]["metrics"], after))}
        check_dp_deviation(res["vs_plain"], res["rounding_only"], what)
        if on_card:
            for g in got:
                for key in TRAIN_COUNTERS:
                    assert g["launches"][key] == 1, (what, key,
                                                     g["launches"])
        res["launches"] = got[0]["launches"]
        return res

    for dtype in ("bfloat16", "float32"):
        snap, plain, alt, _ = ref[dtype]
        r0, r1 = ranks[0][dtype], ranks[1][dtype]
        res = {"rounding_only": dp_deviation(snap, plain, alt)}
        res["1d_vs_plain"] = dp_deviation(
            snap, plain, (r0["metrics_1d"], r0["after_1d"]))
        check_dp_deviation(res["1d_vs_plain"], res["rounding_only"],
                           f"1-D two ranks on one card, {dtype}")
        sharded = set(r0["sharded"])
        assert sharded == set(r1["sharded"])
        after = unshard_snapshot([r0["after_2d"], r1["after_2d"]], like,
                                 MESH2D_MIN_SIZE)
        assert r0["metrics_2d"] == r1["metrics_2d"]
        res["2d_vs_plain"] = dp_deviation(snap, plain,
                                          (r0["metrics_2d"], after))
        check_dp_deviation(res["2d_vs_plain"], res["rounding_only"],
                           f"1 x 2 mesh, {dtype}")
        replicated = [k for k in r0["after_2d"]
                      if k.split(".", 1)[-1] not in sharded]
        differ = [k for k in replicated
                  if not torch.equal(r0["after_2d"][k], r1["after_2d"][k])]
        assert not differ, f"replicated tensors differ across the model " \
            f"group ({dtype}): {differ[:5]}"
        # (a) the validate step: the same counts and predictions on both
        # model ranks, each pixel once, against the plain validate step
        v0, v1 = r0["validate"], r1["validate"]
        assert torch.equal(v0["hist"], v1["hist"]), dtype
        assert torch.equal(v0["preds"], v1["preds"]), dtype
        assert v0["terms"] == v1["terms"], dtype
        res["validate"] = check_mesh_validate(v0, ref_val[dtype], batch,
                                              dtype)
        res["validate"]["launches"] = v0["launches"]
        # (c) EWC on the mesh: the penalty summed over the shards
        res["ewc"] = vs_plain(ref_ewc[dtype], [r0["ewc"], r1["ewc"]],
                              f"EWC on the 1 x 2 mesh, {dtype}")
        l_reg, l_plain = (r0["ewc"]["metrics"]["l_reg"],
                          ref_ewc[dtype][1][0]["l_reg"])
        assert l_plain > 0 and abs(l_reg - l_plain) <= DP_VS_PLAIN[0] * \
            l_plain, (dtype, l_reg, l_plain)
        res["ewc"].update(l_reg=l_reg, l_reg_plain=l_plain)
        res.update(replicated_tensors_bit_equal=len(replicated),
                   sharded_tensors=len(sharded),
                   launches=r0["launches"],
                   state_bytes=[r["state_bytes"] for r in (r0, r1)],
                   peak_gb=[r["peak_gb"] for r in (r0, r1)],
                   step_s_1d=[r["step_s_1d"] for r in (r0, r1)],
                   metrics_2d=r0["metrics_2d"],
                   metrics_plain=plain[0])
        if dtype == "bfloat16":
            res["step_s_2d"] = [r["step_s_2d"] for r in (r0, r1)]
            # (b) nan_guard: a NaN on model rank 1 only, both ranks skip
            for r in (r0, r1):
                ng = r["nan_guard"]
                assert ng["nonfinite"] == 1 and not ng["changed"] \
                    and ng["kept"] > 0, ng
            res["nan_guard"] = {k: r0["nan_guard"][k] for k in (
                "kept", "nonfinite", "loss_tot", "launches")}
            for r in (r0, r1) if on_card else ():
                for key in TRAIN_COUNTERS + ("contrastive_pass1_mma",
                                             "contrastive_pass2_mma",
                                             "contrastive_bwd_mma"):
                    assert r["launches"][key] == 1, (key, r["launches"])
                assert r["launches"]["fused_argmax"] == 0, r["launches"]
                v = r["validate"]["launches"]
                assert v["fused_loss_fwd"] == v["fused_argmax"] == 1, v
                for key in TRAIN_COUNTERS:
                    assert r["nan_guard"]["launches"][key] == 1, (
                        key, r["nan_guard"])
        out[dtype] = res
    # (d) bf16_norm on the mesh
    out["bf16_norm"] = {dtype: vs_plain(
        ref_bn[dtype], [r["bf16_norm"][dtype] for r in ranks],
        f"bf16_norm on the 1 x 2 mesh, {dtype}")
        for dtype in ("bfloat16", "float32")}
    b, f = out["bfloat16"], out["float32"]
    bn_b, bn_f = out["bf16_norm"]["bfloat16"], out["bf16_norm"]["float32"]
    # every launch of the bf16 mesh sides: validate, train, nan_guard,
    # EWC and bf16_norm steps
    out["launches"] = {k: sum(side["launches"][k] for side in (
        b["validate"], b, b["nan_guard"], b["ewc"], bn_b))
        for k in b["launches"]}

    def errs(d):
        return ", ".join(f"{d[k]:.3g}" for k in (
            "terms_rel_err", "update_rel_err", "worst_update_err"))

    log(f"[mesh2d] two gloo ranks on one card, UCD VOC 15-5s step 1, "
        f"{cfg.backbone}, batch {BATCH}, {SIZE}x{SIZE}, on {where}; against the "
        f"plain step (terms, update, worst tensor): 1-D bf16 "
        f"{errs(b['1d_vs_plain'])}, f32 {errs(f['1d_vs_plain'])}; 1 x 2 "
        f"mesh bf16 {errs(b['2d_vs_plain'])}, f32 {errs(f['2d_vs_plain'])}"
        f"; rounding-only bf16 {errs(b['rounding_only'])}, f32 "
        f"{errs(f['rounding_only'])}; EWC on the mesh bf16 "
        f"{errs(b['ewc']['vs_plain'])}, f32 {errs(f['ewc']['vs_plain'])} "
        f"(rounding-only {errs(b['ewc']['rounding_only'])}, "
        f"{errs(f['ewc']['rounding_only'])}; l_reg {b['ewc']['l_reg']:.6g} "
        f"vs {b['ewc']['l_reg_plain']:.6g}); bf16_norm on the mesh bf16 "
        f"{errs(bn_b['vs_plain'])}, f32 {errs(bn_f['vs_plain'])} "
        f"(rounding-only {errs(bn_b['rounding_only'])}, "
        f"{errs(bn_f['rounding_only'])}); validate on the mesh "
        f"bf16 {json.dumps(b['validate'])}, f32 {json.dumps(f['validate'])}"
        f"; nan_guard: {b['nan_guard']['kept']} tensors kept their bits on "
        f"both ranks; {b['sharded_tensors']} sharded tensors, "
        f"{b['replicated_tensors_bit_equal']} replicated ones bit-equal on "
        f"both ranks; state bytes a rank {b['state_bytes']} against "
        f"{plain_bytes} plain; peak GB {b['peak_gb']} (plain "
        f"{out['plain_peak_gb']}); s a step 1-D {b['step_s_1d']}, 2-D "
        f"{b['step_s_2d']}; launches (all bf16 mesh sides) "
        f"{json.dumps(out['launches'])}; ranks {out['ranks_s']:.1f} s")
    restore(state, model, entry)
    return out


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

    # the same steps with tracing on: a CUDA event recorded between their
    # parts by the step's phase mark, each part's device ms the mean of 5
    n = 5
    for key, c in (("device_ms", cfg), ("device_ms_mib", cfg_mib)):
        marked_step = make_train_step(c, model, model_old, total_iters=100)
        with tracing.enabled():
            for _ in range(n):
                marked_step(state, batch, old_vars)
        r[key] = tracing.phase_ms(marked_step.phases.steps)
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


def busy_ms(fn, n) -> float:
    """Device time a call of fn() from one torch.profiler window of n
    calls: the sum of every kernel's, copy's and set's own device time
    (one stream, so a sum and not a union)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.self_device_time_total for evt in prof.key_averages()
             if evt.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / n


def time_bundle(dev, tr, where) -> dict:
    """The UCD step (phase 3b's model and state) eager and through
    make_train_bundle at K = 1, 4 and 8 steps a call: img/s in windows of 8
    steps ordered eager, K1, K4, K8, K8, K4, K1, eager, twice (each batch's
    upload included: per step eagerly, per call stacked); capture seconds
    and peak memory of each; the device's busy time a step (torch.profiler;
    and a captured step's graph replayed back to back, CUDA events) and so
    its idle share beside the windows' step time."""
    cfg, model, model_old = tr["cfg"], tr["model"], tr["model_old"]
    state, old_vars, batch = tr["state"], tr["old_vars"], tr["batch"]
    step = make_train_step(cfg, model, model_old, total_iters=100)
    ks = (1, 4, 8)
    stacks = {k: stacked([batch] * k) for k in ks}
    r = {"capture_s": {}, "peak_mem_gb": {}, "allocated_gb": {},
         "peak_reserved_gb": {}, "reserved_gb": {}}
    for _ in range(2):
        step(state, batch, old_vars)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, old_vars)
    torch.cuda.synchronize()
    r["peak_mem_gb"]["eager"] = torch.cuda.max_memory_allocated() / 1e9
    r["allocated_gb"]["eager"] = torch.cuda.memory_allocated() / 1e9
    r["peak_reserved_gb"]["eager"] = torch.cuda.max_memory_reserved() / 1e9
    r["reserved_gb"]["eager"] = torch.cuda.memory_reserved() / 1e9
    bundles = {}
    for k in ks:
        torch.cuda.reset_peak_memory_stats()
        bundles[k] = make_train_bundle(cfg, model, model_old,
                                       total_iters=100, k=k)
        bundles[k](state, stacks[k], old_vars)  # slot 0 eager, capture
        torch.cuda.synchronize()
        r["capture_s"][k] = bundles[k].capture.capture_s
        r["peak_mem_gb"][k] = torch.cuda.max_memory_allocated() / 1e9
        r["allocated_gb"][k] = torch.cuda.memory_allocated() / 1e9
        # the graph's private pool stays reserved, not allocated
        r["peak_reserved_gb"][k] = torch.cuda.max_memory_reserved() / 1e9
        r["reserved_gb"][k] = torch.cuda.memory_reserved() / 1e9

    def window(mode, n=8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "eager":
            for _ in range(n):
                step(state, batch, old_vars)
        else:
            for _ in range(n // mode):
                bundles[mode](state, stacks[mode], old_vars)
        torch.cuda.synchronize()
        return n * BATCH / (time.perf_counter() - t0)

    runs = {m: [] for m in ("eager",) + ks}
    for mode in ("eager", 1, 4, 8, 8, 4, 1, "eager") * 2:
        runs[mode].append(window(mode))
    r["img_per_s_runs"] = {str(m): v for m, v in runs.items()}
    r["img_per_s"] = {str(m): sum(v) / len(v) for m, v in runs.items()}
    r["step_ms"] = {m: BATCH / v * 1e3 for m, v in r["img_per_s"].items()}
    r["busy_ms"] = {
        "eager": busy_ms(lambda: step(state, batch, old_vars), 5),
        "4": busy_ms(lambda: bundles[4](state, stacks[4], old_vars), 2) / 4}
    graph = bundles[1].capture.graph
    r["graph_replay_ms"] = cuda_ms(graph.replay, iters=10, warmup=2)
    r["idle_share"] = {m: 1.0 - r["busy_ms"][m] / r["step_ms"][m]
                       for m in r["busy_ms"]}
    r["idle_share"]["graph_replay_vs_8"] = \
        1.0 - r["graph_replay_ms"] / r["step_ms"]["8"]
    log(f"[time] UCD step eager vs captured (VOC 15-5s step 1, ResNet-101, "
        f"batch {BATCH}, {SIZE}x{SIZE}, bf16) on {where}: img/s "
        + ", ".join(f"{m} {v:.2f} ({', '.join(f'{x:.2f}' for x in runs[m if m == 'eager' else int(m)])})"
                    for m, v in r["img_per_s"].items())
        + "; device busy a step (profiler) eager "
        f"{r['busy_ms']['eager']:.2f} ms, captured (K=4) "
        f"{r['busy_ms']['4']:.2f} ms; a captured step's graph replayed back "
        f"to back {r['graph_replay_ms']:.2f} ms; idle share eager "
        f"{r['idle_share']['eager']:.3f}, K=4 {r['idle_share']['4']:.3f}; "
        f"capture s {json.dumps(r['capture_s'])}; peak GB allocated "
        f"{json.dumps(r['peak_mem_gb'])}, reserved "
        f"{json.dumps(r['reserved_gb'])} (each K's graph keeps its pool)")
    del bundles, graph
    torch.cuda.empty_cache()
    return r


def time_experiment(dev, where) -> dict:
    """The experiment loop in steady state, beside phase 4's raw step: a
    step-1 UCD `Experiment` (VOC 15-5, ResNet-101, batch 8, 512x512, bf16)
    over 64 synthetic images, three epochs of 8 iterations through
    `train_epoch` (img/s, the host's wait for the loader), then one more
    pass over batches loaded beforehand (no loader threads); the train loader
    alone at 1, 4 and 8 worker threads; one checkpoint write, synchronous
    and asynchronous (the time the loop is held). Beside it, the same
    Experiment at steps_per_call 4 (two CUDA-graph calls of 4 steps an
    epoch; its first epoch captures), epochs taken in turns with the
    per-step loop's."""
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
        exp4 = Experiment(C.make_config(step=1, method="UCD",
                                        steps_per_call=4, **kw),
                          base_train=base1, base_val=base1, device=dev)
        assert len(exp.train_loader) == 8 and exp4.train_bundle is not None
        epochs, epochs4 = [], []
        for e in range(3):
            epochs.append(exp.train_epoch(e))
            epochs4.append(exp4.train_epoch(e))
        capture4_s = exp4.train_bundle.capture.capture_s
        exp4.close()
        del exp4
        torch.cuda.empty_cache()
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
         "epoch_img_per_s_steps_per_call_4":
             [e["images_per_s"] for e in epochs4],
         "data_wait_s_steps_per_call_4": [e["data_wait_s"] for e in epochs4],
         "loss_tot_steps_per_call_4": [e["loss_tot"] for e in epochs4],
         "capture_s_steps_per_call_4": capture4_s,
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
        f"(sync) / {save_s['async']:.2f} s (async); at steps_per_call 4 "
        + ", ".join(f"{e['images_per_s']:.2f}" for e in epochs4)
        + f" img/s (its first epoch captures, {capture4_s:.3f} s)")
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
    ap.add_argument("--only", choices=["kernels", "dp", "options", "mesh2d",
                                       "bars", "accuracy"],
                    default=None,
                    help="kernels: stop after the kernel checks; dp / "
                         "options / mesh2d: build, then phases 3b and 3f / "
                         "3g / 3h only; bars: build, then the JAX "
                         "functional tests' bars at their sizes with the "
                         "kernels on, deterministic; accuracy: build, then "
                         "the VOC 15-5s retention curve at full width, "
                         "plain and under bf16_norm (none prints a result)")
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

    if args.only == "dp":
        phase_dp(dev, phase_train(dev), where)
        lap("3b + 3f")
        return 0
    if args.only == "options":
        options = phase_exec_options(dev, phase_train(dev), where)
        log(json.dumps({"options": {"card": where, **options}}))
        lap("3b + 3g")
        return 0
    if args.only == "mesh2d":
        mesh2d = phase_mesh2d(dev, phase_train(dev), where)
        log(json.dumps({"mesh2d": mesh2d}))
        lap("3b + 3h")
        return 0
    if args.only == "bars":
        phase_accuracy(dev)
        lap("the JAX bars at the functional tests' sizes")
        return 0
    if args.only == "accuracy":
        phase_accuracy_full(dev, where)
        lap("the retention curve at full width")
        return 0

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

    # phase 3d: the same step, K a call through a CUDA graph, bit for bit
    bundled = phase_bundle(dev, trained)
    lap("3d bundle (CUDA graph)")

    # phase 3c: the experiment around the step, through the CLI (it sets
    # the counts to 0 and reads them)
    experiment = phase_experiment(dev, where)
    lap("3c experiment")

    # phase 3e: RW across two steps and its bundle, LWF-MC, RW card vs CPU
    families = phase_families(dev)
    lap("3e method families")


    # phase 4: timings
    timing = time_fused_argmax(dev, where)
    loss_timing = time_fused_loss(dev, where)
    con_timing = time_contrastive(dev, where)
    serving = time_serving(dev, served, where, args.profile)
    log(json.dumps({"serving": {"card": where, **serving}}))
    training = time_training(dev, trained, where, args.profile)
    log(json.dumps({"training": {"card": where, **training}}))
    captured = time_bundle(dev, trained, where)
    loop = time_experiment(dev, where)
    failure = check_capture_failure()
    lap("4 timings")

    # phase 3f: the data-parallel path on one NCCL rank (it sets the
    # counts to 0 and reads them); after phase 4, whose profiler windows
    # lost kernel events once this phase had run before them
    dp = phase_dp(dev, trained, where)
    lap("3f data parallelism (one NCCL rank)")

    # phase 3g: the host ops' build, the execution options (the option
    # steps set the counts to 0 and read them), GroupNorm ABN and the
    # off-path modules
    options = phase_exec_options(dev, trained, where)
    lap("3g host ops, execution options, off-path modules")

    # phase 3h: two gloo ranks on one card, the 1-D data axis and the 1 x 2
    # data x model mesh (the ranks set the counts to 0 and read them)
    mesh2d = phase_mesh2d(dev, trained, where)
    lap("3h two ranks on one card: 1-D and the 1 x 2 mesh")

    # phase 3i: the six-step VOC 15-5s run-task of UCD and FT with the
    # kernels on (it sets the counts to 0 and reads them); `--only bars`
    # holds the same path to the JAX bars
    accuracy = phase_accuracy_path(dev)
    lap("3i accuracy path: the 15-5s run-task, UCD and FT")
    log(json.dumps({"bundle": {
        "card": where, "bits": bundled, "timing": captured,
        "capture_failure": failure,
        "experiment_img_per_s": {
            "steps_per_call_1": loop["epoch_img_per_s"],
            "steps_per_call_4": loop["epoch_img_per_s_steps_per_call_4"]}}}))
    log(json.dumps({"families": {"card": where, **families}}))
    log(json.dumps({"dp": {"card": where, **dp}}))
    log(json.dumps({"experiment": {
        "card": where, **experiment,
        "raw_ucd_step_img_per_s": training["img_per_s"],
        "raw_ucd_step_img_per_s_runs": training["img_per_s_runs"],
        "steady_state": loop}}))
    log(json.dumps({"options": {"card": where, **options}}))
    log(json.dumps({"mesh2d": mesh2d}))
    log(json.dumps({"accuracy": {"card": where, **accuracy}}))
    exp_counts = experiment["launches"]
    acc_counts = accuracy["launches"]
    mesh_counts = mesh2d["launches"]
    opt_counts = options["launches"]

    kernels = [{
        "name": "fused_argmax", "route": "cuda",
        "source": "ucd_torch/ops/csrc/fused_argmax.cu",
        "replaces": "ucd_tpu/ops/fused_eval.py:76",
        "replaces_fn": "ucd_tpu/ops/fused_eval.py::_argmax_kernel",
        "launches": serve_launches + counts["fused_argmax"],
        "launches_serving": serve_launches,
        "launches_train": counts["fused_argmax"],
        "launches_experiment": exp_counts["fused_argmax"],
        "launches_dp": dp["launches"]["fused_argmax"],
        "launches_options": opt_counts["fused_argmax"],
        "launches_mesh2d": mesh_counts["fused_argmax"],
        "launches_accuracy": acc_counts["fused_argmax"],
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
            "launches_bundle": bundled["launches_bundle"][name],
            "launches_dp": dp["launches"][name],
            "launches_dp_bundle": dp["bundle"]["launches_bundle"][name],
            "launches_options": opt_counts[name],
            "launches_mesh2d": mesh_counts[name],
            "launches_accuracy": acc_counts[name],
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
            "launches_bundle": bundled["launches_bundle"][name],
            "launches_dp": dp["launches"][name],
            "launches_dp_bundle": dp["bundle"]["launches_bundle"][name],
            "launches_options": opt_counts[name],
            "launches_mesh2d": mesh_counts[name],
            "launches_accuracy": acc_counts[name],
            "launches_accuracy_mma": acc_counts[name + "_mma"],
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
