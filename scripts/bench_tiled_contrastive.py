#!/usr/bin/env python3
"""Time the tensor-core variants of the port's tiled contrastive kernels
(pass 1, pass 2 and the backward, bf16 mode) on one NVIDIA GPU over their
launch parameters (`MmaTune`): the anchor tile of a block (128 anchors = 8
warps, and for passes 1 and 2 256 = 16 warps), the ring depth, the number of
parts the walk over the contrast set is split into, and for the backward
the general code (feature width only known at run time) beside the one
compiled for D = 256. Two shapes: the train shape at batch 8 (P 8192 x M
16384 x D 256, C 16) and at batch 16 (P 16384 x M 32768).

    python3 scripts/bench_tiled_contrastive.py [--iters N]

Every variant is first held against the default variant's result (which
`chip_smoke.py` holds against the plain version): per-anchor sums within
1e-5, `num` exactly, dA within 1e-4 (Frobenius). Then all variants are
timed in turns, twice over, with CUDA events, and the f32-mode (FMA) kernels
beside them. Prints one line per variant and a final JSON object with the
card's name and power limit."""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402
from ucd_torch.ops import build  # noqa: E402
from ucd_torch.ops import tiled_contrastive as TT  # noqa: E402

TAU = CS.TAU
T = TT.MmaTune
# (tile_a, parts, max_stages, known_depth); None keeps the wrapper's choice
VARIANTS = {
    "pass1": [T(ta, parts) for ta in (128, 256) for parts in (1, 2, 4, 8)]
    + [T(128, None, 2)],
    "pass2": [T(ta, parts) for ta in (128, 256) for parts in (1, 2, 4, 8)]
    + [T(256, None, 2)],
    "bwd": [T(128, parts) for parts in (1, 2, 4)]
    + [T(128, None, 2), T(128, None, None, 0)]}


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def bench_shape(dev, batch_images: int, iters: int) -> dict:
    batch = CS.contrastive_batch(dev, 80, **dict(CS.CON_MAIN, B=batch_images))
    P, D = batch.anchor_feat.shape
    M, C = batch.contrast_feat.shape[0], batch.anchor_prob.shape[1]
    work = CS.tiled_contrastive_work(P, M, D, C, torch.bfloat16)
    prep = TT.prepare(batch, torch.bfloat16)
    prep32 = TT.prepare(batch, torch.float32)
    assert prep.variant == "mma" and prep32.variant == "fma"
    neg, num = TT.launch_pass1(prep, TAU)
    s0, g0 = TT.launch_pass2(prep, neg, TAU)
    coef = TT.backward_coef(num, torch.ones((), device=dev))
    da0 = TT.launch_bwd(prep, neg, g0, coef, TAU)

    runs = {}
    for tune in VARIANTS["pass1"]:
        if prep.mma.af.shape[0] % tune.tile_a:
            continue
        n1, c1 = TT.launch_pass1(prep, TAU, tune=tune)
        assert rel(n1, neg) <= 1e-5 and torch.equal(c1, num), tune
        runs["pass1", tune] = (
            lambda tune=tune: TT.launch_pass1(prep, TAU, tune=tune))
    for tune in VARIANTS["pass2"]:
        if prep.mma.af.shape[0] % tune.tile_a:
            continue
        s, g = TT.launch_pass2(prep, neg, TAU, tune=tune)
        assert rel(s, s0) <= 1e-5 and rel(g, g0) <= 1e-5, tune
        runs["pass2", tune] = (
            lambda tune=tune: TT.launch_pass2(prep, neg, TAU, tune=tune))
    for tune in VARIANTS["bwd"]:
        da = TT.launch_bwd(prep, neg, g0, coef, TAU, tune=tune)
        assert rel(da, da0) <= 1e-4, (tune, rel(da, da0))
        runs["bwd", tune] = (
            lambda tune=tune: TT.launch_bwd(prep, neg, g0, coef, TAU,
                                            tune=tune))
    runs["pass1", "f32 mode"] = lambda: TT.launch_pass1(prep32, TAU)
    runs["pass1", "default"] = lambda: TT.launch_pass1(prep, TAU)
    runs["pass2", "f32 mode"] = lambda: TT.launch_pass2(prep32, neg, TAU)
    runs["bwd", "f32 mode"] = lambda: TT.launch_bwd(prep32, neg, g0, coef, TAU)
    runs["pass2", "default"] = lambda: TT.launch_pass2(prep, neg, TAU)
    runs["bwd", "default"] = lambda: TT.launch_bwd(prep, neg, g0, coef,
                                                       TAU)
    torch.cuda.synchronize()

    times = {k: [] for k in runs}
    for _ in range(2):
        for k, fn in runs.items():
            times[k].append(CS.cuda_ms(fn, iters, 2))
    out = []
    for (kernel, tune), ms in times.items():
        n_ops = work[f"contrastive_{kernel}"][1]
        r = {"kernel": kernel, "P": P, "M": M, "ms": ms,
             "tflop_per_s": n_ops / min(ms) / 1e9,
             "tune": tune if isinstance(tune, str) else tune._asdict()}
        out.append(r)
        CS.log(f"[bench] P={P} M={M} {kernel} {tune}: "
               f"{', '.join(f'{v:.4f}' for v in ms)} ms "
               f"({r['tflop_per_s']:.1f} TFLOP/s at the faster)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sass", metavar="FILE", default=None,
                    help="also write `cuobjdump -sass` of the built library "
                         "there")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tiled_contrastive: CUDA is not available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.build([TT.KERNEL])
    where = CS.card()
    if args.sass:
        import subprocess
        os.makedirs(os.path.dirname(args.sass) or ".", exist_ok=True)
        with open(args.sass, "w") as f:
            subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                            str(build.library_path(TT.KERNEL))], stdout=f,
                           check=True, timeout=300)
    rows = []
    for b in (8, 16):
        rows += bench_shape(dev, b, args.iters)
    CS.log(json.dumps({"card": where, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
