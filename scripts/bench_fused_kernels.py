#!/usr/bin/env python3
"""Time the port's fused upsample kernels on one NVIDIA GPU: B6
(`fused_argmax`, upsample + argmax) and B1 (`fused_ce_kd`'s forward,
upsample + CE/KD), each three ways.

    python3 scripts/bench_fused_kernels.py [--repo DIR] [--iters N]

`--repo` names the checkout whose `ucd_torch` is timed (default: the one
this script sits in), so that two commits unpacked side by side are timed
in turns in one call, each from its own build.

  kernel_ms   the kernels' own device time per call: one torch.profiler
              window of N calls, summed over the CUDA kernels whose names
              hold the wrapper's kernel stem (`KERNEL_NAMES`), over N;
  wrapper_ms  CUDA events around N back-to-back wrapper calls, over N: the
              device time when the device is the slower side, else the
              host's;
  enqueue_ms  host time per wrapper call (time.perf_counter over N calls,
              no synchronize).

Shapes: B6 at the serving shape (8, 32, 32, 21) -> 512x512 in f32 (the
serving path's logits) and in bf16, and ADE's 151 classes in f32; B1 at the
train shape (8, 32, 32, 17) + (8, 32, 32, 16), uint8 labels -> 512x512,
in unce+unkd (the train step) and ce/none (the validate step). Prints one
line per measurement and a final JSON object with the card's name and
power limit. `chip_smoke.py` uses `device_ms` and `enqueue_ms` for its own
kernel table."""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

# the name stems of each wrapper's CUDA kernels, as their sources define
# them (B6 had a separate NaN-row kernel before it became one launch)
KERNEL_NAMES = {
    "fused_argmax": ("fused_argmax", "nan_rows"),
    "fused_loss_fwd": ("fused_loss_fwd",),
    "fused_loss_bwd": ("fused_loss_bwd", "fused_loss_fold"),
    "contrastive_pass1": ("contrastive_pass1",),
    "contrastive_pass2": ("contrastive_pass2",),
    "contrastive_bwd": ("contrastive_bwd",),
}


def device_ms(fn, names, iters=50, warmup=5, tries=3):
    """(ms per call, {kernel: ms per call}, kernel launches per call) of the
    CUDA kernels whose names hold one of `names`, from one torch.profiler
    window of `iters` calls of fn(). A window whose launch count is not a
    whole number per call lost events (seen once on the card) and is taken
    again, up to `tries` windows. Raises when the window shows none of the
    kernels: a profiler that sees no device time is a failure, not a
    zero."""
    from torch.profiler import ProfilerActivity, profile

    pattern = re.compile(r"\w*(?:%s)\w*" % "|".join(map(re.escape, names)))
    for _ in range(tries):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split, count = {}, 0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = pattern.search(evt.key)
            us = evt.self_device_time_total
            if m and us > 0:
                split[m.group(0)] = split.get(m.group(0), 0.0) \
                    + us / 1e3 / iters
                count += evt.count
        if not split:
            raise RuntimeError(f"the profiler saw no kernel named like "
                               f"{names}")
        if count % iters == 0:
            break
    else:
        raise RuntimeError(f"the profiler lost kernel events in {tries} "
                           f"windows: {count} launches over {iters} calls")
    return sum(split.values()), split, count / iters


def event_ms(fn, iters=100, warmup=10):
    """CUDA-event time per call of `iters` back-to-back calls of fn()."""
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


def enqueue_ms(fn, iters=200, warmup=10):
    """Host time per call of fn() over `iters` calls, without a
    synchronize inside the window: what the host spends to enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def three_ways(fn, names, iters) -> dict:
    kernel, split, launches = device_ms(fn, names, iters)
    return {"kernel_ms": kernel, "wrapper_ms": event_ms(fn, iters),
            "enqueue_ms": enqueue_ms(fn, 2 * iters), "kernels": split,
            "kernel_launches_per_call": launches}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=here,
                    help="checkout whose ucd_torch is timed")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fused_kernels: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from ucd_torch.ops import build
    from ucd_torch.ops import fused_eval as FE
    from ucd_torch.ops import fused_loss as FL

    dev = torch.device("cuda", 0)
    build.build([FE.KERNEL, FL.KERNEL])
    g = torch.Generator().manual_seed(2)
    out = {"repo": os.path.abspath(args.repo),
           "ucd_torch": os.path.dirname(FE.__file__), "card": card()}
    for name, shape, dtype in (
            ("fused_argmax f32 (8,32,32,21)", (8, 32, 32, 21), torch.float32),
            ("fused_argmax bf16 (8,32,32,21)", (8, 32, 32, 21),
             torch.bfloat16),
            ("fused_argmax f32 (8,32,32,151)", (8, 32, 32, 151),
             torch.float32)):
        z = torch.randn(*shape, generator=g).to(dev, dtype)
        out[name] = three_ways(lambda: FE.fused_argmax(z, (512, 512)),
                               KERNEL_NAMES["fused_argmax"], args.iters)
    B, h, C, Co, H = 8, 32, 17, 16, 512
    z = torch.randn(B, h, h, C, generator=g).to(dev)
    t = torch.randn(B, h, h, Co, generator=g).to(dev)
    lab = torch.randint(0, C + 1, (B, H, H), generator=g).to(torch.uint8)
    lab[lab == C] = 255
    lab = lab.to(dev)
    for name, kw in (
            ("fused_loss_fwd unce+unkd", dict(old_cl=16, ce_mode="unce",
                                              kd_mode="unkd", alpha=1.0)),
            ("fused_loss_fwd ce+none", dict(old_cl=0, ce_mode="ce",
                                            kd_mode="none", alpha=1.0))):
        tz = t if kw["kd_mode"] != "none" else None
        out[name] = three_ways(lambda: FL.launch_fwd(z, tz, lab, **kw),
                               KERNEL_NAMES["fused_loss_fwd"], args.iters)
        out[name]["fused_ce_kd_wrapper_ms"] = event_ms(
            lambda: FL.fused_ce_kd(z, lab, tz, **kw), args.iters)
    for k, v in out.items():
        if isinstance(v, dict):
            print(f"[bench] {k}: " + ", ".join(
                f"{a} {b:.5f}" for a, b in v.items()
                if isinstance(b, float)) + f"; kernels {v['kernels']}",
                flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
