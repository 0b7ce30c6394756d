#!/usr/bin/env python3
"""Where the synchronized BatchNorm's device time goes, on one GPU.

Collects the input shape of every train-mode BatchNorm of chip_smoke.py's
full-width model (ResNet-101 DeepLab-v3, os 16, batch 8, 512x512, bf16
compute: each BatchNorm normalizes f32 in channels_last memory), then
times over all of them, with CUDA events, as the step calls them:

  * the plain train-mode BatchNorm forward + backward (`BatchNorm2d`
    outside a process group: cuDNN);
  * the synchronized one (`_SyncBatchNorm`) inside a process group of
    one rank over NCCL, forward + backward;
  * the pieces of its forward: `torch.var_mean` over (N, H, W), the
    two-pass mean / mean of squared deviations, cuDNN's train-mode
    statistics, the inference-mode normalize; and of its backward: the
    inference-mode BatchNorm backward and the per-channel a * x + b
    correction; beside them torch's own SyncBatchNorm kernels
    (`batch_norm_stats`, `_elemt`, `_backward_reduce`, `_backward_elemt`,
    CUDA only).

Times are device time from a torch.profiler window (every kernel's own
time), not the host clock.

    python3 scripts/bench_sync_bn.py [--out FILE.json]

Prints one JSON line (ms summed over the BatchNorms of one step; the
largest kernels of the plain and the synchronized forward + backward).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def shapes_of_one_step(cs, dev):
    """(N, C, H, W) of each train-mode BatchNorm input of one forward."""
    from ucd_torch.models.layers import BatchNorm2d
    cfg = cs.C.make_config(**cs.TRAIN)
    model = cs.make_model(cfg).to(device=dev,
                                  memory_format=torch.channels_last)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, BatchNorm2d)]
    x = torch.from_numpy(cs.make_images(cs.BATCH, cs.SIZE, cs.SIZE, 3)).to(
        dev).permute(0, 3, 1, 2)
    model.train()
    with torch.no_grad():
        model.forward_feats(x)
    for h in hooks:
        h.remove()
    return shapes


def device_ms(fn, iters=3, top=0):
    """The device time of one fn() (every kernel's own time from a
    torch.profiler window of `iters` calls, after a warm-up call); with
    `top`, also the `top` kernels by time, ms a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3 / iters, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for ms, _ in rows)
    if not top:
        return total
    return total, [[k[:90], ms] for ms, k in sorted(rows, reverse=True)[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sync_bn: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ucd_torch import parallel as P
    from ucd_torch.models.layers import BatchNorm2d
    dev = torch.device("cuda", 0)
    shapes = shapes_of_one_step(cs, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(s, device=dev, generator=g).contiguous(
        memory_format=torch.channels_last) for s in shapes]
    dys = [torch.randn_like(x) for x in xs]
    bns = [BatchNorm2d(s[1], eps=1e-5, momentum=0.1).to(dev) for s in shapes]

    def fwd_bwd():
        for bn, x, dy in zip(bns, xs, dys):
            xr = x.requires_grad_(True)
            bn(xr).backward(dy)
            xr.grad = None

    def var_mean():
        for x in xs:
            torch.var_mean(x, dim=(0, 2, 3), correction=0)

    def two_pass():
        for x in xs:
            mean = x.mean(dim=(0, 2, 3), keepdim=True)
            (x - mean).square().mean(dim=(0, 2, 3))

    def normalize():
        for bn, x in zip(bns, xs):
            F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, 1e-5)

    def bwd_eval():
        for bn, x, dy in zip(bns, xs, dys):
            invstd = torch.rsqrt(bn.running_var + 1e-5)
            dx, _, _ = torch.ops.aten.native_batch_norm_backward(
                dy, x, bn.weight, bn.running_mean, bn.running_var,
                bn.running_mean, invstd, False, 1e-5, [True, True, True])
            a = bn.weight.view(1, -1, 1, 1)
            dx.addcmul_(x, a).add_(a)

    def train_stats():
        for x in xs:
            c = x.shape[1]
            mean = torch.zeros(c, device=dev)
            var = torch.ones(c, device=dev)
            F.batch_norm(x, mean, var, None, None, True, 1.0, 1e-5)

    def torch_sync_kernels():
        # torch's own SyncBatchNorm kernels (CUDA only), one rank
        for bn, x, dy in zip(bns, xs, dys):
            mean, invstd = torch.batch_norm_stats(x, 1e-5)
            torch.batch_norm_elemt(x, bn.weight, bn.bias, mean, invstd,
                                   1e-5)
            sdy, sdyx, gw, gb = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, bn.weight, True, True, True)
            count = torch.full((1,), x.numel() // x.shape[1],
                               dtype=torch.int32, device=dev)
            torch.batch_norm_backward_elemt(dy, x, mean, invstd, bn.weight,
                                            sdy, sdyx, count)

    plain, plain_top = device_ms(fwd_bwd, top=8)
    out = {"card": cs.card(), "n_batchnorms": len(shapes),
           "elements": sum(x.numel() for x in xs),
           "plain_fwd_bwd_ms": plain, "plain_top": plain_top,
           "var_mean_ms": device_ms(var_mean),
           "two_pass_stats_ms": device_ms(two_pass),
           "train_mode_stats_ms": device_ms(train_stats),
           "normalize_ms": device_ms(normalize),
           "backward_eval_and_correction_ms": device_ms(bwd_eval),
           "torch_sync_kernels_ms": device_ms(torch_sync_kernels)}
    with tempfile.TemporaryDirectory() as tmp:
        P.init_group(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            out["sync_fwd_bwd_ms"], out["sync_top"] = device_ms(fwd_bwd,
                                                                top=12)
        finally:
            P.shutdown()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
