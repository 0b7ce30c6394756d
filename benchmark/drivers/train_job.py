"""Driver of a training job: the program's UCD train step at an incremental
step, eager (`steps_per_call` 1, `make_train_step`) or K steps a call
through a CUDA graph (`make_train_bundle`), fed host batches as the
program's Experiment feeds them.

Set-up: the donor's weights from the seed, calibrated on one seeded batch
(reference/model.py); a pool of seeded batches of uint8 images and label
maps; the program's train state built on the donor (`build_train_state`,
which grows the model and imprints the new classifier); then the checked
steps: the first `check_steps` steps, or the first call when K > 1, which
also warm up every shape and kernel. The window then drives the same
state with the same call for `seconds` and closes on a synchronize; the
host record (lib/host.py) is logged. With --trace 1 a steady stretch of it
is profiled. After the window: the peak memory, the program's state freed,
and the reference follows the checked steps from the same weights and
batches (lib/compare.py).

Traffic keys: driver, batch, steps_per_call, pool (batches, a multiple of
steps_per_call), check_steps, classes_per_image, ignore_band,
calibration_batch, trace_at (the share of the window before the traced
stretch), trace_calls.
"""

from __future__ import annotations

import gc
import os
import time

import torch

from benchmark import flops
from benchmark.lib import compare, host, inputs, report
from benchmark.lib.trace import Traced
from benchmark.reference import model as RM
from benchmark.reference.train import Reference

COUNTERS = ("launches_fwd", "launches_bwd", "launches_pass1",
            "launches_pass2")


def arch_of(config: dict, classes) -> dict:
    arch = {k: config[k] for k in ("backbone", "output_stride",
                                   "head_channels", "pooling")}
    arch["classes"] = list(classes)
    return arch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counters() -> dict:
    from ucd_torch.ops import fused_loss as FL
    from ucd_torch.ops import tiled_contrastive as TT

    fns = {"fused_ce_kd": FL.fused_ce_kd,
           "contrastive": TT.pixel_contrastive_loss_tiled}
    return {f"{a}.{n}": getattr(f, n) for a, f in fns.items()
            for n in COUNTERS if hasattr(f, n)}


class Prepared:
    """The cell's seeded weights and batches (device tensors and the host
    arrays the program is fed)."""

    def __init__(self, ctx):
        cf, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.B, self.S, self.K = tr["batch"], cf["crop_size"], \
            tr["steps_per_call"]
        self.classes = cf["classes_per_step"]
        self.arch = arch_of(cf, self.classes)
        self.donor_arch = arch_of(cf, self.classes[:-1])
        self.old = sum(self.classes[:-1])
        B, S, K, n = self.B, self.S, self.K, tr["pool"]
        wide = torch.float64 if cf["program"]["dtype"] == "float64" \
            else torch.float32
        self.donor = inputs.model_weights(self.donor_arch, ctx.seed, dev,
                                          (tr["calibration_batch"], S, S),
                                          wide)
        g = inputs.generator(ctx.seed, "batches", dev)
        new_ids = list(range(self.old, self.old + self.classes[-1]))
        self.imgs = inputs.images(n * B, S, S, g, dev).view(n, B, S, S, 3)
        self.labs = inputs.labels(n * B, S, S, new_ids,
                                  tr["classes_per_image"], tr["ignore_band"],
                                  g, dev).view(n, B, S, S)
        h_img, h_lab = self.imgs.cpu().numpy(), self.labs.cpu().numpy()
        if K == 1:
            self.feeds = [{"image": h_img[i], "label": h_lab[i]}
                          for i in range(n)]
        else:
            self.feeds = [{"image": torch.from_numpy(h_img[i:i + K]),
                           "label": torch.from_numpy(h_lab[i:i + K])}
                          for i in range(0, n, K)]
        # steps checked against the reference, and after which of them
        # the momentum is read (the first call's last)
        self.n_calls = tr["check_steps"] if K == 1 else 1
        self.n_steps = self.n_calls * K
        self.first = K
        self.hyper = dict(cf["hyper"], total_iters=cf["total_iters"],
                          lr=cf["program"]["lr"], step=cf["program"]["step"],
                          old_classes=self.old,
                          max_label=cf["num_classes"] - 1)


class Program:
    """The program's train state and its step (or bundle), built on the
    prepared donor."""

    def __init__(self, ctx, prep: Prepared):
        from ucd_torch import config as C
        from ucd_torch.engine.state import build_train_state
        from ucd_torch.engine.train import make_train_bundle, make_train_step
        from ucd_torch.models import make_model

        cf, dev, K = ctx.config, ctx.device, prep.K
        cfg = C.make_config(**cf["program"], batch_size=prep.B,
                            steps_per_call=K)
        model = make_model(cfg)
        model_old = make_model(cfg, cfg.classes_per_step[:-1])
        self.state, self.old_vars = build_train_state(
            cfg, model, torch.Generator().manual_seed(ctx.seed % 2 ** 63),
            cf["total_iters"], prev_model_state=prep.donor, device=dev)
        if K == 1:
            self.fn = make_train_step(cfg, model, model_old,
                                      cf["total_iters"], device=dev)
        else:
            self.fn = make_train_bundle(cfg, model, model_old,
                                        cf["total_iters"], K, device=dev)
        self.feeds = prep.feeds

    def __call__(self, i: int) -> dict:
        return self.fn(self.state, self.feeds[i % len(self.feeds)],
                       self.old_vars)[1]

    def checked(self, prep: Prepared):
        """Run the checked steps; (their terms, momentum norms after the
        first call, change norms of every parameter and statistic)."""
        model = self.state.model
        before = {k: v.detach().to("cpu", copy=True)
                  for k, v in model.state_dict().items()
                  if v.is_floating_point()}
        rows, first = [], None
        for i in range(prep.n_calls):
            m = self(i)
            for j in range(prep.K):
                rows.append({k: float(m[k] if prep.K == 1 else m[k][j])
                             for k in compare.TERMS})
            if i == 0:
                first = compare.norms(self.state.opt_state["trace"])
        return rows, first, compare.change_norms(model.state_dict(), before)


def reference_checked(prep: Prepared, q=None):
    """The reference over the checked steps: (terms, momentum norms after
    the first call, change norms, first gradient norms)."""
    ref = Reference(RM.grow(prep.donor, prep.arch, prep.classes[-1]),
                    prep.donor, prep.arch, prep.donor_arch, prep.hyper, q=q)
    start = {k: v.detach().to("cpu", copy=True) for k, v in ref.sd.items()
             if v.is_floating_point()}
    rows, first, grad0 = [], None, None
    for j in range(prep.n_steps):
        rows.append(ref.step(prep.imgs[j], prep.labs[j]))
        if j == 0:
            grad0 = dict(ref.grad_norms)
        if j == prep.first - 1:
            first = compare.norms(ref.trace)
    return rows, first, compare.change_norms(ref.sd, start), grad0


def checks(prog, ref) -> list:
    """The three compared numbers of program (terms, first, change) against
    the reference's (terms, first, change, first gradient norms)."""
    keep = compare.kept_leaves(ref[3])
    stats = {k for k in ref[2] if k.endswith(("running_mean", "running_var"))}
    grad = compare.worst_leaves(prog[1], ref[1], keep)
    change = compare.worst_leaves(prog[2], ref[2], keep | stats)
    return [{"name": "loss_gap", "value": compare.loss_gap(prog[0], ref[0])},
            {"name": "grad_gap", "value": grad[0][1], "worst": grad},
            {"name": "change_gap", "value": change[0][1], "worst": change}]


def run(ctx) -> dict:
    tr, dev = ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    prep = Prepared(ctx)
    B, S, K = prep.B, prep.S, prep.K
    ctx.log(f"inputs: {tr['pool']} batches of {B} at {S}x{S}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prog = Program(ctx, prep)
    checked = prog.checked(prep)
    _sync(dev)
    setup_s = ctx.setup_s()
    ctx.log(f"set-up {setup_s:.2f} s; checked steps {checked[0]}")

    losses, dispatch, calls = [], [], 0
    traced, t_calls, launches, before = None, 0, {}, None
    i = prep.n_calls
    load = [os.getloadavg()]
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    trace_at = t0 + tr["trace_at"] * ctx.seconds
    while time.perf_counter() < deadline:
        if ctx.trace and cuda and traced is None and \
                time.perf_counter() >= trace_at:
            before = (calls, time.perf_counter() - t0, len(dispatch))
            c0 = _counters()
            with Traced() as traced:
                for _ in range(tr["trace_calls"]):
                    losses.append(prog(i)["loss_tot"])
                    i += 1
            c1 = _counters()
            launches = {k: c1[k] - c0[k] for k in c0}
            t_calls = tr["trace_calls"]
            calls += t_calls
            continue
        ta = time.perf_counter()
        losses.append(prog(i)["loss_tot"])
        dispatch.append(time.perf_counter() - ta)
        calls += 1
        i += 1
    _sync(dev)
    window_s = time.perf_counter() - t0
    load.append(os.getloadavg())
    ctx.log(host.line(host.card_address(dev), load, torch.get_num_threads(),
                      dispatch))
    steps = calls * K
    loss_all = torch.cat([x.reshape(-1).float().cpu() for x in losses])
    failed = int((~torch.isfinite(loss_all)).sum())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device = report.device_info(1) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    reduced = traced.reduce() if traced is not None else None
    if reduced is not None:
        device.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    capture = getattr(prog.fn, "capture", None)
    ctx.log(f"window {window_s:.3f} s: {steps} steps, peak "
            f"{peak / 1e9:.3f} GB, failed {failed}")

    # the program's state goes before the reference runs
    del prog, losses, loss_all
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_checked(prep)
    found = checks(checked, ref)
    ctx.log(f"reference {ref[0]}; {found}")

    cf = ctx.config
    h = S // cf["output_stride"]
    con = {"P": B * h * h, "M": 2 * B * h * h, "D": cf["head_channels"],
           "C": prep.old, "bf16": cf["program"]["dtype"] == "bfloat16"}
    # rates of a traced run count the window before its traced stretch:
    # the host runs slower once the profiler has run
    n_calls, span, n_disp = before or (calls, window_s, len(dispatch))
    records = {
        "batch": B, "steps": n_calls * K, "steps_per_call": K,
        "window_s": span, "dispatch_s": dispatch[:n_disp],
        "traced_steps": t_calls * K, "launches": launches,
        "capture_s": None if capture is None else capture.capture_s,
        "step_flops": flops.train_step_flops(prep.arch, prep.donor_arch, B,
                                             S, S)
        + sum(o for _, o in flops.contrastive_work(
            con["P"], con["M"], con["D"], con["C"], con["bf16"]).values()),
        "fused_loss": {"B": B, "h": h, "w": h, "C": sum(prep.classes),
                       "Co": prep.old, "H": S, "W": S, "old_cl": prep.old},
        "contrastive": con,
    }
    e2e = {"train_img_per_s": steps * B / window_s,
           "train_peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    return {"attempted": steps, "failed": failed, "e2e": e2e,
            "records": records, "trace": reduced,
            "checks": [{k: c[k] for k in ("name", "value")} for c in found],
            "device": device}
