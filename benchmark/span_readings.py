#!/usr/bin/env python3
"""The program's spans at a train cell's shapes, with the program's tracing
on (ucd_torch/utils/tracing.py), many seeds in one process:

    python3 benchmark/span_readings.py --workload CELL --seeds 1,2,3 \
        [--cost_windows 6] [--out FILE]

For each seed it builds the cell as benchmark/drivers/train_job.py does
(tracing on from set-up in a captured cell, so that the graph holds the
phase events), then profiles the cell's traced stretch (`trace_calls`
calls) with tracing on and prints one JSON line: the numbers of
benchmark/lib/spans.py, the idle share of each phase, the sum of the
phases against the step's device period (eager: from one step's start
event to the next's) and against the busy time a step, and the metrics
`abn.ms_per_step` and `device.idle_pct.train` read from the same trace;
under "off", the busy and window ms a step and the idle share of the
same stretch traced just before with the program's tracing off. Busy
time leaves out the device annotations of the program's ranges.

With --cost_windows N (eager cells) it first times N windows of
COST_SECONDS each, tracing off and on in turns (off, on, on, off, ...)
with no profiler: images/s closed on a synchronize, and the host's ms a
step inside each call, as `train_img_per_s` and
`host.dispatch_ms_per_step` read them.

The benchmark's own runs never run this. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
COST_SECONDS = 8.0


def cost_windows(prog, B: int, K: int, n: int) -> dict:
    """Images/s and host ms a step of `n` windows, tracing off and on in
    turns."""
    import torch

    from ucd_torch.utils import tracing

    out = {"off": [], "on": []}
    i = 0
    for w in range(n):
        mode = "on" if w % 4 in (1, 2) else "off"
        with tracing.enabled(mode == "on"):
            calls, host = 0, 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < COST_SECONDS:
                ta = time.perf_counter()
                prog(i)
                host += time.perf_counter() - ta
                calls += 1
                i += 1
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        out[mode].append({"train_img_per_s": calls * K * B / span,
                          "host.dispatch_ms_per_step":
                              1e3 * host / calls / K})
    return out


def reading(ctx, cost_n: int) -> dict:
    import torch

    from benchmark.drivers import train_job as TJ
    from benchmark.lib import readers
    from benchmark.lib.spans import PHASES, busy_spans, reduce_spans
    from benchmark.lib.trace import Traced
    from ucd_torch.utils import tracing

    tr = ctx.traffic
    prep = TJ.Prepared(ctx)
    B, K = prep.B, prep.K
    with tracing.enabled(K > 1):
        prog = TJ.Program(ctx, prep)
        for i in range(2 if K > 1 else tr["check_steps"]):
            prog(i)
    torch.cuda.synchronize()
    row = {}
    if cost_n and K == 1:
        row["cost"] = cost_windows(prog, B, K, cost_n)
    steps = tr["trace_calls"] * K
    # the same stretch traced with the program's tracing off, first
    with Traced() as traced:
        for i in range(tr["trace_calls"]):
            prog(i)
    off = traced.reduce()
    row["off"] = {"busy_ms_per_step": 1e3 * off["busy_s"] / steps,
                  "window_ms_per_step": 1e3 * off["window_s"] / steps,
                  "idle_pct_train": readers.idle_pct({"trace": off})}
    mark = prog.fn.phases if K == 1 else prog.fn.capture.phases
    if K == 1:
        mark.steps.clear()
    with tracing.enabled(), Traced() as traced:
        for i in range(tr["trace_calls"]):
            prog(i)
    red = traced.reduce()
    events = traced.prof.events()
    # busy without the ranges' device annotations (lib/spans.py)
    red["busy_s"] = 1e-6 * sum(b - a for a, b in busy_spans(events))
    phases = tracing.phase_ms(mark.steps)
    got = reduce_spans(events, red["window_s"], steps, phases)
    records = {"trace": red, "traced_steps": steps}
    total = sum(phases.get(p, 0.0) for p in PHASES)
    total_core = total - phases.get("upload", 0.0)
    row.update(
        metrics=got, phase_sum_ms=total, core_sum_ms=total_core,
        busy_ms_per_step=1e3 * red["busy_s"] / steps,
        window_ms_per_step=1e3 * red["window_s"] / steps,
        abn_ms_per_step=readers.per_step_ms(records, readers.op_s(
            records, r"batch_norm|leaky_relu|_to_copy|aten::copy_")),
        idle_pct_train=readers.idle_pct(records))
    held = list(mark.steps)
    if K == 1 and len(held) > 1:
        row["period_ms"] = sum(a[0][1].elapsed_time(b[0][1])
                               for a, b in zip(held, held[1:])) \
            / (len(held) - 1)
    del prog, traced
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cost_windows", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import report
    from benchmark.lib.cell import Context
    from benchmark.lib.spec import Benchmark

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = Benchmark.load()
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available():
        print("span_readings.py needs a CUDA device", file=sys.stderr)
        return 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(bench, cell, seed=seed, seconds=0.0, trace=True,
                      device=torch.device("cuda", 0), t_start=t0)
        if ctx.traffic["driver"] != "train_job":
            print(f"span_readings.py reads training cells, not "
                  f"{ctx.traffic['driver']}", file=sys.stderr)
            return 2
        row = {"workload": cell["name"], "seed": seed,
               "card": report.power_limit(),
               **reading(ctx, args.cost_windows),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
