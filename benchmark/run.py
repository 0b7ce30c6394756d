#!/usr/bin/env python3
"""Run one cell of the benchmark of `ucd_torch` once, on the card(s) of
this machine.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. It makes the cell's weights and inputs from
the seed, warms up the cell's own shapes, measures for S seconds, checks
what the timed path produced against the plain reference
(benchmark/reference/), and prints as the last line of standard output one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, each compared
number beside its limit (also the last lines of standard error).

It exits non-zero and prints no result line without as many CUDA devices
as the cell asks for, or when a module of JAX or of the JAX package is
loaded once the window has closed. Build and kernel caches stay inside the
checkout.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback


def _process_start() -> float:
    """perf_counter() at this process's start (from /proc; the script's
    own start where /proc is missing)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.lib import report
    from benchmark.lib.cell import Context
    from benchmark.lib.spec import Benchmark

    bench = Benchmark.load()
    cell = bench.workload(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # true f32 where f32 is computed, as the program's CLI sets it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = Context(bench, cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0),
                  t_start=T_START)
    ctx.log(f"card: {report.power_limit()}")
    out = ctx.run()
    found = report.forbidden_modules()
    if found:
        print(f"run.py: JAX modules loaded: {found}", file=sys.stderr)
        return 4
    report.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # a failed run prints its traceback and no result
        traceback.print_exc()
        sys.exit(1)
