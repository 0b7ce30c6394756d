#!/usr/bin/env python3
"""Readings that a cell's limits are set from (benchmark/limits/<cell>.json),
many seeds in one process:

    python3 benchmark/readings.py --workload CELL --seeds 1,2,3 \
        --what program|control|half_batch [--out FILE]

  program     the numbers `correct` compares, of sound runs of the program
              (its set-up and checked steps);
  control     the same numbers of the reference put in the program's place
              and computed a precision below the configuration's: fp8
              (e4m3 forward, e5m2 gradients, one scale per tensor) where the
              configuration states bf16;
  half_batch  the numbers of the reference that leaves half of each
              batch out and takes the mean over the rest.

The benchmark's own runs never run this. It prints one JSON line per seed
and writes them to --out. It needs the cell's card(s), as run.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _scaled(x, dtype, top: float):
    import torch

    s = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * s).to(dtype).to(x.dtype) / s


def fp8():
    """The rounding of the fp8 control: e4m3 in the forward, e5m2 on the
    gradient in the backward, each tensor scaled to its format's range."""
    import torch

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return _scaled(x, torch.float8_e4m3fn, 448.0)

        @staticmethod
        def backward(ctx, g):
            return _scaled(g, torch.float8_e5m2, 57344.0)

    return Round.apply


def train_reading(ctx, what: str) -> list:
    from benchmark.drivers import train_job as TJ

    prep = TJ.Prepared(ctx)
    ref = TJ.reference_checked(prep)
    if what == "program":
        prog = TJ.Program(ctx, prep)
        got = prog.checked(prep)
        del prog
    elif what == "control":
        got = TJ.reference_checked(prep, q=fp8())[:3]
    elif what == "half_batch":
        half = prep.B // 2
        prep.imgs, prep.labs = prep.imgs[:, :half], prep.labs[:, :half]
        got = TJ.reference_checked(prep)[:3]
    else:
        raise ValueError(what)
    return TJ.checks(got, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program",
                    choices=("program", "control", "half_batch"))
    ap.add_argument("--dtype", help="the program's compute dtype in place "
                    "of the configuration's (a second witness)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib.cell import Context
    from benchmark.lib.spec import Benchmark

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = Benchmark.load()
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available():
        print("readings.py needs a CUDA device", file=sys.stderr)
        return 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(bench, cell, seed=seed, seconds=0.0,
                      trace=False, device=torch.device("cuda", 0),
                      t_start=t0)
        if args.dtype:
            ctx.config["program"]["dtype"] = args.dtype
        if ctx.traffic["driver"] != "train_job":
            print(f"readings.py reads training cells, not "
                  f"{ctx.traffic['driver']}", file=sys.stderr)
            return 2
        reading = train_reading(ctx, args.what)
        row = {"workload": cell["name"], "what": args.what, "seed": seed,
               "checks": reading, "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
