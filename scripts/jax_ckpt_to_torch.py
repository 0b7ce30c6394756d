#!/usr/bin/env python3
"""Convert a JAX step checkpoint into the PyTorch port's checkpoint file.

    python scripts/jax_ckpt_to_torch.py CKPT_DIR OUT

CKPT_DIR is an orbax step checkpoint written by `ucd_tpu` (a directory at
`cfg.ckpt_path()`); OUT is the port's checkpoint file (`torch.save`, the
same logical schema). Pass OUT as the port's `--ckpt` to resume the step,
as `--step_ckpt` to use it as the next step's donor, or to `export`. Put it
at the port's `cfg.ckpt_path()` for `run-task` to find it by itself.

This bridge is the one place outside the tests that imports both packages:
it needs JAX and orbax to read the checkpoint and runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def convert(ckpt_dir: str, out: str) -> dict:
    """Read `ckpt_dir` with the JAX package, write `out` with the port's
    `save_checkpoint`; returns the port's checkpoint dict."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from ucd_torch.engine import checkpoint as port_ckpt
    from ucd_tpu.engine import checkpoint as jax_ckpt

    raw = jax_ckpt.load_checkpoint(ckpt_dir)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint at {ckpt_dir!r}")
    ck = port_ckpt.import_jax_checkpoint(raw)
    state = types.SimpleNamespace(
        params=ck["model_state"]["params"],
        batch_stats=ck["model_state"]["batch_stats"],
        opt_state=ck["optimizer_state"], step=ck["step"])
    port_ckpt.save_checkpoint(out, state, ck["epoch"], ck["best_score"])
    return ck


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt_dir", help="orbax step checkpoint of ucd_tpu")
    ap.add_argument("out", help="the port's checkpoint file to write")
    args = ap.parse_args(argv)
    ck = convert(args.ckpt_dir, args.out)
    heads = sorted({k.split(".")[0] for k in ck["model_state"]["params"]
                    if k.startswith("cls_")})
    print(f"wrote {args.out}: {len(ck['model_state']['params'])} "
          f"parameters, heads {heads}, epoch {ck['epoch']}, step "
          f"{ck['step']}, optimizer count {ck['optimizer_state']['count']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
