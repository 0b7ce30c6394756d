#!/usr/bin/env python
"""Verify the running environment against environment/requirements_torch.lock,
the stack the PyTorch/CUDA port's card numbers were taken on
(environment/MANIFEST_torch.md).

torch (its release and its CUDA build), the CUDA runtime torch was built
against, and the `nvcc` release that compiles the kernels of
ucd_torch/ops/csrc/ are CRITICAL: they move the kernels' code and the
library kernels around them, so a mismatch exits 1. Everything else
prints a drift warning only.

`--cpu`: a host that runs the port on the CPU only (the tests,
`--device cpu`), where no CUDA build is needed: torch is compared by its
release alone, as drift, and neither the CUDA runtime nor nvcc is
checked.

Usage: python scripts/check_env_torch.py [--cpu] [--quiet]
"""

from __future__ import annotations

import importlib.metadata as md
import os
import re
import shutil
import subprocess
import sys

CRITICAL = {"torch", "cuda", "nvcc"}
# pins that are not Python distributions
NOT_PACKAGES = {"cuda", "nvcc"}


def load_lock(path: str) -> dict[str, str]:
    pins = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, _, ver = line.partition("==")
            pins[name.strip()] = ver.strip()
    return pins


def torch_cuda() -> str | None:
    """The CUDA runtime torch was built against (None: a CPU build)."""
    try:
        import torch
    except ImportError:
        return None
    return torch.version.cuda


def nvcc_release() -> str | None:
    """`nvcc --version`'s full release (e.g. 12.8.93), from $CUDA_HOME,
    /usr/local/cuda or PATH; None where there is no nvcc."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc")
    if nvcc is None:
        return None
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    m = re.search(r"V(\d+\.\d+\.\d+)", out)
    return m.group(1) if m else None


def installed(name: str) -> str | None:
    if name == "cuda":
        return torch_cuda()
    if name == "nvcc":
        return nvcc_release()
    try:
        return md.version(name)
    except md.PackageNotFoundError:
        return None


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quiet, cpu = "--quiet" in argv, "--cpu" in argv
    lock = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "environment", "requirements_torch.lock")
    pins = load_lock(lock)
    failures, drift, skipped = [], [], []
    for name, want in pins.items():
        if cpu and name in NOT_PACKAGES:
            skipped.append(name)
            continue
        have = installed(name)
        if cpu and name == "torch" and have is not None:
            # the release alone: a CPU build carries another local tag
            want, have = want.split("+")[0], have.split("+")[0]
        if have == want:
            continue
        row = f"{name}: locked {want}, installed {have or 'MISSING'}"
        critical = name in CRITICAL and not cpu
        (failures if critical else drift).append(row)
    if not quiet:
        if skipped:
            print(f"[check_env_torch] CPU host: {', '.join(skipped)} not "
                  "checked")
        for row in drift:
            print(f"[check_env_torch] drift: {row}")
        for row in failures:
            print(f"[check_env_torch] CRITICAL mismatch: {row}")
        if not failures and not drift:
            print("[check_env_torch] environment matches "
                  "requirements_torch.lock")
        elif not failures:
            print("[check_env_torch] non-critical drift only: card numbers "
                  "may shift slightly; re-pin after re-measuring")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
