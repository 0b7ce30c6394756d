"""Build and load the port's CUDA kernels.

Each `ops/csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with ctypes. The build
happens at first use, from the sources in the package, into
`ucd_torch/_build/` (listed in .gitignore). The library's file name carries
a hash of its source and of every header (`csrc/*.cuh`) beside it, so an
edited kernel or header is never served by a stale build;
`-Xptxas -v` output (registers, shared memory, spills) is kept beside it in
a `.log` file.

Nothing here runs at import time: the CPU-only test host has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the port's CUDA kernels "
                           "are built from source at first use")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is built: its name carries a
    hash of the source and of all headers in csrc/ (any source may include
    any of them)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> None:
    """Compile every missing library of `names`, one nvcc per source, all
    started together. Raises with the compiler's output if one fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        so = library_path(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `ops/csrc/<name>.cu`, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def kernel_sources() -> list:
    """Every kernel source of the package, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
