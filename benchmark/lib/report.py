"""What a run prints: the numbers it compared beside their limits, on
standard error and as the last key of the result line, and the result
line itself, the last line of standard output. Also the import guard and
the card's description."""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "ucd_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Modules whose top-level name (before the first dot) is a JAX one or
    the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def device_info(count: int, trace: Optional[dict] = None) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def checks_line(checks: List[dict]) -> Dict[str, dict]:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in checks}


def emit(result: dict, checks: List[dict]) -> None:
    """Print the compared numbers last on standard error and the result
    line last on standard output, its "checks" key last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks_line(checks)
    print(json.dumps(line), flush=True)
