"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Asking for CUDA on a host without a GPU raises:
    the port never moves to the CPU on its own, so a CPU run is always one
    the caller asked for (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run on the CPU")
    return dev
