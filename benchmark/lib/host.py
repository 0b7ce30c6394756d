"""The record of the host a run sits on: one line on standard error.

Nothing is set: the run keeps the CPUs, threads and memory placement it
was started with. The line names the CPUs the process may use, the card's
PCI address and the NUMA node that sysfs gives it (or why it gives none),
the torch thread count, the load averages at the window's start and end,
and the window's dispatch times.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

SYS_PCI = "/sys/bus/pci/devices"


def format_cpulist(cpus: Iterable[int]) -> str:
    """The shortest cpulist of `cpus`: {0, 1, 2, 3, 8} -> "0-3,8"."""
    runs: List[List[int]] = []
    for c in sorted(cpus):
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(str(a) if a == b else f"{a}-{b}" for a, b in runs)


def card_address(device) -> Optional[str]:
    """The sysfs PCI address of a CUDA `device`, e.g. "0000:19:00.0"; None
    for another device."""
    if device.type != "cuda":
        return None
    import torch

    p = torch.cuda.get_device_properties(device)
    return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


def card_node(address: Optional[str], sys_pci: str = SYS_PCI) -> str:
    """The NUMA node of the card at `address` as sysfs gives it, or why
    there is none."""
    if address is None:
        return "no card"
    try:
        with open(os.path.join(sys_pci, address, "numa_node")) as f:
            node = int(f.read())
    except (OSError, ValueError) as e:
        return f"no NUMA node ({type(e).__name__})"
    return f"node {node}" if node >= 0 else "no NUMA node (-1)"


def line(address: Optional[str], load: Sequence[Sequence[float]],
         threads: int, dispatch_s: Sequence[float],
         sys_pci: str = SYS_PCI) -> str:
    """The run's host record: the CPUs allowed, the card (`address`) and
    its node, the thread count, the load averages at the window's start
    and end (`os.getloadavg()`), and the window's dispatch times in
    seconds."""
    cpus = format_cpulist(os.sched_getaffinity(0))
    card = f"card {address}, " if address else ""
    load = " -> ".join(" ".join(f"{x:.2f}" for x in la) for la in load)
    d = (f"dispatch mean {1e3 * sum(dispatch_s) / len(dispatch_s):.2f} ms, "
         f"max {1e3 * max(dispatch_s):.2f} ms over {len(dispatch_s)} calls"
         if dispatch_s else "dispatch not timed")
    return (f"host: CPUs {cpus} ({card}{card_node(address, sys_pci)}); "
            f"torch threads {threads}; load {load}; {d}")
