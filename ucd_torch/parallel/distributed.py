"""Multi-process setup: the process-group rendezvous and each process's
device.

Counterpart of ucd_tpu/parallel/distributed.py. The JAX package runs one
SPMD program over the global batch whether it runs on one host or N; the
port runs one process a device and reproduces that program's math: the
train step's collectives (ucd_torch/parallel/collectives.py) make the
gradients, the train-mode BatchNorm statistics, the contrastive term's
anchors and contrast set, the loss metrics and the confusion matrix those
of the global batch. There is no per-rank semantics: with a process group
of any size, one included, the step computes what the one-process step
computes on the global batch, up to reduction order.

Launch, one process a GPU (NCCL), or a CPU process each under `--device
cpu` (gloo):

    UCD_TPU_COORDINATOR=host0:12345 UCD_TPU_NUM_PROCESSES=2 \\
    UCD_TPU_PROCESS_ID=$i  python -m ucd_torch.cli train ...

or pass --coordinator/--num_processes/--process_id (the coordinator is
`host:port`, or any `init_method` URL of torch.distributed, e.g.
`file:///shared/rdzv`), or start the processes with torchrun and pass
--distributed, which reads torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT / LOCAL_RANK (the counterpart of the JAX package's TPU-pod
auto-detection):

    torchrun --nproc_per_node 4 -m ucd_torch.cli train --distributed ...

Each process computes on `cuda:LOCAL_RANK` (LOCAL_RANK from the
environment, else the process id modulo the host's GPU count). A failed
rendezvous raises; nothing falls back to a single process. Checkpoints
are written by process 0 alone (ucd_torch/engine/experiment.py), so
--ckpt_dir must be storage every process can read.
"""

from __future__ import annotations

import datetime
import gc
import os
from typing import Optional

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_local_rank: Optional[int] = None


def backend_for(device) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(init_method: str, world_size: int, rank: int, device="cuda",
               local_rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group at `init_method` (a torch.distributed URL)
    as `rank` of `world_size`, on NCCL for a CUDA `device` and gloo for
    the CPU. On CUDA, this process's device becomes `cuda:local_rank`
    (default: `rank` modulo the host's GPU count). Raises if the
    rendezvous fails or times out."""
    global _local_rank
    backend = backend_for(device)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this host; pass "
                               "device='cpu' for a gloo group")
        if local_rank is None:
            local_rank = rank % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
        # the communicator is made here, not at the first collective, which
        # may sit inside a CUDA-graph capture
        kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _local_rank = local_rank


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     auto: bool = False, device="cuda",
                     timeout_s: Optional[float] = None) -> bool:
    """Join a process group from explicit args or the UCD_TPU_COORDINATOR /
    UCD_TPU_NUM_PROCESSES / UCD_TPU_PROCESS_ID env triple, or (`auto`, or
    UCD_TPU_DISTRIBUTED=1) from torchrun's environment. Returns True if a
    group was initialized (or already was).

    A no-op returning False when no multi-process configuration is present
    (one-process runs stay exactly as before), as the JAX function is. Must
    run before the first use of the device."""
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("UCD_TPU_COORDINATOR")
    if num_processes is None:
        n = os.environ.get("UCD_TPU_NUM_PROCESSES")
        num_processes = int(n) if n else None
    if process_id is None:
        p = os.environ.get("UCD_TPU_PROCESS_ID")
        process_id = int(p) if p else None
    auto = auto or os.environ.get("UCD_TPU_DISTRIBUTED") == "1"
    local = os.environ.get("LOCAL_RANK")
    local_rank = int(local) if local else None

    if coordinator is not None and num_processes and num_processes > 1:
        if process_id is None:
            # the JAX package's message, word for word
            raise ValueError(
                "multi-process launch needs a process id: pass --process_id "
                "(or set UCD_TPU_PROCESS_ID) alongside --coordinator/"
                "--num_processes, or use --distributed for auto-detection "
                "on TPU pods")
        init_method = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
        init_group(init_method, num_processes, process_id, device,
                   local_rank, timeout_s)
        return True
    if auto:
        missing = [k for k in _TORCHRUN_ENV if not os.environ.get(k)]
        if missing:
            raise ValueError(
                f"--distributed reads the launcher's environment (torchrun "
                f"sets it), but {', '.join(missing)} "
                f"{'is' if len(missing) == 1 else 'are'} not set")
        init_group("env://", int(os.environ["WORLD_SIZE"]),
                   int(os.environ["RANK"]), device, local_rank, timeout_s)
        return True
    return False


def process_device(device="cuda") -> torch.device:
    """This process's device: `cuda:LOCAL_RANK` for CUDA in a process
    group, else `device` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and _local_rank is not None \
            and dist.is_initialized():
        return torch.device("cuda", _local_rank)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one. Unreachable
    objects are collected and the device synchronized first: a captured
    CUDA graph that holds NCCL collectives must be gone before the
    communicator is."""
    global _local_rank
    if dist.is_available() and dist.is_initialized():
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()
    _local_rank = None


def local_batch_size(global_batch: int,
                     process_count: Optional[int] = None) -> int:
    """Per-process share of the global batch (the reference's per-GPU
    batch, README.md:52: total 24 = 12 x 2 ranks). Raises when the batch
    does not divide over the processes."""
    if process_count is None:
        process_count = dist.get_world_size() \
            if dist.is_available() and dist.is_initialized() else 1
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} must divide evenly "
                         f"over {process_count} processes")
    return global_batch // process_count
