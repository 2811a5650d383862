"""Multi-process training entry point (counterpart of
thermal3d/core/distributed.py), on torch.distributed.

One process drives one device. `initialize_multihost` joins this process
into a process group: NCCL when its device is a CUDA card, gloo when the
caller asks for the CPU (or names gloo, as the one-card multi-rank checks
do: NCCL refuses two ranks on one card). After it, `core.mesh.make_mesh()`
spans every rank of the group and the training loop runs in lockstep on
all of them.

A JAX process owns every device of its host; a torch process owns one GPU.
So `num_processes` here counts GPUs, not hosts: a job of 2 hosts with 4
cards each is 8 processes.

Determinism contract, as in the JAX package: every process computes the
same global shuffle order (same seed), and the process at data coordinate
p loads rows [p·B/P, (p+1)·B/P) of each global batch
(`BatchLoader(process_id=, process_count=)`), so the per-step global batch
is the one a single process would assemble.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_DEVICE = {"device": None}  # this process's device, set by initialize_multihost


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[str] = None,
                         backend: Optional[str] = None) -> Tuple[int, int]:
    """Join this process into a torch.distributed process group.

    Arguments fall back to the environment: first the JAX package's

      THERMAL3D_COORDINATOR    e.g. "10.0.0.1:8476"
      THERMAL3D_NUM_PROCESSES  processes in the job (one a GPU)
      THERMAL3D_PROCESS_ID     this process's rank, 0-based

    then torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK (the
    counterpart of JAX's topology autodetection). The process's device is
    cuda:LOCAL_RANK (LOCAL_RANK, else the rank modulo the host's card
    count), made the current CUDA device; device='cpu' runs on the CPU.
    backend: None picks NCCL for a CUDA device and gloo for the CPU; 'gloo'
    on a CUDA device is allowed and explicit (core.collectives stages its
    CUDA tensors through the host). A missing card raises, as
    core.device.resolve_device does. Returns (rank, world_size)."""
    coordinator_address = coordinator_address or os.environ.get("THERMAL3D_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("THERMAL3D_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("THERMAL3D_PROCESS_ID", "RANK")
    missing = [name for name, v in (("coordinator_address", coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"initialize_multihost: {', '.join(missing)} not given and not in "
                         "the environment (THERMAL3D_COORDINATOR / _NUM_PROCESSES / "
                         "_PROCESS_ID, or torchrun's MASTER_ADDR, WORLD_SIZE, RANK)")
    dev = local_device(process_id, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _DEVICE["device"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return process_info()


def local_device(rank: Optional[int] = None, device: Optional[str] = None) -> torch.device:
    """This process's device: the CPU when device names it, else
    cuda:LOCAL_RANK (raises without CUDA)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("thermal3d_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' explicitly to run on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = (rank or 0) % torch.cuda.device_count()
    return torch.device("cuda", local)


def process_device() -> torch.device:
    """The device initialize_multihost gave this process (the CPU when no
    group was initialised here)."""
    return _DEVICE["device"] or torch.device("cpu")


def process_info() -> Tuple[int, int]:
    """(rank, world_size): (0, 1) when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    """True on the process that owns logging and checkpoint writes."""
    return process_info()[0] == 0
