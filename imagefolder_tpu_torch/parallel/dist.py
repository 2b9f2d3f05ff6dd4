"""Process-level distribution (counterpart of the process half of
``imagefolder_tpu/parallel/mesh.py``; reference ``dist.py:20-49`` and
``utils/distributed.py:20-57``, the torchrun bootstrap).

A run is one process per card. ``init_distributed`` joins the process group
from explicit arguments (``--coordinator host:port --num_processes N
--process_id I``) or from torchrun's environment (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); with neither, or a world of one, it makes
no group and the helpers below are single-process no-ops. The backend is
NCCL when the card is there and gloo on the CPU. The device mesh and the
FSDP and TP sharding rules of the JAX module are not part of this layer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "add_distributed_args", "init_from_args", "process_index",
           "process_count", "is_primary", "sync_global_devices", "process_allgather"]


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the process group; True when a multi-process group was made,
    False for the single-process no-op (the reference's RANK-unset
    degradation, dist.py:25-29). Explicit arguments win over the
    environment."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator is None or not num_processes or num_processes <= 1:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id or 0)
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id or 0))
                              % torch.cuda.device_count())
    return True


def add_distributed_args(ap):
    """The multi-process flags every CLI takes."""
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (or torchrun's MASTER_ADDR/MASTER_PORT)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    return ap


def init_from_args(args) -> bool:
    return init_distributed(getattr(args, "coordinator", None),
                            getattr(args, "num_processes", None),
                            getattr(args, "process_id", None))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def sync_global_devices(name: str = "barrier"):
    """Cross-process barrier (the reference's ``dist.barrier()`` at its
    checkpoint sync sites); ``name`` labels the call site only."""
    del name
    if process_count() > 1:
        dist.barrier()


def process_allgather(arr) -> np.ndarray:
    """Every process's array of one shape and dtype, stacked: (P, ...) on
    the host (the reference's eval-sample ``dist.all_gather``)."""
    a = np.ascontiguousarray(np.asarray(arr))
    if process_count() == 1:
        return a[None]
    t = torch.from_numpy(a)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()
