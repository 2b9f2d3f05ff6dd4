"""Process-level distribution (counterpart of the process half of
``imagefolder_tpu/parallel/mesh.py``; reference ``dist.py:20-49`` and
``utils/distributed.py:20-57``, the torchrun bootstrap).

A run is one process per card. ``init_distributed`` joins the process group
from explicit arguments (``--coordinator host:port --num_processes N
--process_id I``) or from torchrun's environment (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); with neither, or a world of one, it makes
no group and the helpers below are single-process no-ops. The backend
follows the device the caller names: NCCL for ``cuda``, gloo for ``cpu``.
The device mesh and the FSDP and TP sharding rules are ``parallel/mesh.py``.

Data parallelism (what the JAX package's sharded jit gives its trainers):
every process holds the same parameters and steps on its own equal shard
of the global batch, process p holding rows [p b, (p + 1) b) of it. The
global loss is the mean over processes of each process's loss, so a
trainer averages its gradients over the group (``all_reduce_mean_``) after
the backward and before the clip, and each statistic of the batch is taken
over the global batch: ``global_sum`` and ``global_mean`` of a small tensor
and ``all_gather_batch`` of per-sample rows. The three are differentiable:
their backwards add up what every process's loss asks of this process's
input (an all-reduce of the incoming gradient), which, once the gradients
are averaged, gives the gradient of the global loss. In a world of one
each returns its input.

Under a device mesh (``parallel/mesh.py::make_mesh``) the batch is split
over the mesh's ``data`` axis only: the processes of one data group (the
fsdp or model ranks at one data coordinate) hold the same rows. The
reducing helpers and ``own_rows``/``global_batch_rows`` then act on the
data axis (the "data group": its process group, this process's coordinate
on it and its size) instead of the world, so that no row is counted twice;
a mesh without a data axis is a data group of one. ``process_index``,
``process_count`` and ``is_primary`` stay the world's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "add_distributed_args", "init_from_args", "backend_for",
           "process_index", "process_count", "is_primary", "sync_global_devices",
           "process_allgather", "set_data_group", "data_count",
           "all_reduce_mean_", "global_sum", "global_mean", "all_gather_batch",
           "global_metrics", "global_batch_rows", "own_rows"]

# the data group of the mesh in force, (process group, this process's
# coordinate, size); None: the world (set_data_group)
_DATA: Optional[Tuple[Optional[dist.ProcessGroup], int, int]] = None


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``: NCCL for ``cuda``
    (which must be there), gloo for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: torch.cuda.is_available() is False")
        return "nccl"
    if dev.type != "cpu":
        raise ValueError(f"no collective backend for device {device}")
    return "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> bool:
    """Join the process group; True when a multi-process group was made,
    False for the single-process no-op (the reference's RANK-unset
    degradation, dist.py:25-29). Explicit arguments win over the
    environment. The backend is ``backend_for(device)``: asked for the card
    on a machine without one, it raises."""
    backend = backend_for(device)
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


def init_from_args(args, device) -> bool:
    """``init_distributed`` from the CLI flags, for a run on ``device``."""
    return init_distributed(getattr(args, "coordinator", None),
                            getattr(args, "num_processes", None),
                            getattr(args, "process_id", None), device)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def set_data_group(data: Optional[Tuple[Optional[dist.ProcessGroup], int, int]]) -> None:
    """Set the data group of the reducing helpers: (its process group, this
    process's coordinate on it, its size), as ``make_mesh`` sets it from its
    data axis (a mesh without one: (None, 0, 1)); None makes it the world
    again."""
    global _DATA
    _DATA = data


def _data() -> Tuple[Optional[dist.ProcessGroup], int, int]:
    if _DATA is not None:
        return _DATA
    return None, process_index(), process_count()


def data_count() -> int:
    """The number of shards of the batch: the data axis's size."""
    return _data()[2]


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


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Each tensor of ``tensors`` (gradients) replaced in place by its mean
    over the data group, as one flat all-reduce per dtype (the tensors are
    packed into one buffer, reduced, and unpacked)."""
    group, _, p = _data()
    if p == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(p)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y, group=_data()[0])
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_data()[0])
        return g


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        group, _, p = _data()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(p)]
        dist.all_gather(parts, x, group=group)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        group, rank, _ = _data()
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        i = rank * ctx.rows
        return g[i:i + ctx.rows]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group (a batch's hit counts, a sum of
    weights); differentiable (module docstring)."""
    return x if data_count() == 1 else _GlobalSum.apply(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data group: a mean over each process's
    equal shard becomes the mean over the global batch; differentiable."""
    return x if data_count() == 1 else _GlobalSum.apply(x) / data_count()


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every data shard's ``x`` (rows of one shard of the batch, one shape
    on every process) concatenated along dim 0 in data order: the rows of
    the global batch. Differentiable (module docstring)."""
    return x if data_count() == 1 else _GatherBatch.apply(x)


def global_metrics(metrics: dict) -> dict:
    """A dict of tensors (a step's metrics, each a mean over this process's
    shard) as their means over the data group, in one all-reduce; the dict
    itself with one shard. Without gradient."""
    group, _, p = _data()
    if p == 1 or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.cat([metrics[k].detach().float().reshape(-1) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= p
    out, off = {}, 0
    for k in keys:
        t = metrics[k]
        out[k] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
        off += t.numel()
    return out


def global_batch_rows(local_rows: int) -> tuple:
    """(first row of this process's shard in the global batch, the global
    batch's rows), for a process holding ``local_rows`` of an equal
    sharding over the data group."""
    _, rank, p = _data()
    return rank * local_rows, p * local_rows


def own_rows(x, local_rows: int):
    """This process's ``local_rows`` rows of ``x``, a tensor over the global
    batch (a random draw made for the whole batch, so that every process's
    generator stays in step and the draws are those of one process on the
    global batch); ``x`` itself with one shard."""
    _, rank, p = _data()
    if p == 1:
        return x
    i = rank * local_rows
    return x[i:i + local_rows]
