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
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "add_distributed_args", "init_from_args", "process_index",
           "process_count", "is_primary", "sync_global_devices", "process_allgather",
           "all_reduce_mean_", "global_sum", "global_mean", "all_gather_batch",
           "global_metrics", "global_batch_rows", "own_rows"]


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


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Each tensor of ``tensors`` (gradients) replaced in place by its mean
    over the processes, as one flat all-reduce per dtype (the tensors are
    packed into one buffer, reduced, and unpacked)."""
    if process_count() == 1 or not tensors:
        return
    p = process_count()
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(p)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(process_count())]
        dist.all_gather(parts, x)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        i = process_index() * ctx.rows
        return g[i:i + ctx.rows]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes (a batch's hit counts, a sum of
    weights); differentiable (module docstring)."""
    return x if process_count() == 1 else _GlobalSum.apply(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the processes: a mean over each process's
    equal shard becomes the mean over the global batch; differentiable."""
    return x if process_count() == 1 else _GlobalSum.apply(x) / process_count()


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (rows of one shard of the batch, one shape on
    every process) concatenated along dim 0 in process order: the rows of
    the global batch. Differentiable (module docstring)."""
    return x if process_count() == 1 else _GatherBatch.apply(x)


def global_metrics(metrics: dict) -> dict:
    """A dict of tensors (a step's metrics, each a mean over this process's
    shard) as their means over the processes, in one all-reduce; the dict
    itself in a world of one. Without gradient."""
    if process_count() == 1 or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.cat([metrics[k].detach().float().reshape(-1) for k in keys])
    dist.all_reduce(flat)
    flat /= process_count()
    out, off = {}, 0
    for k in keys:
        t = metrics[k]
        out[k] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
        off += t.numel()
    return out


def global_batch_rows(local_rows: int) -> tuple:
    """(first row of this process's shard in the global batch, the global
    batch's rows), for a process holding ``local_rows`` of an equal
    sharding."""
    return process_index() * local_rows, process_count() * local_rows


def own_rows(x, local_rows: int):
    """This process's ``local_rows`` rows of ``x``, a tensor over the global
    batch (a random draw made for the whole batch, so that every process's
    generator stays in step and the draws are those of one process on the
    global batch); ``x`` itself in a world of one."""
    if process_count() == 1:
        return x
    i = process_index() * local_rows
    return x[i:i + local_rows]
