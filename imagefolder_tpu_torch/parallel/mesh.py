"""Device mesh and the FSDP and tensor-parallel sharding rules (counterpart
of the mesh half of ``imagefolder_tpu/parallel/mesh.py``; its process half
is ``parallel/dist.py``).

In JAX the shardings are placement only: XLA inserts every collective and
the semantics stay those of the global batch. Here each collective is
explicit, so a sharded step is held to the unsharded one by construction:

- ``make_mesh`` builds an ``init_device_mesh`` over the processes (one per
  card) and makes its ``data`` axis the data group of ``parallel/dist.py``'s
  reducing helpers: the batch is split over that axis only, and the ranks
  of one data group (the other axes) hold the same rows, as a batch sharded
  ``P("data")`` is replicated over the other axes in JAX.
- ``fsdp_shard_params`` applies FSDP2 (``fully_shard``) with the JAX rule's
  placement: each parameter split on its largest dimension that the fsdp
  axis divides, in flax's dimension order, and one under ``min_size`` or
  with no such dimension left replicated (outside FSDP2, its gradient
  averaged by the optimizer). On a data x fsdp mesh the data axis is FSDP2's
  replicate dimension (HSDP). FSDP2 reduce-scatters and averages the
  gradients it manages over both axes.
- ``tp_shard_params`` is Megatron's tensor parallelism by the JAX rule's
  layer names, on every model the rule reaches (VAR, the tokenizer's ViTs
  and linear ``ToPixel``, the RoPE decoder, RAR, MaskGIT): column layers
  (``mat_qkv``, ``qkv``, ``fc1``) split by output rows, row layers
  (``proj``, ``fc2``) by input columns. A packed qkv splits by heads (each
  rank holds the q, k and v rows of its own heads), so its attention
  kernel runs over those heads alone; the f and g functions below carry the
  model group's all-reduces.

The optimizer (``train/optim.py::ScheduledAdamW``) skips the gradients that
FSDP2 has reduced, averages the others over the data group, and sums the
square norms of sharded gradients over their shard groups, once each.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor, Replicate, Shard

from imagefolder_tpu_torch.parallel.dist import backend_for, set_data_group

__all__ = ["make_mesh", "shard_batch", "replicate", "fsdp_placements", "fsdp_shard_params",
           "tp_placements", "tp_shard_params", "full_tensor"]

# the JAX rule's Megatron layer names: column layers split by output, row
# layers by input (imagefolder_tpu/parallel/mesh.py)
_TP_COLUMN = {"mat_qkv", "qkv", "fc1", "q", "k", "v"}
_TP_ROW = {"proj", "fc2", "proj_out"}


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device="cuda") -> DeviceMesh:
    """A device mesh over the processes with dimension names ``axes``
    (``shape`` defaults to the whole world on the first axis), made the
    mesh in force: its ``data`` axis becomes the data group of the reducing
    helpers (``parallel/dist.py``). Without a process group (a run of one
    process) it first makes a world of one, with an in-process store."""
    if not tdist.is_initialized():
        tdist.init_process_group(backend_for(device), store=tdist.HashStore(), world_size=1,
                                 rank=0)
    axes = tuple(axes)
    if shape is None:
        shape = (tdist.get_world_size(),) + (1,) * (len(axes) - 1)
    mesh = init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=axes)
    if "data" in axes:
        set_data_group((mesh.get_group("data"), mesh.get_local_rank("data"),
                        mesh.shape[axes.index("data")]))
    else:
        set_data_group((None, 0, 1))
    return mesh


def _axis(mesh: DeviceMesh, axis: str) -> tuple:
    """(process group, this rank's coordinate, size) of ``axis``."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.shape[mesh.mesh_dim_names.index(axis)])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This process's rows of a global host batch (a tensor, an array or a
    dict, list or tuple of them, each with the global batch on dim 0), by
    its coordinate on ``axis``, on the mesh's device: ``DistributedSampler``
    semantics. A process that holds only its own loader shard (its data
    coordinate as the loader's ``shard_index``) uses that shard as it is."""
    _, rank, n = _axis(mesh, axis)

    def rows(x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows over {n} data shards")
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b].to(mesh.device_type)

    return _tree_map(rows, batch)


def replicate(tree, mesh: DeviceMesh):
    """A tree of tensors (or arrays) on the mesh's device, whole on every
    rank."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device_type), tree)


def _flax_paths(model: nn.Module) -> Dict[str, str]:
    """Each parameter's flax path, through the converter's key maps (VAR,
    RAR, MaskGIT) or its path rules (``flax_path``; the tokenizer, its
    decoders and the discriminators). A LoRA layer's base Dense sits under
    ``base`` in flax: the rules put it there for the MLP's ``fc1`` and
    ``fc2``, and here it is put there for ``qkv`` and ``proj`` with adapters
    (``lat_lora``)."""
    # the models import parallel/dist.py (through this package): imported
    # when first needed, not with this module
    from imagefolder_tpu_torch.models.maskgit import MaskGIT
    from imagefolder_tpu_torch.models.rar import RAR
    from imagefolder_tpu_torch.models.var import VAR
    from imagefolder_tpu_torch.models.vit import LoRALinear
    from imagefolder_tpu_torch.utils.convert import (flax_path, maskgit_key_map, rar_key_map,
                                                     var_key_map)

    key_map = (var_key_map(model.config) if isinstance(model, VAR)
               else rar_key_map(model.config.depth) if isinstance(model, RAR)
               else maskgit_key_map(model.config) if isinstance(model, MaskGIT) else None)
    if key_map is not None:
        return {name: path for name, (path, _) in key_map.items()}
    paths = {name: flax_path(name) for name, _ in model.named_parameters()}
    for prefix, m in model.named_modules():
        if isinstance(m, LoRALinear) and m.rank > 0:
            for leaf in ("weight", "bias"):
                name = f"{prefix}.{leaf}" if prefix else leaf
                if "/base/" not in paths[name]:
                    head, tail = paths[name].rsplit("/", 1)
                    paths[name] = f"{head}/base/{tail}"
    return paths


def _flax_dims(path: str, ndim: int) -> tuple:
    """The torch dimensions of a parameter in its flax array's dimension
    order (the converter's transposes): a Dense kernel's (in, out) is
    torch's dims (1, 0), a conv kernel's (k, in, out) (2, 1, 0) and (kh,
    kw, in, out) (2, 3, 1, 0); a Dense kernel kept as a 1x1 conv, (in, out)
    as torch's (out, in, 1, 1), picks as the conv order does (the two size-1
    dims never win). Every other leaf is in torch's order."""
    if path.rsplit("/", 1)[-1] == "kernel" and ndim in (2, 3, 4):
        return {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[ndim]
    return tuple(range(ndim))


def fsdp_placements(model: nn.Module, n: int, min_size: int = 2 ** 18) -> dict:
    """The JAX rule (``fsdp_shard_params``) on an fsdp axis of size ``n``:
    {parameter name: ``Shard(d)``, d a torch dimension, or ``Replicate()``}.
    A parameter of fewer than ``min_size`` entries, or with no dimension
    that ``n`` divides, is replicated; else it is split on its largest
    divisible dimension, ties going to the first in flax's order."""
    paths = _flax_paths(model)
    out = {}
    for name, p in model.named_parameters():
        order = _flax_dims(paths[name], p.ndim)
        fshape = [p.shape[t] for t in order]
        out[name] = Replicate()
        if p.ndim and p.numel() >= min_size:
            for d in sorted(range(p.ndim), key=lambda d: -fshape[d]):
                if fshape[d] % n == 0:
                    out[name] = Shard(order[d])
                    break
    return out


def _blocks(model: nn.Module):
    """The elements of every ``blocks`` list (transformer blocks): each is an
    FSDP2 unit of its own, so that one block's parameters are gathered at a
    time."""
    for name, module in model.named_modules():
        if name.rsplit(".", 1)[-1] == "blocks" and isinstance(module, nn.ModuleList):
            yield from module


def fsdp_shard_params(model: nn.Module, mesh: DeviceMesh, axis: str = "fsdp",
                      min_size: int = 2 ** 18) -> dict:
    """Shard ``model``'s parameters over ``axis`` with FSDP2 by the JAX rule
    (``fsdp_placements``; the replicated ones stay outside FSDP2), each
    ``blocks`` element a unit and the model the root; on a mesh with a
    ``data`` axis that axis is FSDP2's replicate dimension (HSDP). The
    model's public methods besides ``forward`` (``VAR.decode_stage``,
    ``VQModel.img_to_idxBl``, ...) are registered with FSDP2, so that they
    gather the parameters as ``forward`` does. Returns the placement on
    ``axis`` of each parameter, by name. Build the optimizer and any EMA
    copy after this: FSDP2 replaces the parameters."""
    _, _, n = _axis(mesh, axis)
    placements = fsdp_placements(model, n, min_size)
    params = dict(model.named_parameters())
    by_param = {params[k]: pl for k, pl in placements.items() if pl.is_shard()}
    ignored = {params[k] for k, pl in placements.items() if not pl.is_shard()}
    entry_points = [name for name, f in vars(type(model)).items()
                    if inspect.isfunction(f) and not name.startswith("_") and name != "forward"]
    sub = mesh[("data", axis)] if "data" in mesh.mesh_dim_names else mesh[axis]
    kw = dict(mesh=sub, shard_placement_fn=by_param.get, ignored_params=ignored)
    for block in list(_blocks(model)):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    for name in entry_points:
        register_fsdp_forward_method(model, name)
    return placements


def tp_placements(model: nn.Module, n: int) -> dict:
    """The JAX rule (``tp_shard_params``) on a model axis of size ``n``, on
    any model: {parameter name: ``Shard(d)`` or ``Replicate()``}. The 2-D
    kernels of column layers (``mat_qkv``, ``qkv``, ``fc1``, ``q``, ``k``,
    ``v``) split by output (torch dim 0) and their biases with them, those
    of row layers (``proj``, ``fc2``, ``proj_out``) by input (torch dim 1),
    each where ``n`` divides that dimension; every other parameter is
    replicated. The names are the flax paths' (``_flax_paths``), so a LoRA
    layer's base kernel (``.../fc1/base/kernel``) and a conv's 4-D kernel
    never split, as in JAX."""
    paths = _flax_paths(model)
    out = {}
    for name, p in model.named_parameters():
        parts = paths[name].split("/")
        leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
        order = _flax_dims(paths[name], p.ndim)
        fshape = [p.shape[t] for t in order]
        out[name] = Replicate()
        if leaf == "kernel" and p.ndim == 2:
            if parent in _TP_COLUMN and fshape[1] % n == 0:
                out[name] = Shard(order[1])
            elif parent in _TP_ROW and fshape[0] % n == 0:
                out[name] = Shard(order[0])
        elif leaf == "bias" and parent in _TP_COLUMN and p.ndim == 1 and p.shape[0] % n == 0:
            out[name] = Shard(0)
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    model group backward (every rank's heads read the same input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverModel(torch.autograd.Function):
    """Megatron's g: the partial products of a row layer summed over the
    model group forward, the identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOverModel(torch.autograd.Function):
    """A parameter's shards gathered whole over the model group forward
    (every rank then computes the same thing with it), this rank's slice of
    the whole gradient backward."""

    @staticmethod
    def forward(ctx, t, group, rank, dim):
        ctx.rank, ctx.dim, ctx.size = rank, dim, tdist.get_world_size(group)
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, None, None


class _OnFirstRank(torch.autograd.Function):
    """The tensor on the model group's first rank and zeros on the others
    forward, the gradient passed to every rank backward: a term that a row
    layer's partial products carry into g once (``ModelShard.first``)."""

    @staticmethod
    def forward(ctx, x, rank):
        return x.view_as(x) if rank == 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelShard:
    """This rank's share of a model axis (the ``tp`` of the split modules):
    ``enter`` and ``leave`` are f and g, ``heads`` this rank's slice of a
    whole tensor along ``dim`` (a replicated per-head parameter, a row
    layer's input) through f, so that its gradient is the sum of every
    rank's slices, ``first`` a term that rank 0 alone adds to
    a partial product before g, ``whole`` a split parameter gathered for a
    layer that computes it whole. Shared, not copied, by a deep copy of the
    model (an EMA copy keeps the group)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def __deepcopy__(self, memo):
        return self

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _CopyToModel.apply(x, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.size == 1 else _SumOverModel.apply(y, self.group)

    def heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        k = t.shape[dim] // self.size
        return self.enter(t).narrow(dim, self.rank * k, k)

    def first(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else _OnFirstRank.apply(t, self.rank)

    def whole(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t if self.size == 1 else _GatherOverModel.apply(t, self.group, self.rank, dim)


def _keep(module: nn.Module, name: str, local: torch.Tensor, group, dim: int,
          chunks: int = 1) -> None:
    """Replace ``module.<name>`` by this rank's shard ``local``, tagged with
    the group it is split over (``ScheduledAdamW`` reads ``shard_group``),
    the dimension and the number of runs of it each rank holds
    (``full_tensor`` reads ``shard_dim`` and ``shard_chunks``: 3 for the q,
    k and v rows of a packed qkv)."""
    old = getattr(module, name)
    new = nn.Parameter(local.detach().clone(), requires_grad=old.requires_grad)
    new.shard_group, new.shard_dim, new.shard_chunks = group, dim, chunks
    setattr(module, name, new)


class _Splitter:
    """Splits the layers the rule names, module by module, over one model
    group; ``split`` holds the parameters the rule splits."""

    def __init__(self, model: nn.Module, placements: dict, shard: ModelShard):
        self.shard, self.group = shard, shard.group
        self.split = {id(p) for name, p in model.named_parameters() if placements[name].is_shard()}

    def _cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        k = t.shape[dim] // self.shard.size
        return t.narrow(dim, self.shard.rank * k, k)

    def qkv(self, layer: nn.Module, heads: int) -> bool:
        """A packed qkv split by heads: the q, k and v rows of this rank's
        heads (and their bias entries). False where the rule leaves it."""
        if id(layer.weight) not in self.split:
            return False
        n, r = self.shard.size, self.shard.rank
        if heads % n:
            raise ValueError(f"{heads} heads do not split over {n} model ranks")
        h, hd = heads // n, layer.weight.shape[0] // (3 * heads)
        w = layer.weight.view(3, heads, hd, -1)[:, r * h:(r + 1) * h]
        _keep(layer, "weight", w.reshape(3 * h * hd, -1), self.group, 0, 3)
        if getattr(layer, "bias", None) is not None:
            b = layer.bias.view(3, heads, hd)[:, r * h:(r + 1) * h]
            _keep(layer, "bias", b.reshape(-1), self.group, 0, 3)
        return True

    def column(self, layer: nn.Module) -> bool:
        """A column layer: this rank's output rows and bias entries."""
        if id(layer.weight) not in self.split:
            return False
        _keep(layer, "weight", self._cut(layer.weight, 0), self.group, 0)
        if getattr(layer, "bias", None) is not None:
            _keep(layer, "bias", self._cut(layer.bias, 0), self.group, 0)
        return True

    def row(self, layer: nn.Module) -> bool:
        """A row layer: this rank's input columns; the bias stays whole."""
        if id(layer.weight) not in self.split:
            return False
        _keep(layer, "weight", self._cut(layer.weight, 1), self.group, 1)
        return True

    def bias_only(self, layer: nn.Module) -> None:
        """A layer whose kernel the rule leaves whole but whose bias it
        splits (a conv named q, k or v: its kernel is 4-D): this rank keeps
        its bias entries, and ``layer.tp`` gathers them for the whole
        output."""
        if id(layer.bias) in self.split and id(layer.weight) not in self.split:
            _keep(layer, "bias", self._cut(layer.bias, 0), self.group, 0)
            layer.tp = self.shard

    def attention(self, attn: nn.Module, heads: int, qkv: str = "qkv") -> None:
        """A head-split attention: its packed qkv and ``proj`` split
        together, ``attn.tp`` set."""
        split = self.qkv(getattr(attn, qkv), heads), self.row(attn.proj)
        if split[0] != split[1]:
            raise ValueError(f"the rule splits one of {qkv} and proj: {split}")
        if split[0]:
            attn.tp = self.shard

    def mlp(self, mlp: nn.Module) -> None:
        """An MLP split by hidden units (``fc1`` by rows, ``fc2`` by
        columns), ``mlp.tp`` set."""
        split = self.column(mlp.fc1), self.row(mlp.fc2)
        if split[0] != split[1]:
            raise ValueError(f"the rule splits one of fc1 and fc2: {split}")
        if split[0]:
            mlp.tp = self.shard


def tp_shard_params(model: nn.Module, mesh: DeviceMesh, axis: str = "model") -> dict:
    """Split ``model``'s column and row layers over ``axis`` by the JAX rule
    (``tp_placements``), on every model it reaches: VAR (``mat_qkv``,
    ``proj``, ``fc1``, ``fc2``), the ViTs of the tokenizer and its teachers
    (each block's ``qkv`` and ``proj``; the MLP's ``fc1`` and ``fc2`` are
    LoRA base kernels the rule leaves whole, and under ``lat_lora`` so are
    ``qkv`` and ``proj``), the RoPE decoder, ``ToPixel``'s linear ``proj``
    (a row layer alone), RAR and MaskGIT (``qkv``, ``proj``, ``fc1``,
    ``fc2``); the CNN tokenizer's q, k, v and proj_out kernels are 4-D and
    never split, but the rule splits the biases of q, k and v, which each
    rank keeps its share of and gathers whole in the forward
    (``ModelShard.whole``). Each packed qkv keeps the q, k and v rows of
    this rank's H / n heads, a column layer its rows and bias entries, a row
    layer its input columns (its bias is added after the sum over the
    group); every other parameter stays whole, and
    the modules that read per-head ones take their heads' slices through
    ``ModelShard.heads``. Raises ``ValueError`` where the heads do not
    divide over the axis. Returns the placement of each parameter, by name.
    Build the optimizer and any EMA copy after this: the split parameters
    are new."""
    from imagefolder_tpu_torch.models import cnn, maskgit, rar, var, vit

    group, rank, n = _axis(mesh, axis)
    placements = tp_placements(model, n)
    cut = _Splitter(model, placements, ModelShard(group, rank, n))
    for m in model.modules():
        if isinstance(m, var.VARSelfAttention):
            cut.attention(m, m.num_heads, "mat_qkv")
        elif isinstance(m, (var.FFN, rar.RARMlp)):
            cut.mlp(m)
        elif isinstance(m, vit.Block):
            cut.attention(m.attn, m.num_heads)
        elif isinstance(m, vit.ToPixel) and m.mode == "linear":
            if cut.row(m.model):
                m.tp = cut.shard
        elif isinstance(m, rar.RARAttention):
            cut.attention(m, m.num_heads)
        elif isinstance(m, maskgit.MaskGITBlock):
            cut.attention(m.attn, m.num_heads)
            cut.mlp(m.mlp)
        elif isinstance(m, cnn.Conv):
            cut.bias_only(m)
    split = {name for name, p in model.named_parameters() if hasattr(p, "shard_group")}
    if split != {name for name, pl in placements.items() if pl.is_shard()}:
        raise AssertionError(f"split {sorted(split)} is not the rule's {placements}")
    return placements


def full_tensor(t: torch.Tensor, param: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's shard: an FSDP2
    DTensor's shards gathered over each sharded mesh dimension; a
    tensor-parallel shard of ``param`` (``t`` itself, or its gradient or an
    optimizer moment) gathered over the model group in the layout
    ``tp_shard_params`` split; any other tensor itself. A collective: every
    rank of the group calls it. The gathers are c10d's ``all_gather``
    (``DTensor.full_tensor``'s functional collectives crash on gloo's CUDA
    tensors in torch 2.11); the JAX rule splits only divisible dimensions,
    so the shards are equal."""
    if isinstance(t, DTensor):
        whole = t.to_local()
        for i, pl in enumerate(t.placements):
            if pl.is_shard():
                whole = _gather(whole, t.device_mesh.get_group(i), pl.dim)
        return whole
    p = t if param is None else param
    group = getattr(p, "shard_group", None)
    if group is None:
        return t
    return _gather(t, group, p.shard_dim, p.shard_chunks)


def _gather(t: torch.Tensor, group, dim: int, chunks: int = 1) -> torch.Tensor:
    """Every rank's ``t`` along ``dim``, each holding ``chunks`` runs of it
    (the whole is run 0 of every rank, then run 1, ...)."""
    parts = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, t.contiguous(), group=group)
    runs = [part.chunk(chunks, dim) for part in parts]
    return torch.cat([torch.cat([r[c] for r in runs], dim) for c in range(chunks)], dim)
