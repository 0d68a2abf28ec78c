"""Device mesh, sharding rules and the collectives of the sharded step.

Port of mmoe_multimodal_rec_tpu/parallel/mesh.py over torch.distributed,
one process per GPU (torchrun; `train --multihost`).  The mesh is the JAX
one, `data` x `model` with `model` innermost, so ranks r*mp .. r*mp+mp-1
form one model group:

- `data`: data parallelism.  A rank holds its share of the global
  micro-batch (`batch_shardings`): samples [r*B/dp, (r+1)*B/dp), chunk rows
  [r*N/dp, (r+1)*N/dp), and the small sentence index arrays whole, since a
  sentence may point into another rank's chunk rows.  Where JAX's SPMD step
  lets XLA reduce across the global batch, the port says so in place:
  HoME's BatchNorm moments, the sentence gather, the losses' denominators,
  the contrastive pool and the top-k balance term go through
  `sum_over_data` / `gather_over_data`, and every dropout mask keys on the
  global index (models/layers).  Each rank's loss is its share of the
  global mean, so the SUM of the ranks' gradients (train/step.py, one
  bucketed all-reduce a step) is the one-process gradient.
- `model`: Megatron-style tensor parallelism after JAX's `_param_spec`
  rules (`param_shardings`): q/k/v (with their LoRA `lora_b`) and mlp/fc1
  column-parallel, attention `out` and mlp/fc2 row-parallel, wherever the
  names occur (the encoders, the cross expert, the fuse experts).
  `copy_to_model` (identity forward, all-reduce backward) feeds a
  column-parallel layer and `reduce_from_model` (all-reduce forward,
  identity backward) ends a row-parallel one (models/layers.Dense).

A mesh axis of one rank runs the one-process code (no collective, no
offset).  Collectives take NCCL for CUDA tensors and gloo for CPU ones;
nothing falls back to one process when the group cannot form.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..config import MeshConfig


@dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its size, the rank's index along it,
    and the process group of the ranks that differ only along it (None
    without a process group, then size is what the layout says)."""
    size: int
    rank: int = 0
    group: Any = None


@dataclass(frozen=True)
class Mesh:
    """The `data` x `model` grid and this rank's place on it."""
    data: Axis
    model: Axis
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data.size, self.model.size


def make_mesh(cfg: Optional[MeshConfig] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The mesh of `cfg` over `world_size` ranks (default: the process
    group's, or 1 without one), `model` innermost as JAX's reshape(dp, mp).
    data_parallel None takes every rank the model axis leaves.  Raises
    ValueError where JAX does (dp*mp larger than the ranks).  In a process
    group the mesh must cover every rank, and its data and model groups are
    made here (every rank calls this, in the same order); with
    `world_size` given it is the layout alone, with no group."""
    cfg = cfg or MeshConfig()
    grouped = world_size is None and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if grouped else 1
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel or world_size // mp
    if dp * mp > world_size:
        raise ValueError(f"mesh {dp}x{mp} > {world_size} devices")
    names = (cfg.data_axis, cfg.model_axis)
    if not grouped:
        return Mesh(Axis(dp), Axis(mp), names)
    if dp * mp != world_size:
        raise ValueError(f"mesh {dp}x{mp} leaves ranks of {world_size} "
                         "idle: every process trains on the mesh")
    d, m = divmod(dist.get_rank(), mp)
    data_group = model_group = None
    for j in range(mp):
        g = dist.new_group([i * mp + j for i in range(dp)])
        data_group = g if j == m else data_group
    for i in range(dp):
        g = dist.new_group([i * mp + j for j in range(mp)])
        model_group = g if i == d else model_group
    return Mesh(Axis(dp, d, data_group), Axis(mp, m, model_group), names)


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on cuda:LOCAL_RANK, or gloo
    when `device` is cpu.  Returns this rank's device; raises when the
    environment lacks a variable or the group cannot form."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost runs under torchrun, which sets "
                           f"{missing}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device=cpu to train "
                               "on gloo and the plain PyTorch path")
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return dev


# ---------------------------------------------------------------------------
# Param sharding rules (carried across from the JAX package as they are)
# ---------------------------------------------------------------------------

_COL_PARALLEL = ("query", "key", "value")   # out-dim sharded
_ROW_PARALLEL = ("out",)                    # in-dim sharded


def _param_spec(path: Tuple[str, ...], ndim: int) -> Tuple[Optional[str], ...]:
    """JAX's TP rule of the param at JAX `path` (a leaf of rank `ndim`), as
    a PartitionSpec's tuple: "model" on the split dimension."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    gparent = path[-3] if len(path) >= 3 else ""
    col = lambda kern: (None, "model") if kern == "kernel" else ("model",)
    row = lambda kern: ("model", None) if kern == "kernel" else (None,)

    def fit(spec):
        # stacked layouts add leading axes that are never sharded (the
        # shared base's [2] sides of lora_a / lora_b)
        return (None,) * (ndim - len(spec)) + spec

    if name in ("kernel", "bias"):
        if parent in _COL_PARALLEL or (parent == "base" and
                                       gparent in _COL_PARALLEL):
            return fit(col(name))
        if parent in _ROW_PARALLEL:
            return fit(row(name))
        if parent == "fc1" and gparent == "mlp":
            return fit(col(name))
        if parent == "fc2" and gparent == "mlp":
            return fit(row(name))
    if name == "lora_b" and parent in _COL_PARALLEL:
        return fit((None, "model"))
    return ()


def param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """For each parameter of `model` by name, the dimension of the port's
    tensor split over `model` (None: replicated), from JAX's `_param_spec`
    over the parameter's JAX path (utils/convert.params_from_jax's naming
    backwards: a Dense `weight` [out, in] is the JAX `kernel` [in, out]).
    On a model axis of one rank nothing is split, as JAX's normalised specs
    say.  Raises ValueError where the axis does not divide a split
    dimension or an attention's head count."""
    from ..models.layers import Attention, Dense
    mp = mesh.model.size
    owners = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = mod
    out = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        kernel = leaf == "weight" and isinstance(owners[name], Dense)
        spec = _param_spec(tuple(path) + ("kernel" if kernel else leaf,),
                           p.dim())
        dim = spec.index("model") if "model" in spec else None
        if dim is not None and kernel:
            dim = p.dim() - 1 - dim
        if mp == 1 or dim is None:
            out[name] = None
            continue
        if p.shape[dim] % mp:
            raise ValueError(f"model_parallel={mp} does not divide {name} "
                             f"{tuple(p.shape)} on dim {dim}")
        out[name] = dim
    for mname, mod in model.named_modules():
        if (isinstance(mod, Attention) and mp > 1
                and out.get(f"{mname}.query.weight",
                            out.get(f"{mname}.query.base.weight")) is not None
                and mod.num_heads % mp):
            raise ValueError(f"model_parallel={mp} does not divide the "
                             f"{mod.num_heads} heads of {mname}")
    return out


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Keep this rank's shard of every parameter `param_shardings` splits
    (in place) and set each tensor-parallel module to its part: Dense
    column- or row-parallel, Attention on its local heads, Mlp's inner
    dropout on its column shard.  Returns the shardings."""
    from ..models.layers import Attention, Dense, Mlp
    shardings = param_shardings(model, mesh)
    axis = mesh.model
    if axis.size == 1:
        return shardings
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = shardings[name]
            if dim is not None:
                k = p.shape[dim] // axis.size
                p.data = p.data.narrow(dim, axis.rank * k, k).clone()
    for mname, mod in model.named_modules():
        dim = shardings.get(f"{mname}.weight")
        if isinstance(mod, Dense) and dim is not None:
            mod.shard("col" if dim == 0 else "row", axis)
    for mod in model.modules():   # after their Dense children
        if ((isinstance(mod, Attention) and mod.query_parallel())
                or (isinstance(mod, Mlp) and mod.fc1.parallel == "col")):
            mod.shard(axis)
    return shardings


def batch_shardings(batch: Mapping[str, Any], mesh: Mesh,
                    accum_dim: bool = False) -> Dict[str, Optional[int]]:
    """The axis of each batch array split over `data` (None: whole on every
    rank): the batch axis (axis 1 under grad accumulation, [accum, B, ...]),
    which for the token arrays [N, L] is the chunk-row axis; the sentence
    index arrays `*_sent_chunk` / `*_sent_tok` stay whole, since a sample's
    sentences may sit in chunk rows another rank encodes."""
    lead = 1 if accum_dim else 0
    return {k: None if k.endswith(("_sent_chunk", "_sent_tok")) else lead
            for k in batch}


def shard_batch(batch: Mapping[str, Any], mesh: Mesh,
                accum_dim: bool = False) -> Dict[str, Any]:
    """This rank's share of a global batch (numpy arrays or tensors), as
    `batch_shardings` splits it."""
    dp, r = mesh.data.size, mesh.data.rank
    out = {}
    for k, axis in batch_shardings(batch, mesh, accum_dim).items():
        x = batch[k]
        if axis is None or dp == 1:
            out[k] = x
            continue
        n = x.shape[axis]
        if n % dp:
            raise ValueError(f"{k}: {n} rows do not split over {dp} data "
                             "ranks")
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(r * n // dp, (r + 1) * n // dp)
        out[k] = x[tuple(idx)]
    return out


def replicated(mesh: Mesh) -> None:
    """The placement of an array kept whole on every rank (the spec `None`
    of `param_shardings` / `batch_shardings`)."""
    return None


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=axis.group)
    return y


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient over
    `model` backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce over `model` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverData(torch.autograd.Function):
    """The sum over `data` of each rank's x; the gradient of every rank's
    use of the sum comes back to each x summed the same way."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _GatherOverData(torch.autograd.Function):
    """The ranks' x concatenated along dim 0 in rank order; backward sums
    the gradients over `data` and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.axis.size
        r = ctx.axis.rank
        return _all_reduce(g, ctx.axis)[r * n:(r + 1) * n], None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFromModel.apply(x, axis)


def sum_over_data(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _SumOverData.apply(x, axis)


def gather_over_data(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _GatherOverData.apply(x, axis)


def all_gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' x (no gradient) concatenated along dim 0 in rank order."""
    if axis.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=0)


def all_reduce_(tensors: Sequence[torch.Tensor], axis: Axis,
                bucket_bytes: int = 1 << 27) -> None:
    """Sum `tensors` over `axis` in place, flattened into buckets of about
    `bucket_bytes` (one all-reduce each).  Runs whenever the axis has a
    process group, one rank included."""
    if axis.group is None:
        return
    buckets: List[List[torch.Tensor]] = [[]]
    size = 0
    for t in tensors:
        if buckets[-1] and (size + t.numel() * t.element_size() > bucket_bytes
                            or t.dtype != buckets[-1][0].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel() * t.element_size()
    for bucket in buckets:
        if not bucket:
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=axis.group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def gather_shards(tensors: Mapping[str, torch.Tensor],
                  shardings: Mapping[str, Optional[int]],
                  axis: Axis) -> Dict[str, torch.Tensor]:
    """The whole tensors of `tensors`' model shards, on the CPU: each split
    one gathered over `axis` along its dimension (every rank of the group
    takes part), the others copied."""
    out = {}
    for name, t in tensors.items():
        dim = shardings.get(name)
        if dim is None or axis.size == 1:
            out[name] = t.detach().cpu()
            continue
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=axis.group)
        out[name] = torch.cat(parts, dim=dim).cpu()
    return out


def take_shard(t: torch.Tensor, dim: Optional[int], axis: Axis
               ) -> torch.Tensor:
    """This rank's shard of a whole tensor split along `dim` (None: all)."""
    if dim is None or axis.size == 1:
        return t
    k = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * k, k)


class DataShard:
    """One training forward's share of the global micro-batch on a data
    rank: the micro-batch's dropout generator, from which every rank draws
    the same seeds in the same order, and the mesh's `data` axis.  The
    model takes it as its `rng` (models/layers.draw_seed, data_axis)."""

    def __init__(self, generator: torch.Generator, axis: Axis):
        self.generator = generator
        self.axis = axis


def check_divisible(batch_size: int, chunk_budget: Optional[int],
                    mesh: Mesh) -> None:
    """The global micro-batch must split evenly over `data`."""
    dp = mesh.data.size
    if batch_size % dp or (chunk_budget and chunk_budget % dp):
        raise ValueError(f"train.batch_size={batch_size} and "
                         f"model.packer.chunk_budget={chunk_budget} must "
                         f"split over data_parallel={dp}")

