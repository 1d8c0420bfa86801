"""The (data, model) process mesh, batch placement and process-group
start-up over ``torch.distributed``.

Counterpart of ``sin_inn_tpu/parallel/mesh.py``. One process drives one
GPU (or, under ``--device cpu``, one CPU process): the mesh is the world's
ranks laid out row-major as ``data x model``, rank = d * model + m, with two
process groups per rank: its ``data`` group (the ranks that share its model
index, over which the batch is sharded and the gradients are averaged) and
its ``model`` group (the ranks that share its data index, over which the
GLOW subnets' hidden channels are sharded). The backend is NCCL on CUDA and
gloo on the CPU.

``shard_batch`` takes this rank's slice of axis 0 (its index on ``data``);
``replicate`` broadcasts from rank 0. The autograd-carrying collectives the
sharded losses and tensor parallelism need are here too:

- :func:`all_reduce_sum`: a sum over a group whose backward is the same
  sum;
- :func:`gather_batch`: the concatenation of every rank's shard along axis
  0; backward sums the gradient over the group and keeps this rank's rows
  (a reduce-scatter on NCCL);
- :func:`gather_shards`: the concatenation of the TP shards of a weight
  along ``dim``; backward keeps this rank's slice and moves nothing (every
  rank of a model group computed the whole gradient);
- :func:`copy_to_group` / :func:`reduce_from_group`: the identity whose
  backward all-reduces, and the all-reduce whose backward is the identity,
  on the input and the output of a tensor-parallel subnet.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) mesh. ``group`` spans every rank
    of the mesh (None: the whole world). ``member`` is False on a rank
    beyond ``data * model`` (a mesh smaller than the world): such a rank
    holds no group and takes no part in the run."""

    data: int
    model: int
    rank: int
    world: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None
    member: bool = True
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def primary(self) -> bool:
        """Rank 0 owns the run's side effects (checkpoints, metrics,
        traces, sidecars)."""
        return self.rank == 0


def world_size() -> int:
    """The process group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def world_rank() -> int:
    """This process's rank, 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build the (data, model) mesh over ``ranks`` (default: the whole
    world), creating its process groups. Every rank of the world must call
    it with the same arguments (``new_group`` is collective). Raises when
    ``data * model`` is not the number of ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(initialize_distributed, or torchrun)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    model = int(model)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    rank = dist.get_rank()
    grid = [[ranks[d * model + m] for m in range(model)] for d in range(data)]
    data_group = model_group = None
    data_index = model_index = -1
    # every rank creates every group, in the same order
    for d in range(data):
        g = dist.new_group(grid[d])
        if rank in grid[d]:
            model_group, data_index = g, d
            model_index = grid[d].index(rank)
    for m in range(model):
        members = [grid[d][m] for d in range(data)]
        g = dist.new_group(members)
        if rank in members:
            data_group = g
    group = (None if n == dist.get_world_size() else dist.new_group(ranks))
    return Mesh(data=data, model=model, rank=rank,
                world=dist.get_world_size(), data_index=data_index,
                model_index=model_index, data_group=data_group,
                model_group=model_group, member=rank in ranks, group=group)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_rows(x: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Slice ``index`` of ``parts`` equal slices of axis 0."""
    k = x.shape[0] // parts
    return x[index * k:(index + 1) * k]


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's slice of axis 0 of every tensor of ``batch`` (its index on
    ``data``), as tensors of their own; scalars and 0-d tensors stay whole.
    Raises when the data axis does not divide a batch axis
    (``sharding.place_batch`` with ``allow_uneven`` computes such a batch
    whole instead)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            if v.shape[0] % mesh.data:
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                                 f"divide over data axis {mesh.data}")
            v = shard_rows(v, mesh.data, mesh.data_index).clone()
        out[k] = v
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(mesh: Optional[Mesh], tree):
    """Broadcast every tensor of ``tree`` (nested dicts, lists, tuples) from
    rank 0 over the mesh in place, so every rank of it holds rank 0's
    values. Returns ``tree``."""
    if mesh is None or mesh.data * mesh.model == 1:
        return tree
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.detach(), src=0, group=mesh.group)
    return tree


def broadcast_object(value, src: int = 0, group=None):
    """A picklable value of rank ``src`` on every rank of ``group`` (default
    the world; itself without a process group)."""
    if world_size() == 1 or (group is not None
                             and dist.get_world_size(group) == 1):
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: Optional[float] = None,
                           device: str = "cuda") -> bool:
    """Start the process group; returns whether there is more than one
    process.

    With explicit arguments it rendezvouses at ``tcp://HOST:PORT`` as
    process ``process_id`` of ``num_processes``, and any failure raises:
    the caller asked for a particular cluster, and running alone instead
    would train divergent copies into the same directories. With none it
    reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when ``WORLD_SIZE`` > 1, and otherwise returns False.
    NCCL on CUDA (each rank takes ``cuda:LOCAL_RANK``), gloo on the CPU. An
    already initialised group is kept."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if explicit:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("an explicit cluster needs the coordinator, the "
                             "number of processes and the process id")
        rank, world = int(process_id), int(num_processes)
        init = f"tcp://{coordinator_address}"
    else:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init = "env://"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL process group requested but no CUDA "
                               "device is available; pass --device cpu for "
                               "gloo on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    _log.info("process group up: rank %d of %d (%s)", rank, world, backend)
    return world > 1


# ---------------------------------------------------------------------------
# Autograd-carrying collectives
# ---------------------------------------------------------------------------

def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` summed over ``group``."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    # torch.distributed.nn.functional.all_reduce computes the same, but is
    # deprecated (a FutureWarning on every call)
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward sums the gradient over
    the group too."""
    return _AllReduceSum.apply(x, group)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.rank = dist.get_rank(group)
        ctx.rows = x.shape[0]
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            out = g.new_empty((ctx.rows,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
            return out, None
        # gloo has no reduce-scatter: sum the whole gradient, keep the rows
        g = _summed(g, ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's shard of a batch, concatenated along axis 0 in rank
    order; the backward sums the gradient over the group and keeps this
    rank's rows (a reduce-scatter on NCCL; on gloo, which lacks one, an
    all-reduce of the whole gradient)."""
    return _GatherBatch.apply(x, group)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.size = x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A weight's TP shards concatenated along ``dim``; the backward keeps
    this rank's slice of the gradient (every rank of the group computed the
    same whole gradient)."""
    return _GatherShards.apply(x, group, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group`` (the
    input of a column-parallel layer)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; identity backward (the output of a
    row-parallel layer)."""
    return _ReduceFromGroup.apply(x, group)
