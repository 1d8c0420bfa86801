"""What is sharded over the mesh: the batch (DP) and the GLOW subnets'
hidden channels (TP), and the train-state and gradient plumbing for both.

Counterpart of ``sin_inn_tpu/parallel/sharding.py``. A spec is a tuple with
one entry per dim of a leaf, ``"model"`` on the sharded dim or ``"data"`` on
a batch's axis 0, None elsewhere; ``()`` replicates (the JAX package's
``PartitionSpec``).

* **DP**: axis 0 of every batch tensor over ``data``. Params and optimizer
  state are replicated; after the backward the gradients are averaged over
  the data group (:func:`sync_grads`), so every rank takes the same step.
  A batch the data axis does not divide is computed whole on every rank
  (``allow_uneven``); :class:`PlacedBatch` says which a batch is, so that
  the losses with batch-global statistics (MMD, the photometric mask
  normalisation, the spatial controller's sums) reduce over the group only
  for a sharded batch.
* **TP** (``mesh_model > 1``, SR only): the hidden channels of the GLOW
  coupling subnets ``s1`` / ``s2``: ``conv1``'s output channels and bias,
  ``conv2``'s input channels. The port's weights are OIHW, so those are
  dims 0, 0 and 1. The 3x3 couplings run column-parallel ``conv1``,
  row-parallel ``conv2`` and one all-reduce of the subnet's output
  (:func:`tp_conv_subnet_apply`); the 1x1 couplings' fused kernels take
  whole weights, gathered from the shards before each launch
  (:func:`tp_glow_params`), and each rank keeps its slice of their weight
  gradients. IRN dense blocks stay replicated. :func:`tp_couplings` reads
  which couplings run so from the state's shardings and hands the train
  steps a :class:`TPCoupling` for each, which ``models/inn.py`` applies.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sin_inn_tpu_torch.parallel.mesh import (Mesh, broadcast_object,
                                             copy_to_group, gather_shards,
                                             reduce_from_group, replicate,
                                             shard_batch)

logger = logging.getLogger(__name__)

Spec = Tuple[Optional[str], ...]


def sr_param_spec(path: Sequence, leaf, model_parallel: bool) -> Spec:
    """The spec of one INN param leaf at ``path`` (its names from the
    params list down, e.g. ``(3, "s1", "conv1", "w")``): TP on the GLOW
    subnets' hidden channels, everything else replicated."""
    if not model_parallel or not hasattr(leaf, "ndim"):
        return ()
    names = [str(n) for n in path]
    if not any(n in ("s1", "s2") for n in names):
        return ()
    if "conv1" in names:
        if leaf.ndim == 4:              # (hidden, cin, kh, kw)
            return ("model", None, None, None)
        if leaf.ndim == 1:              # (hidden,)
            return ("model",)
    if "conv2" in names and leaf.ndim == 4:   # (cout, hidden, kh, kw)
        return (None, "model", None, None)
    return ()


def _param_paths(params) -> List[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of every tensor of an SR params list, or of a flow net's
    nested dict, in order."""
    out = []

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            out.append((path, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    return out


def state_shardings(mesh: Mesh, state: Any,
                    model_parallel: bool = False) -> Dict[Tuple, Spec]:
    """The spec of every param of a train state, keyed by its path; the
    optimizer moments follow their params, the step and a controller state
    replicate.

    The divisibility contract: a dim shards over ``model`` only when the
    axis divides it; otherwise that leaf replicates, with a warning (the
    function is unchanged, only TP's memory and compute saving is lost)."""
    n_model = mesh.shape.get("model", 1)
    warned: set = set()
    out: Dict[Tuple, Spec] = {}
    for path, leaf in _param_paths(state.params):
        spec = sr_param_spec(path, leaf, model_parallel)
        if "model" in spec:
            dim = leaf.shape[spec.index("model")]
            if dim % n_model != 0:
                if dim not in warned:
                    warned.add(dim)
                    logger.warning(
                        "TP: hidden dim %d not divisible by model axis %d — "
                        "replicating %s (and leaves like it) instead of "
                        "sharding", dim, n_model,
                        "/".join(str(p) for p in path))
                spec = ()
        out[path] = spec
    return out


def batch_shardings(mesh: Mesh, batch: Dict,
                    allow_uneven: bool = False) -> Dict[str, Spec]:
    """Axis 0 of every batch tensor over ``data``; scalars replicate. With
    ``allow_uneven`` an axis the data axis does not divide replicates
    instead of failing (ragged last batches)."""
    n = mesh.shape["data"]
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim") and v.ndim >= 1:
            if allow_uneven and v.shape[0] % n != 0:
                out[k] = ()
            else:
                out[k] = ("data",)
        else:
            out[k] = ()
    return out


class PlacedBatch(dict):
    """A batch as this rank holds it. ``sharded``: axis 0 is this rank's
    slice of a batch of ``rows`` rows; otherwise every rank holds all
    ``rows``."""

    sharded: bool = False
    rows: int = 0

    def to(self, device) -> "PlacedBatch":
        out = PlacedBatch((k, v.to(device) if isinstance(v, torch.Tensor)
                           else v) for k, v in self.items())
        out.sharded, out.rows = self.sharded, self.rows
        return out


def _rows(batch: Dict) -> int:
    for v in batch.values():
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            return int(v.shape[0])
    return 0


def place_batch(mesh: Mesh, batch: Dict,
                allow_uneven: bool = False) -> PlacedBatch:
    """This rank's part of ``batch`` by :func:`batch_shardings`: its slice
    of axis 0 when the data axis divides every tensor of the batch, else
    (with ``allow_uneven``) the whole batch. A batch is sharded or
    replicated as a whole, so that its losses reduce consistently."""
    specs = batch_shardings(mesh, batch, allow_uneven)
    whole = any(
        s == () and isinstance(batch[k], torch.Tensor) and batch[k].ndim >= 1
        for k, s in specs.items())
    out = PlacedBatch(batch if whole or mesh.data == 1
                      else shard_batch(mesh, batch))
    out.sharded = not whole
    out.rows = _rows(batch)
    return out


def batch_rows(batch: Dict) -> int:
    """The whole batch's rows, for a placed batch or a plain one."""
    return batch.rows if isinstance(batch, PlacedBatch) else _rows(batch)


def data_group(mesh: Optional[Mesh], batch: Optional[Dict]):
    """The group a batch's global statistics reduce over: the data group for
    a sharded batch, None for a whole one (or without a mesh)."""
    if mesh is None or not getattr(batch, "sharded", False):
        return None
    return mesh.data_group


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def _flat_with_opt_index(state) -> List[Tuple[Tuple, torch.Tensor, int]]:
    """(path, param, index in the optimizer's param list) of every param."""
    order = {id(t): i for i, t in
             enumerate(state.optimizer.param_groups[0]["params"])}
    return [(p, t, order[id(t)]) for p, t in _param_paths(state.params)]


def _rebuild(params, paths: Dict[Tuple, torch.Tensor]):
    """A copy of the params tree with the leaves at ``paths`` replaced."""

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            return paths.get(path, node)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(v, path + (i,)) for i, v in enumerate(node))
        return node

    return walk(params, ())


def _opt_state_to(opt_state: Dict, device) -> Dict:
    return {"state": {i: {k: (v.to(device) if isinstance(v, torch.Tensor)
                              else v) for k, v in s.items()}
                      for i, s in opt_state["state"].items()},
            "param_groups": opt_state["param_groups"]}


def _narrow(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    d = spec.index("model")
    k = t.shape[d] // mesh.model
    return t.detach().narrow(d, mesh.model_index * k, k).contiguous()


def place_state(mesh: Mesh, state: Any, model_parallel: bool = False):
    """The train state (an ``SRTrainState`` or a ``FlowTrainState``) as this
    rank holds it: params, optimizer state and controller state broadcast
    from rank 0 (a resume reads rank 0's checkpoint), then, under TP, every
    sharded param and its optimizer moments narrowed to this rank's slice
    and a new optimizer of the same kind built over them. The result
    carries ``shardings`` (path -> spec)."""
    replicate(mesh, state.params)
    if getattr(state, "ctrl_state", None) is not None:
        replicate(mesh, tuple(state.ctrl_state))
    opt_state = broadcast_object(
        _opt_state_to(state.optimizer.state_dict(), "cpu"), group=mesh.group)
    step = broadcast_object(int(state.step), group=mesh.group)
    specs = state_shardings(mesh, state, model_parallel)
    device = next(iter(_param_paths(state.params)))[1].device
    opt_state = _opt_state_to(opt_state, device)
    flat = _flat_with_opt_index(state)
    ordered: List[Optional[torch.Tensor]] = [None] * len(flat)
    by_path: Dict[Tuple, torch.Tensor] = {}
    for path, t, i in flat:
        spec = specs[path]
        if "model" in spec:
            leaf = _narrow(t, spec, mesh)
            for k, v in opt_state["state"].get(i, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == t.shape:
                    opt_state["state"][i][k] = _narrow(v, spec, mesh)
        else:
            leaf = t.detach()
        ordered[i] = by_path[path] = leaf.requires_grad_(True)
    params = _rebuild(state.params, by_path)
    opt = type(state.optimizer)(ordered, **state.optimizer.defaults)
    opt.load_state_dict(opt_state)
    out = dataclasses.replace(state, params=params, optimizer=opt, step=step)
    out.shardings = specs
    return out


def full_state_dict(mesh: Mesh, state: Any) -> Dict[str, Any]:
    """``state.state_dict()`` with every TP-sharded param and its optimizer
    moments gathered whole over the model group (a collective: every rank
    calls it). Without sharded leaves it is the state's own."""
    specs = getattr(state, "shardings", None) or {}
    if mesh is None or mesh.model == 1 or not any(
            "model" in s for s in specs.values()):
        return state.state_dict()
    opt_state = state.optimizer.state_dict()
    gathered: Dict[Tuple, torch.Tensor] = {}

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(mesh.model)]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=mesh.model_group)
        return torch.cat(parts, dim=dim)

    new_opt = {"state": {}, "param_groups": opt_state["param_groups"]}
    for path, t, i in _flat_with_opt_index(state):
        spec = specs.get(path, ())
        st = dict(opt_state["state"].get(i, {}))
        if "model" in spec:
            d = spec.index("model")
            gathered[path] = gather(t, d)
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.shape == t.shape:
                    st[k] = gather(v, d)
        if i in opt_state["state"]:
            new_opt["state"][i] = st
    out = state.state_dict()
    out["params"] = _rebuild(state.params, {
        p: g for p, g in gathered.items()})
    out["opt"] = new_opt
    return out


def sync_grads(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> None:
    """Average the gradients of ``tensors`` over the data group in place,
    as one flat buffer (a missing gradient counts as zeros)."""
    if mesh is None:
        return
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data)
    off = 0
    for t, g in zip(tensors, grads):
        n = g.numel()
        t.grad = flat[off:off + n].view_as(g)
        off += n


def reduce_metrics(mesh: Optional[Mesh], m: Dict[str, torch.Tensor],
                   maxed: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Scalar metrics of one step over the data group: the mean, or the
    maximum for the keys in ``maxed`` (the window monitors). Ranks that
    computed a whole batch agree already, and the mean keeps their value."""
    if mesh is None or not m:
        return m
    keys = [k for k in m if k not in maxed]
    out = dict(m)
    if keys:
        vec = torch.stack([m[k].float().reshape(()) for k in keys])
        dist.all_reduce(vec, group=mesh.data_group)
        vec = vec / mesh.data
        out.update({k: vec[i] for i, k in enumerate(keys)})
    mk = [k for k in maxed if k in m]
    if mk:
        vec = torch.stack([m[k].float().reshape(()) for k in mk])
        dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=mesh.data_group)
        out.update({k: vec[i] for i, k in enumerate(mk)})
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism over the GLOW subnets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPCoupling:
    """How a GLOW coupling whose subnets are TP shards runs over the model
    group: ``subnet`` takes the place of the conv subnet (3x3), ``whole``
    gives the fused 1x1 kernels the whole weights."""

    group: Any

    def subnet(self, params: Dict, x: torch.Tensor,
               compute=None) -> torch.Tensor:
        return tp_conv_subnet_apply(params, x, self.group, compute)

    def whole(self, p: Dict) -> Dict:
        return tp_glow_params(p, self.group)


# the leaves of a GLOW coupling that TP shards, below its layer index
_TP_LEAVES = tuple((sub, conv, k) for sub in ("s1", "s2")
                   for conv, k in (("conv1", "w"), ("conv1", "b"),
                                   ("conv2", "w")))


def tp_couplings(mesh: Optional[Mesh],
                 shardings: Optional[Dict[Tuple, Spec]]
                 ) -> Optional[Dict[int, TPCoupling]]:
    """The couplings that run tensor-parallel, by layer index, read from a
    train state's ``shardings`` (None: none). A coupling sharded in part
    raises: its subnets could run neither whole nor on shards."""
    if mesh is None or mesh.model == 1 or not shardings:
        return None
    layers = sorted({path[0] for path, spec in shardings.items()
                     if "model" in spec})
    for i in layers:
        whole = [".".join(leaf) for leaf in _TP_LEAVES
                 if "model" not in shardings.get((i,) + leaf, ())]
        if whole:
            raise ValueError(f"layer {i} is TP-sharded in part: "
                             f"{', '.join(whole)} replicated")
    tp = TPCoupling(mesh.model_group)
    return {i: tp for i in layers} or None


def tp_glow_params(p: Dict, group) -> Dict:
    """A GLOW coupling's whole weights gathered from its TP shards (conv1's
    output channels and bias, conv2's input channels), for the fused 1x1
    kernels; the gradient of each gathered weight flows back to this rank's
    slice."""
    out = {}
    for sub in ("s1", "s2"):
        c1, c2 = p[sub]["conv1"], p[sub]["conv2"]
        out[sub] = {
            "conv1": {"w": gather_shards(c1["w"], group, 0),
                      "b": gather_shards(c1["b"], group, 0)},
            "conv2": {"w": gather_shards(c2["w"], group, 1), "b": c2["b"]},
        }
    return out


def tp_conv_subnet_apply(params: Dict, x: torch.Tensor, group,
                         compute=None) -> torch.Tensor:
    """The conv subnet on this rank's hidden shard: ``conv1`` column-parallel
    (its output channels), relu, ``conv2`` row-parallel (its input
    channels), the partial outputs summed over the model group, then
    ``conv2``'s bias, once."""
    from sin_inn_tpu_torch.ops.subnet import conv2d

    x = copy_to_group(x, group)
    h = torch.relu(conv2d(x, params["conv1"]["w"], params["conv1"]["b"],
                          compute))
    out = conv2d(h, params["conv2"]["w"], None, compute)
    return reduce_from_group(out, group) + params["conv2"]["b"]
