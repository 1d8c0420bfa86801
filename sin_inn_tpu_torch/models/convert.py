"""Parameters from the JAX package's layout into the port's.

The JAX params list (aligned with the same spec) holds conv weights as HWIO
numpy arrays; the port keeps ``torch.nn.Conv2d``'s OIHW. The INR's dense
layers keep the JAX layout, (fan_in, fan_out), unchanged, and so do the
progressive controllers' states, field by field. This is how tests, and any
state trained with the JAX package, reach the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sin_inn_tpu_torch.models.inn import LayerSpec


def _conv_from_jax(p: Dict, device, dtype) -> Dict:
    w = np.asarray(p["w"])
    if w.ndim != 4:
        raise ValueError(f"expected an HWIO conv weight, got shape {w.shape}")
    return {
        "w": torch.tensor(w.transpose(3, 2, 0, 1), dtype=dtype,
                          device=device).contiguous(),
        "b": torch.tensor(np.asarray(p["b"]), dtype=dtype, device=device),
    }


def glow_params_from_jax(p: Dict, device="cpu", dtype=torch.float32) -> Dict:
    """One GLOW coupling's JAX params ({s1, s2} x {conv1, conv2}) -> port."""
    return {sub: {conv: _conv_from_jax(p[sub][conv], device, dtype)
                  for conv in ("conv1", "conv2")}
            for sub in ("s1", "s2")}


def params_from_jax(spec: Sequence[LayerSpec], params_np: Sequence,
                    device="cpu", dtype=torch.float32
                    ) -> List[Optional[Dict]]:
    """JAX params list (HWIO numpy leaves) -> port params (OIHW tensors):
    a GLOW coupling's {s1, s2} or an InvBlockExp's {F, G, H}, each subnet's
    convs by name."""
    if len(params_np) != len(spec):
        raise ValueError(f"{len(params_np)} param entries for a spec of "
                         f"{len(spec)} layers")
    out: List[Optional[Dict]] = []
    for layer, p in zip(spec, params_np):
        if layer.kind not in ("glow", "invblock"):
            if p is not None:
                raise ValueError(f"{layer.kind} layer carries params")
            out.append(None)
            continue
        out.append({sub: {conv: _conv_from_jax(cp, device, dtype)
                          for conv, cp in p[sub].items()}
                    for sub in (("s1", "s2") if layer.kind == "glow"
                                else ("F", "G", "H"))})
    return out


def _tree_from_np(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_from_np(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_from_np(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def inr_params_from_jax(params_np: Dict, consts_np: Dict, device="cpu",
                        dtype=torch.float32) -> Tuple[Dict, Dict]:
    """An INR's JAX params and consts (numpy leaves) -> the port's.

    ``params["mlp"][i]["w"]`` stays (fan_in, fan_out) and ``b`` (fan_out,),
    a progressive net's first layer (E + d, H) with the coordinate rows in
    front; ``consts["enc"]`` keeps its names (RBF: ``centres`` (E, d),
    ``sigma`` (E,))."""
    return (_tree_from_np(params_np, device, dtype),
            _tree_from_np(consts_np, device, dtype))


def ctrl_state_from_jax(state_np, device="cpu"):
    """A JAX controller state (a ``LinearState``, ``SpatialState``,
    ``AdaptiveState`` or ``FixedSpatialState`` NamedTuple, its fields numpy
    arrays or anything ``np.asarray`` takes) -> the port's state of the same
    name on ``device``: tensors keep their dtypes, the counters that the
    port keeps on the host become ints. None stays None."""
    from sin_inn_tpu_torch.models import controllers as C

    if state_np is None:
        return None
    kinds = {cls.__name__: kind for kind, cls in C.STATE_TYPES.items()}
    name = type(state_np).__name__
    if name not in kinds:
        raise ValueError(f"not a controller state: {name}")
    fields = {k: np.asarray(v) for k, v in state_np._asdict().items()}
    return C.state_from_dict({"kind": kinds[name], **fields}, device)
