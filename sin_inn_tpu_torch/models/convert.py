"""Parameters from the JAX package's layout into the port's.

The JAX params list (aligned with the same spec) holds conv weights as HWIO
numpy arrays; the port keeps ``torch.nn.Conv2d``'s OIHW. This is how tests,
and any state trained with the JAX package, reach the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
    """JAX params list (HWIO numpy leaves) -> port params (OIHW tensors)."""
    if len(params_np) != len(spec):
        raise ValueError(f"{len(params_np)} param entries for a spec of "
                         f"{len(spec)} layers")
    out: List[Optional[Dict]] = []
    for layer, p in zip(spec, params_np):
        if layer.kind != "glow":
            if p is not None:
                raise ValueError(f"{layer.kind} layer carries params")
            out.append(None)
            continue
        out.append(glow_params_from_jax(p, device, dtype))
    return out
