"""Implicit neural representation (INR) models of the flow pipeline.

Counterpart of ``sin_inn_tpu/models/inr.py``: a coordinate MLP fed by one
of the encodings of :mod:`sin_inn_tpu_torch.ops.encodings`, with the
reference's model registry. Parameters are plain dicts of tensors in the
JAX package's layout: ``params = {"mlp": [{"w": (fan_in, fan_out), "b":
(fan_out,)}, ...], "enc": {...}}`` and ``consts = {"enc": {...}}``, so a
layer is ``x @ w + b``.

The JAX package routes eligible nets through a fused encode-mask-MLP kernel
(``ops/pallas/inr.py``). For a constant mask, the case of every
non-progressive net, that dispatch returns ``_xla_forward``, which computes
the same function as the plain branch here, so the port has only the plain
route. The kernel proper runs for the progressive controllers' per-point
masks and in the training backward; it comes with the training slice, as
do the progressive nets, which raise here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.ops.encodings import ENCODINGS, encoding_output_channels


# --------------------------------------------------------------------------
# MLP (torch-default init) and SIREN
# --------------------------------------------------------------------------

def _uniform(gen, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _linear_init(gen, fan_in: int, fan_out: int) -> Dict:
    bound = 1.0 / math.sqrt(fan_in)
    return {"w": _uniform(gen, (fan_in, fan_out), bound),
            "b": _uniform(gen, (fan_out,), bound)}


def mlp_init(gen, layers: List[int]) -> List[Dict]:
    return [_linear_init(gen, layers[i], layers[i + 1])
            for i in range(len(layers) - 1)]


def _cast(compute_dtype: Optional[str]):
    """The matmul operand dtype of ``compute_dtype``: None keeps fp32
    ('float32' and 'float32_highest' are both full fp32 products here)."""
    if compute_dtype in (None, "float32", "float32_highest", "highest"):
        return None
    return getattr(torch, compute_dtype)


def mlp_apply(params: List[Dict], x: torch.Tensor,
              compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Linear->ReLU chain, no activation after the last layer.
    ``'bfloat16'`` runs the whole chain in bf16 and returns fp32."""
    out_dtype = x.dtype
    cast = _cast(compute_dtype)
    if cast is not None:
        x = x.to(cast)
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if cast is not None:
            w, b = w.to(cast), b.to(cast)
        x = torch.matmul(x, w) + b
        if i < len(params) - 1:
            x = torch.relu(x)
    return x.to(out_dtype)


def siren_init(gen, domain_dim: int, hidden: int, num_layers: int,
               out_ch: int, omega0: float = 30.0) -> List[Dict]:
    """SIREN init: first layer U(+-1/in), hidden and last layers
    U(+-sqrt(6/in)/omega0); biases torch-default."""
    params = [{"w": _uniform(gen, (domain_dim, hidden), 1.0 / domain_dim),
               "b": _linear_init(gen, domain_dim, hidden)["b"]}]
    bound = math.sqrt(6.0 / hidden) / omega0
    for _ in range(num_layers):
        params.append({"w": _uniform(gen, (hidden, hidden), bound),
                       "b": _linear_init(gen, hidden, hidden)["b"]})
    params.append({"w": _uniform(gen, (hidden, out_ch), bound),
                   "b": _linear_init(gen, hidden, out_ch)["b"]})
    return params


def siren_apply(params: List[Dict], x: torch.Tensor, omega0: float = 30.0,
                compute_dtype: Optional[str] = None) -> torch.Tensor:
    out_dtype = x.dtype
    cast = _cast(compute_dtype)
    if cast is not None:
        x = x.to(cast)

    def lin(x, layer):
        w, b = layer["w"], layer["b"]
        if cast is not None:
            w, b = w.to(cast), b.to(cast)
        return torch.matmul(x, w) + b

    for layer in params[:-1]:
        x = torch.sin(omega0 * lin(x, layer))
    return lin(x, params[-1]).to(out_dtype)


# --------------------------------------------------------------------------
# Model spec + registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class INRSpec:
    name: str
    kind: str                # 'mlp' | 'siren' | 'encoded'
    encoding: Optional[str]  # key into ENCODINGS, None for mlp/siren
    domain_dim: int
    encoding_dim: int        # mask length: enc channels (+ domain for progressive)
    is_progressive: bool
    hidden_dim: int
    num_layers: int
    output_channels: int
    compute_dtype: str = "float32"


# name -> (kind, encoding, progressive), as the reference's registry
MODEL_REGISTRY: Dict[str, Tuple[str, Optional[str], bool]] = {
    "siren": ("siren", None, False),
    "FFN": ("encoded", "gaussian_ff", False),
    "UFF": ("encoded", "uniform_ff", False),
    "PFF": ("encoded", "gaussian_ff", True),
    "RBF": ("encoded", "rbf", False),
    "PRBF": ("encoded", "rbf", True),
    "RBFG": ("encoded", "rbf_grid_uniform", False),
    "PRBFG": ("encoded", "rbf_grid_uniform", True),
    "PE": ("encoded", "positional", False),
    "PPE": ("encoded", "positional", True),
    "RFF": ("encoded", "rotated_ff", False),
    "PRFF": ("encoded", "rotated_ff", True),
    "PUFF": ("encoded", "uniform_ff", True),
    "MPFF": ("encoded", "piecewise_uniform", True),
    "base": ("mlp", None, False),
}


def _enc_args(encoding: str, cfg: FlowConfig):
    if encoding == "positional":
        return (cfg.domain_dim, cfg.num_frequencies_pe)
    if encoding in ("rbf", "rbf_grid_random", "rbf_grid_uniform"):
        return (cfg.domain_dim, cfg.num_frequencies, cfg.std_rbf)
    return (cfg.domain_dim, cfg.num_frequencies, cfg.std)


def _enc_out_channels(encoding: str, cfg: FlowConfig) -> int:
    if encoding == "positional":
        return encoding_output_channels("positional", cfg.num_frequencies_pe,
                                        cfg.domain_dim)
    return 2 * cfg.num_frequencies


def tree_to(tree, device):
    """A params or consts tree with every tensor moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree


def build_inr(gen: torch.Generator, name: str, cfg: FlowConfig,
              device="cpu") -> Tuple[INRSpec, Dict, Dict]:
    """(spec, params, consts) of net ``name``, drawn from ``gen`` (a CPU
    generator) and placed on ``device``."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown INR model {name!r}; have "
                         f"{sorted(MODEL_REGISTRY)}")
    kind, encoding, progressive = MODEL_REGISTRY[name]
    if progressive:
        raise NotImplementedError(
            f"INR {name!r} is progressive: it needs the controllers (slice "
            "B2), which are not ported yet")
    d = cfg.domain_dim
    widths = [cfg.hidden_dim] * cfg.num_layers + [cfg.output_channels]

    if kind in ("mlp", "siren"):
        spec = INRSpec(name, kind, None, d, d, False, cfg.hidden_dim,
                       cfg.num_layers, cfg.output_channels, cfg.compute_dtype)
        mlp = (mlp_init(gen, [d] + widths) if kind == "mlp" else
               siren_init(gen, d, cfg.hidden_dim, cfg.num_layers,
                          cfg.output_channels))
        return spec, tree_to({"mlp": mlp}, device), {}

    init_fn, _ = ENCODINGS[encoding]
    enc_params, enc_consts = init_fn(gen, *_enc_args(encoding, cfg))
    enc_ch = _enc_out_channels(encoding, cfg)
    spec = INRSpec(name, "encoded", encoding, d, enc_ch, False,
                   cfg.hidden_dim, cfg.num_layers, cfg.output_channels,
                   cfg.compute_dtype)
    mlp = mlp_init(gen, [enc_ch] + widths)
    return (spec, tree_to({"mlp": mlp, "enc": enc_params}, device),
            tree_to({"enc": enc_consts}, device))


def get_encoding(spec: INRSpec, params, consts,
                 x: torch.Tensor) -> torch.Tensor:
    """The encoding, with the raw coordinates in front for progressive
    nets."""
    if spec.kind != "encoded":
        return x
    _, apply_fn = ENCODINGS[spec.encoding]
    enc = apply_fn(params.get("enc", {}), consts.get("enc", {}), x)
    if spec.is_progressive:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def inr_apply(spec: INRSpec, params, consts,
              x: torch.Tensor) -> torch.Tensor:
    """encode -> MLP. x: (n, d) points; returns (n, out). The progressive
    masks come with the controllers (slice B2)."""
    code = get_encoding(spec, params, consts, x)
    out_dtype = code.dtype
    cast = _cast(spec.compute_dtype)
    if cast is not None:
        code = code.to(cast)
    if spec.kind == "siren":
        out = siren_apply(params["mlp"], code,
                          compute_dtype=spec.compute_dtype)
    else:
        out = mlp_apply(params["mlp"], code, spec.compute_dtype)
    return out.to(out_dtype)


def flat_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf, in a fixed order."""
    out = []

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            out.append((prefix, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")

    walk(tree, "")
    return out
