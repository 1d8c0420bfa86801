"""Implicit neural representation (INR) models of the flow pipeline.

Counterpart of ``sin_inn_tpu/models/inr.py``: a coordinate MLP fed by one
of the encodings of :mod:`sin_inn_tpu_torch.ops.encodings`, with the
reference's model registry. Parameters are plain dicts of tensors in the
JAX package's layout: ``params = {"mlp": [{"w": (fan_in, fan_out), "b":
(fan_out,)}, ...], "enc": {...}}`` and ``consts = {"enc": {...}}``, so a
layer is ``x @ w + b``.

The JAX package routes eligible nets through a fused encode-mask-MLP kernel
(``ops/pallas/inr.py``), and so does the port (``ops/cuda/inr.py``), by the
mask's format:

* no mask or a constant channel mask (every non-progressive net, and the
  progressive nets under the linear controller): the forward is the plain
  encode -> mask -> MLP (the JAX package's ``_xla_forward``) and only the
  backward is the kernel (K7 backward), so under ``torch.no_grad()`` such a
  net takes the plain route;
* a factored per-point mask of the spatial controller (row slabs, or the
  split per-point stream): the forward is the kernel too (K7 forward),
  with or without gradients, so that the (n, E) mask is never built.

:func:`fused_inr_eligible` is the one gate (``INRSpec.use_kernel == "auto"``
and :func:`fused_inr_supported`); ``train/flow.py`` chooses the mask's
format by the same gate (:func:`fused_spatial_mask_format`).
``use_kernel == "off"`` keeps ordinary autograd through the plain route,
where a factored mask is put together into its dense (n, E) form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch

from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.ops.cuda.inr import TILE_ROWS, fused_inr
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
    # 'auto': the fused INR kernels where they apply; 'off': ordinary
    # autograd through the plain route
    use_kernel: str = "auto"

    @property
    def encoding_channels(self) -> int:
        """Channels of the encoding itself (the mask length less the
        coordinate rows a progressive net puts in front)."""
        return self.encoding_dim - (self.domain_dim if self.is_progressive
                                    else 0)


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
    d = cfg.domain_dim
    widths = [cfg.hidden_dim] * cfg.num_layers + [cfg.output_channels]

    if kind in ("mlp", "siren"):
        spec = INRSpec(name, kind, None, d, d, False, cfg.hidden_dim,
                       cfg.num_layers, cfg.output_channels, cfg.compute_dtype,
                       cfg.use_kernel)
        mlp = (mlp_init(gen, [d] + widths) if kind == "mlp" else
               siren_init(gen, d, cfg.hidden_dim, cfg.num_layers,
                          cfg.output_channels))
        return spec, tree_to({"mlp": mlp}, device), {}

    init_fn, _ = ENCODINGS[encoding]
    enc_params, enc_consts = init_fn(gen, *_enc_args(encoding, cfg))
    enc_ch = _enc_out_channels(encoding, cfg)
    # a progressive net feeds the raw coordinates in front of the encoding
    mask_dim = enc_ch + d if progressive else enc_ch
    spec = INRSpec(name, "encoded", encoding, d, mask_dim, progressive,
                   cfg.hidden_dim, cfg.num_layers, cfg.output_channels,
                   cfg.compute_dtype, cfg.use_kernel)
    mlp = mlp_init(gen, [mask_dim] + widths)
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


def alpha_mask(spec: INRSpec, alpha: float,
               device="cpu") -> torch.Tensor:
    """The dense soft mask (encoding_dim,) of a progress fraction: the
    coordinate rows and the first alpha share of the encoding channels open,
    the channel at the edge open by the fraction's remainder."""
    e = spec.encoding_dim
    if alpha == 0:
        return torch.zeros(e, device=device)
    a = torch.tensor(alpha * (e - spec.domain_dim) + spec.domain_dim,
                     dtype=torch.float32, device=device)
    idx = torch.arange(e, dtype=torch.float32, device=device)
    cur = torch.floor(a)
    return torch.where(idx < cur, 1.0, torch.where(idx == cur, a - cur, 0.0))


_FUSED_ENCODINGS = {"rbf": "rbf", "gaussian_ff": "ff", "uniform_ff": "ff"}

Mask = Union[None, torch.Tensor, Tuple[torch.Tensor, ...]]


def fused_inr_supported(spec: INRSpec, params, consts, x: torch.Tensor,
                        mask: Mask) -> bool:
    """Whether ``ops/cuda/inr.py`` computes this net with this mask: an
    encoded net on the RBF or the Fourier features with no trainable
    encoding parameters, not in ``float32_highest`` (the strict mode never
    takes a kernel), 2-D points, and as mask: none, a constant
    (encoding_dim,) vector, and for a progressive net the spatial
    controller's factored forms: the split pair (mc (d, n), me (n, E - d))
    or the row slabs (enc (rows, res, E - d), coord (rows, res, d), wx (W,
    res)) with rows x W = n and W a multiple of the kernels' tile (the TPU
    kernel asks W % 128 and takes one tile per row; here a 32-point tile must
    not straddle two image rows). An unsplit per-point (n, E) mask is not
    taken. These are questions of structure only. What the CUDA kernels need
    of the widths (``ops/cuda/inr.py`` ``kernel_supports``: multiples of 4, a
    32-row tile within a block's shared memory) is not asked here: on the
    card a net of this structure that the kernels cannot take is refused
    with a ValueError, never handed to plain autograd. The CPU's plain
    versions take any width."""
    if spec.kind != "encoded" or spec.encoding not in _FUSED_ENCODINGS:
        return False
    if params.get("enc"):
        return False
    if spec.compute_dtype in ("highest", "float32_highest"):
        return False
    if x.dim() != 2 or spec.num_layers < 1:
        return False
    if isinstance(mask, tuple) and len(mask) == 3:
        if not spec.is_progressive:
            return False
        enc, coord, wx = mask
        if enc.dim() != 3 or coord.dim() != 3 or wx.dim() != 2:
            return False
        if wx.shape[0] % TILE_ROWS != 0:
            return False
        if enc.shape[0] * wx.shape[0] != x.shape[0]:
            return False
    elif isinstance(mask, tuple):
        if not spec.is_progressive or len(mask) != 2:
            return False
        mc, me = mask
        if mc.dim() != 2 or me.dim() != 2 or me.shape[0] != x.shape[0]:
            return False
    elif mask is not None and mask.dim() != 1:
        return False
    return x.device.type in ("cpu", "cuda")


def fused_inr_eligible(spec: INRSpec, params, consts, x: torch.Tensor,
                       mask: Mask) -> bool:
    """The one gate of the fused route: the ``use_kernel`` switch and the
    structural check. Both places that decide it, the mask format in
    ``train/flow.py`` ``flow_forward`` and the dispatch in
    :func:`inr_apply`, ask here (the former through
    :func:`fused_spatial_mask_format`), so they cannot drift apart: if they
    did, ``flow_forward`` would build a factored mask that :func:`inr_apply`
    puts together again into the dense (n, E) form the slabs exist to
    avoid."""
    return (spec.use_kernel == "auto"
            and fused_inr_supported(spec, params, consts, x, mask))


def fused_spatial_mask_format(spec: INRSpec, params, consts,
                              x: torch.Tensor, w: int) -> str:
    """The format ``flow_forward`` emits the spatial controller's mask in
    for the dense pose grid of width ``w``: ``'slabs'`` (the fused route, a
    width that is a multiple of the kernels' tile), ``'split'`` (the fused
    route on any other width: the per-point mask streamed to the kernel) or
    ``'dense'`` (the plain route: ``use_kernel="off"`` or a net the fused
    route does not compute)."""
    if fused_inr_eligible(spec, params, consts, x, None):
        return "slabs" if w % TILE_ROWS == 0 else "split"
    return "dense"


def dense_mask(mask: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The (n, encoding_dim) mask of a factored one: the row slabs
    contracted with the x-axis weights as the kernel would, or the split
    pair put side by side, coordinate channels first."""
    if len(mask) == 3:
        enc, coord, wx = mask
        wx = wx.to(enc.dtype)
        me = torch.einsum("wr,SrE->SwE", wx, enc).reshape(-1, enc.shape[-1])
        mc = torch.einsum("wr,SrD->SwD", wx, coord).reshape(
            -1, coord.shape[-1])
    else:
        mc, me = mask
        mc = mc.t()
    return torch.cat([mc.to(me.dtype), me], dim=-1)


def inr_apply(spec: INRSpec, params, consts, x: torch.Tensor,
              mask: Mask = None, alpha: Optional[float] = None
              ) -> torch.Tensor:
    """encode -> mask -> MLP. x: (n, d) points; returns (n, out). ``mask``
    overrides the channel mask (no gradient reaches it): a constant
    (encoding_dim,) vector, a dense per-point (n, encoding_dim) tensor, or
    one of the spatial controller's factored forms (see
    :func:`fused_inr_supported`); without one, ``alpha`` < 1 masks a
    progressive net by :func:`alpha_mask`.

    An eligible net (:func:`fused_inr_eligible`) takes the fused route: with
    a factored mask always (K7 forward, and K7 backward when gradients are
    on), with a constant or no mask when gradients are enabled (plain
    forward that keeps no activation, K7 backward); under ``no_grad`` the
    latter takes the plain route. On the card the fused route raises a
    ValueError for widths its kernels cannot take (``use_kernel="off"`` is
    the way to run such a net). The two routes agree to rounding in float32
    only: in ``bfloat16`` the fused route rounds the products' operands and
    accumulates in fp32, the plain one casts the activations, so ``auto``
    and ``off`` differ in the forward too."""
    if (mask is None and alpha is not None and spec.is_progressive
            and alpha < 1):
        mask = alpha_mask(spec, alpha, x.device)
    if (fused_inr_eligible(spec, params, consts, x, mask)
            and (isinstance(mask, tuple) or torch.is_grad_enabled())):
        layers = [(l["w"], l["b"]) for l in params["mlp"]]
        out = fused_inr(_FUSED_ENCODINGS[spec.encoding], consts["enc"],
                        layers, x.float(), mask,
                        bf16=spec.compute_dtype == "bfloat16")
        return out.to(x.dtype)
    if isinstance(mask, tuple):
        mask = dense_mask(mask)
    code = get_encoding(spec, params, consts, x)
    out_dtype = code.dtype
    cast = _cast(spec.compute_dtype)
    if cast is not None:
        code = code.to(cast)
    if mask is not None:
        code = code * mask.detach().to(code.dtype)
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
