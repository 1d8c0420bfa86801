"""Coordinate encodings of the implicit neural representations (INRs).

Counterpart of ``sin_inn_tpu/ops/encodings.py``: each encoding is
``(init, apply)``. ``init(gen, ...)`` draws from a ``torch.Generator`` and
returns ``(params, consts)`` dicts of tensors (only the rotated Fourier
features have trainable params); ``apply(params, consts, x)`` maps (..., d)
coordinates to (..., E) features. Frequencies and RBF widths are sorted low
to high at init, as in the reference, so progressive masks unlock coarse to
fine.

The RBF distance keeps the reference's |x|^2 + |c|^2 - 2 x.c form. Every
contraction over the d coordinates (x.c, and x @ F of the Fourier and
triangle-wave features) is written as a chain of multiply-adds rather than
a matrix product, so it stays in full fp32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says. (Pose-grid coordinates are
2/1023 apart at Sintel width; TF32's 10-bit mantissa would let neighbouring
pixels collide before the exponential.)
"""

from __future__ import annotations

import math
from typing import Dict

import torch

EPSILON = 1e-4


def _l2_normalize(v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True),
                           min=1e-12)


def _interleave_sin_cos(phase: torch.Tensor) -> torch.Tensor:
    """[sin_f0, cos_f0, sin_f1, ...] along the last axis."""
    out = torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1)
    return out.reshape(*phase.shape[:-1], phase.shape[-1] * 2)


def _sorted_by_abs(v: torch.Tensor) -> torch.Tensor:
    return v[torch.argsort(v.abs())]


def _contract(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ m (d, F) as an fp32 multiply-add chain over the d
    coordinates: never a TF32 product."""
    out = x[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        out = torch.addcmul(out, x[..., k:k + 1], m[k])
    return out


# --------------------------------------------------------------------------
# Fourier features
# --------------------------------------------------------------------------

def gaussian_ff_init(gen, domain_dim: int, num_frequencies: int, std: float):
    """Magnitudes ~ N(0, std) sorted by |.|, random unit directions."""
    mag = _sorted_by_abs(torch.randn(num_frequencies, generator=gen) * std)
    dirs = torch.randn((domain_dim, num_frequencies), generator=gen)
    return {}, {"frequencies": _l2_normalize(dirs, 0) * mag[None, :]}


def uniform_ff_init(gen, domain_dim: int, num_frequencies: int, std: float):
    s = std / math.sqrt(3.0)
    mag = _sorted_by_abs(torch.linspace(-s, s, num_frequencies) + EPSILON)
    dirs = torch.randn((domain_dim, num_frequencies), generator=gen)
    return {}, {"frequencies": _l2_normalize(dirs, 0) * mag[None, :]}


def ff_apply(params: Dict, consts: Dict, x: torch.Tensor) -> torch.Tensor:
    """phase = 2 pi x @ F; interleaved sin/cos."""
    phase = _contract(x * (2.0 * math.pi), consts["frequencies"])
    return _interleave_sin_cos(phase)


def rotated_ff_init(gen, domain_dim: int, num_frequencies: int, std: float):
    """Trainable directions, fixed gaussian magnitudes."""
    mag = _sorted_by_abs(torch.randn(num_frequencies, generator=gen) * std)
    dirs = _l2_normalize(torch.randn((domain_dim, num_frequencies),
                                     generator=gen), 0)
    return {"frequencies": dirs}, {"magnitudes": mag}


def rotated_ff_apply(params: Dict, consts: Dict,
                     x: torch.Tensor) -> torch.Tensor:
    freqs = (_l2_normalize(params["frequencies"], 0)
             * consts["magnitudes"][None, :])
    return _interleave_sin_cos(_contract(x * (2.0 * math.pi), freqs))


# --------------------------------------------------------------------------
# NeRF-style positional encoding
# --------------------------------------------------------------------------

def positional_init(gen, domain_dim: int, num_frequencies: int):
    del gen
    return {}, {"freqs": torch.tensor([2.0 ** i * math.pi
                                       for i in range(num_frequencies)])}


def positional_apply(params: Dict, consts: Dict,
                     x: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, 2 F d) as [cos(f x d block) || sin(f x d block)]."""
    phase = consts["freqs"][None, :, None] * x[..., None, :]   # (n, F, d)
    flat = phase.reshape(*phase.shape[:-2], -1)
    return torch.cat([torch.cos(flat), torch.sin(flat)], dim=-1)


# --------------------------------------------------------------------------
# Radial basis encodings
# --------------------------------------------------------------------------

def rbf_init(gen, domain_dim: int, num_frequencies: int, std: float):
    """2 * num_frequencies centres (the reference doubles it)."""
    nf = num_frequencies * 2
    centres = torch.rand((nf, domain_dim), generator=gen) * 2.0 - 1.0
    sigma = torch.abs(torch.randn(nf, generator=gen)) * std + 1.0
    return {}, {"centres": centres, "sigma": torch.sort(sigma).values}


def rbf_apply(params: Dict, consts: Dict, x: torch.Tensor) -> torch.Tensor:
    """exp(-|x - c|^2 sigma^2), with |x - c|^2 = |x|^2 + |c|^2 - 2 x.c and
    x.c as an fp32 multiply-add chain over the d coordinates."""
    c = consts["centres"]                                       # (E, d)
    xc = _contract(x, c.t())
    d2 = ((x * x).sum(-1, keepdim=True) + (c * c).sum(-1) - 2.0 * xc)
    d2 = torch.clamp(d2, min=0.0)
    return torch.exp(-d2 * consts["sigma"] ** 2)


def rbf_grid_random_init(gen, domain_dim: int, num_frequencies: int,
                         std: float):
    sigma = torch.abs(torch.randn(num_frequencies, generator=gen)) * std + 1.0
    offsets = torch.remainder(
        torch.rand((num_frequencies, domain_dim), generator=gen) * 2 - 1,
        2.0 / sigma[:, None])
    return {}, {"offsets": offsets, "sigma": torch.sort(sigma).values}


def rbf_grid_uniform_init(gen, domain_dim: int, num_frequencies: int,
                          std: float):
    freqs = torch.linspace(0.0, std * math.sqrt(3.0), num_frequencies)
    freqs = freqs + freqs[1] / 2.0
    offsets = torch.remainder(
        torch.rand((num_frequencies, domain_dim), generator=gen) * 2 - 1,
        2.0 / freqs[:, None])
    return {}, {"offsets": offsets, "sigma": torch.sort(freqs).values}


def rbf_grid_apply(params: Dict, consts: Dict,
                   x: torch.Tensor) -> torch.Tensor:
    """Periodic RBF bumps, two phase-shifted copies."""
    sigma = consts["sigma"]
    x_a = x[..., None, :] + consts["offsets"]                  # (n, F, d)
    x_b = x_a + 1.0 / sigma[:, None]
    out = torch.stack([x_a, x_b], dim=-2)                      # (n, F, 2, d)
    period = 2.0 / sigma[:, None, None]
    out = torch.remainder(out, period) * 2.0 - period
    out = (out ** 2).sum(-1) * sigma[:, None] ** 2             # (n, F, 2)
    out = out.reshape(*x.shape[:-1], -1)
    return torch.exp(-out) * 2.0 - 1.0


# --------------------------------------------------------------------------
# Piecewise (triangle-wave) encodings
# --------------------------------------------------------------------------

def piecewise_gaussian_init(gen, domain_dim: int, num_frequencies: int,
                            std: float):
    freqs = torch.abs(torch.randn((domain_dim, num_frequencies),
                                  generator=gen) * std / (2.0 * math.pi))
    order = torch.argsort(torch.linalg.norm(freqs, dim=0))
    return {}, {"frequencies": freqs[:, order]}


def piecewise_uniform_init(gen, domain_dim: int, num_frequencies: int,
                           std: float):
    b = std * math.sqrt(12.0) / (2.0 * math.pi)
    mag = torch.linspace(0.0, b, num_frequencies)
    mag = mag + mag[1] / 2.0
    dirs = torch.abs(torch.randn((domain_dim, num_frequencies),
                                 generator=gen))
    return {}, {"frequencies": _l2_normalize(dirs, 0) * mag[None, :]}


def piecewise_apply(params: Dict, consts: Dict,
                    x: torch.Tensor) -> torch.Tensor:
    """Triangle wave of (x + 1) @ F at two phases, interleaved."""
    out = _contract(x + 1.0, consts["frequencies"])             # (n, F)
    out = torch.stack([out, out + 1.0], dim=-1)
    out = out.reshape(*out.shape[:-2], -1)
    out = torch.fmod(out, 2.0) - 1.0
    return torch.where(out < 0, 2.0 * out + 1.0, 1.0 - 2.0 * out)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

def encoding_output_channels(kind: str, num_frequencies: int,
                             domain_dim: int) -> int:
    if kind in ("gaussian_ff", "uniform_ff", "rotated_ff", "rbf",
                "rbf_grid_random", "rbf_grid_uniform",
                "piecewise_gaussian", "piecewise_uniform"):
        return 2 * num_frequencies
    if kind == "positional":
        return 2 * num_frequencies * domain_dim
    raise ValueError(kind)


ENCODINGS = {
    "gaussian_ff": (gaussian_ff_init, ff_apply),
    "uniform_ff": (uniform_ff_init, ff_apply),
    "rotated_ff": (rotated_ff_init, rotated_ff_apply),
    "positional": (positional_init, positional_apply),
    "rbf": (rbf_init, rbf_apply),
    "rbf_grid_random": (rbf_grid_random_init, rbf_grid_apply),
    "rbf_grid_uniform": (rbf_grid_uniform_init, rbf_grid_apply),
    "piecewise_gaussian": (piecewise_gaussian_init, piecewise_apply),
    "piecewise_uniform": (piecewise_uniform_init, piecewise_apply),
}
