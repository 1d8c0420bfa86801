"""Seeded weights of the two models, made on the device in a few large
calls, in the layouts the program takes (and, flat by name, the reference).

Both draw the published initialisations: the SRF's convolutions as
``torch.nn.Conv2d`` initialises them (weights and biases uniform in
+-1/sqrt(fan_in)), the flow INR's linear layers as ``torch.nn.Linear``
does, its RBF centres uniform in [-1, 1]^d and its widths
|N(0, 1)| std_rbf + 1, sorted.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from cost import srf_couplings


def _uniform_views(gen: torch.Generator, shapes: List[Tuple[Tuple, float]],
                   device) -> List[torch.Tensor]:
    """One uniform draw split into tensors of ``shapes``, each scaled to
    +-bound."""
    sizes = [math.prod(s) for s, _ in shapes]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out = []
    for t, (shape, bound) in zip(torch.split(flat, sizes), shapes):
        out.append(t.view(shape).mul_(bound).clone())
    return out


def srf_weights(cfg: Dict, seed: int, device
                ) -> Tuple[List[Optional[Dict]], Dict[str, torch.Tensor]]:
    """(params, named): the SRF's weights in the program's params list (one
    entry per layer of its spec: None for a squeeze or a permutation, the
    coupling's ``{"s1", "s2"}`` subnets otherwise) and the same tensors
    flat by name (``c<i>.<subnet>.<conv>.<w|b>``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hid = cfg["hidden_channels"]
    shapes, names = [], []
    for i, c in enumerate(srf_couplings(cfg)):
        k, len1 = c["kernel"], c["len1"]
        len2 = c["c"] - len1
        for sub, cin, cout in (("s1", len1, 2 * len2), ("s2", len2, 2 * len1)):
            for conv, a, b in (("conv1", cin, hid), ("conv2", hid, cout)):
                bound = 1.0 / math.sqrt(a * k * k)
                shapes += [((b, a, k, k), bound), ((b,), bound)]
                names += [f"c{i}.{sub}.{conv}.w", f"c{i}.{sub}.{conv}.b"]
    named = dict(zip(names, _uniform_views(gen, shapes, device)))

    params: List[Optional[Dict]] = [None]            # the first squeeze
    per_octave = cfg["num_coupling"]
    for i in range(len(srf_couplings(cfg))):
        if i % per_octave == 0:
            params.append(None)                      # the octave's squeeze
        params.append({sub: {conv: {k: named[f"c{i}.{sub}.{conv}.{k}"]
                                    for k in ("w", "b")}
                             for conv in ("conv1", "conv2")}
                       for sub in ("s1", "s2")})
        params.append(None)                          # its permutation
    return params, named


def inr_weights(cfg: Dict, seed: int, device
                ) -> Tuple[Dict, Dict, Dict[str, torch.Tensor]]:
    """(params, consts, named): the RBF net's MLP in the program's layout
    (``{"mlp": [{"w": (fan_in, fan_out), "b"}], "enc": {}}``), its encoding
    constants (``{"enc": {"centres": (E, d), "sigma": (E,)}}``) and every
    tensor flat by name (``mlp<i>.<w|b>``, ``centres``, ``sigma``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    e = 2 * cfg["num_frequencies"]
    d = cfg["domain_dim"]
    widths = [e] + [cfg["hidden_dim"]] * cfg["num_layers"] + [
        cfg["output_channels"]]
    shapes = [((e, d), 1.0)]
    for a, b in zip(widths[:-1], widths[1:]):
        bound = 1.0 / math.sqrt(a)
        shapes += [((a, b), bound), ((b,), bound)]
    views = _uniform_views(gen, shapes, device)
    sigma = torch.randn(e, generator=gen, device=device).abs_()
    sigma = torch.sort(sigma.mul_(cfg["std_rbf"]).add_(1.0)).values
    mlp = [{"w": views[1 + 2 * i], "b": views[2 + 2 * i]}
           for i in range(len(widths) - 1)]
    named = {"centres": views[0], "sigma": sigma}
    for i, layer in enumerate(mlp):
        named[f"mlp{i}.w"], named[f"mlp{i}.b"] = layer["w"], layer["b"]
    return ({"mlp": mlp, "enc": {}}, {"enc": {"centres": views[0],
                                                "sigma": sigma}}, named)
