"""The SRF invertible network (``UncondSRFlow``) in PyTorch, NHWC.

Counterpart of ``sin_inn_tpu/models/inn.py``: a static layer spec plus a
params list aligned with it; :func:`inn_apply` walks the spec forward
(HR -> LR||z) or backward (LR||z -> HR). Conv weights are OIHW.

Kernel routing keeps the reference's rule: a 1x1 GLOW coupling goes through
the fused kernels (``ops/cuda/coupling.py``) unless a log-det is requested or
the compute mode is ``float32_highest``. It goes through the autograd
Functions there (K1/K2 forward, K3/K4 backward), under autograd or not.
Whether that is a CUDA kernel or its plain version is decided by the
tensor's device, nowhere else. The 3x3 couplings run as cuDNN convolutions.
IRN waits for its slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.ops import coupling as C
from sin_inn_tpu_torch.ops import subnet as S
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.permute import (invert_permutation,
                                           make_permutation, permute_channels)
from sin_inn_tpu_torch.ops.squeeze import depth_to_space, space_to_depth


@dataclass(frozen=True)
class LayerSpec:
    kind: str                       # squeeze | glow | permute
    clamp: float = 0.0
    split_len1: int = 0
    kernel: int = 0                 # glow subnet conv kernel (3 or 1)
    hidden: int = 256
    perm: Optional[Tuple[int, ...]] = None       # permute only
    perm_inv: Optional[Tuple[int, ...]] = None
    compute: str = "float32"        # subnet compute mode (see ops.subnet)
    use_kernel: bool = False        # fused coupling kernel (1x1 glow only)


def _resolve_kernel(cfg: SRConfig) -> bool:
    # the fused kernels compute in plain fp32 at the card's default; keep the
    # strict-parity mode on the convolution path, as the reference does
    return cfg.use_kernel != "off" and cfg.compute_dtype != "float32_highest"


def build_srf_spec(cfg: SRConfig, c: int) -> Tuple[List[LayerSpec], int]:
    """SRFlow layer stack. Returns (spec, out_channels)."""
    use_kernel = _resolve_kernel(cfg)
    spec: List[LayerSpec] = [LayerSpec("squeeze")]
    c *= 4
    for _ in range(cfg.octaves):
        spec.append(LayerSpec("squeeze"))
        c *= 4
        for kk in range(cfg.num_coupling):
            spec.append(LayerSpec(
                "glow", clamp=cfg.clamp_srf, split_len1=c // 2,
                kernel=3 if kk % 2 == 0 else 1, hidden=cfg.hidden_channels,
                compute=cfg.compute_dtype, use_kernel=use_kernel))
            perm = make_permutation(c, seed=kk)
            spec.append(LayerSpec(
                "permute", perm=tuple(perm.tolist()),
                perm_inv=tuple(invert_permutation(perm).tolist())))
    return spec, c


def build_inn_spec(cfg: SRConfig, c: int = 3) -> Tuple[List[LayerSpec], int]:
    if cfg.architecture == "SRF":
        return build_srf_spec(cfg, c)
    raise NotImplementedError(
        "the IRN architecture is not ported to sin_inn_tpu_torch yet")


def init_inn(gen: torch.Generator, spec: Sequence[LayerSpec], c_in: int = 3,
             dtype=torch.float32) -> List[Optional[Dict]]:
    """Initialize the params list aligned with ``spec`` on ``gen``'s device."""
    params: List[Optional[Dict]] = []
    c = c_in
    for layer in spec:
        if layer.kind == "squeeze":
            c *= 4
            params.append(None)
        elif layer.kind == "permute":
            params.append(None)
        elif layer.kind == "glow":
            len1 = layer.split_len1
            len2 = c - len1
            params.append({
                # s1: y1 -> 2*len2 ; s2: x2 -> 2*len1 (FrEIA GLOWCouplingBlock)
                "s1": S.conv_subnet_init(gen, len1, 2 * len2, layer.kernel,
                                         layer.hidden, dtype),
                "s2": S.conv_subnet_init(gen, len2, 2 * len1, layer.kernel,
                                         layer.hidden, dtype),
            })
        else:
            raise ValueError(layer.kind)
    return params


def _apply_layer(layer: LayerSpec, p: Optional[Dict], x: torch.Tensor,
                 rev: bool, with_log_det: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if layer.kind == "squeeze":
        return (depth_to_space(x) if rev else space_to_depth(x)), None
    if layer.kind == "permute":
        return permute_channels(x, layer.perm_inv if rev else layer.perm), None
    if layer.kind != "glow":
        raise ValueError(layer.kind)
    if layer.use_kernel and layer.kernel == 1 and not with_log_det:
        # the kernels return y only, so a log-det request takes the
        # convolution path (same math)
        return K.fused_coupling(p, x.contiguous(), layer.clamp,
                                layer.split_len1, inverse=rev), None
    subnet = partial(S.conv_subnet_apply, compute=S.compute_mode(layer.compute))
    if rev:
        if with_log_det:
            return C.glow_coupling_inverse_ld(p, x, subnet, layer.clamp,
                                              layer.split_len1)
        return C.glow_coupling_inverse(p, x, subnet, layer.clamp,
                                       layer.split_len1), None
    return C.glow_coupling_forward(p, x, subnet, layer.clamp,
                                   layer.split_len1)


def inn_apply(spec: Sequence[LayerSpec], params: Sequence[Optional[Dict]],
              x: torch.Tensor, rev: bool = False, with_log_det: bool = False,
              remat: bool = False):
    """Run the INN forward (HR -> LR||z) or inverse (LR||z -> HR).

    Returns ``x`` or, with ``with_log_det``, ``(x, log_det per sample)``.
    ``remat=True`` wraps each coupling in ``torch.utils.checkpoint``: the
    backward keeps only each coupling's input and recomputes the coupling.
    """
    log_det = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    pairs = list(zip(spec, params))
    if rev:
        pairs = pairs[::-1]
    for layer, p in pairs:
        if remat and layer.kind == "glow":
            x, ld = checkpoint(_apply_layer, layer, p, x, rev, with_log_det,
                               use_reentrant=False)
        else:
            x, ld = _apply_layer(layer, p, x, rev, with_log_det)
        if with_log_det and ld is not None:
            log_det = log_det + ld
    if with_log_det:
        return x, log_det
    return x


def flat_params(params: Sequence[Optional[Dict]]) -> List[torch.Tensor]:
    """Every tensor of a params list, in a fixed order (the optimizer's)."""
    return [p[s][c][k] for p in params if p is not None
            for s in ("s1", "s2") for c in ("conv1", "conv2")
            for k in ("w", "b")]


def params_to(params: Sequence[Optional[Dict]], device) -> List[Optional[Dict]]:
    """A copy of the params list with every tensor on ``device``."""
    return [None if p is None else
            {s: {c: {k: t.to(device) for k, t in conv.items()}
                 for c, conv in sub.items()} for s, sub in p.items()}
            for p in params]
