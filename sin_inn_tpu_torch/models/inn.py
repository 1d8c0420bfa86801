"""The SRF (``UncondSRFlow``) and IRN (``InvRescaleNet``) invertible
networks in PyTorch, NHWC.

Counterpart of ``sin_inn_tpu/models/inn.py``: a static layer spec plus a
params list aligned with it; :func:`inn_apply` walks the spec forward
(HR -> LR||z) or backward (LR||z -> HR). Conv weights are OIHW. The SRF
alternates 3x3 and 1x1 GLOW couplings after i-RevNet squeezes; the IRN
stacks ``InvBlockExp`` couplings (dense-block subnets) after Haar squeezes.

Kernel routing keeps the reference's rule: a 1x1 GLOW coupling goes through
the fused kernels (``ops/cuda/coupling.py``) unless a log-det is requested or
the compute mode is ``float32_highest``. It goes through the autograd
Functions there (K1/K2 forward, K3/K4 backward), under autograd or not.
Whether that is a CUDA kernel or its plain version is decided by the
tensor's device, nowhere else. The 3x3 couplings run as cuDNN convolutions,
as the JAX package keeps them on XLA by measurement (K8,
``ops/cuda/coupling3x3.py``, is reached only through its own module), and
so do the IRN's dense blocks.

Under tensor parallelism the caller names the GLOW couplings whose params
are TP shards (``tp``: layer index -> an object with ``subnet``, the conv
subnet on this rank's hidden shard, and ``whole``, the whole weights for the
fused 1x1 kernels); ``train/sr.py`` reads them from the train state's
shardings (``parallel/sharding.py`` ``tp_couplings``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.ops import coupling as C
from sin_inn_tpu_torch.ops import subnet as S
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.haar import (haar_log_det, haar_squeeze,
                                        haar_unsqueeze)
from sin_inn_tpu_torch.ops.permute import (invert_permutation,
                                           make_permutation, permute_channels)
from sin_inn_tpu_torch.ops.squeeze import depth_to_space, space_to_depth


@dataclass(frozen=True)
class LayerSpec:
    kind: str                 # squeeze | haar | glow | invblock | permute
    clamp: float = 0.0
    split_len1: int = 0
    kernel: int = 0                 # glow subnet conv kernel (3 or 1)
    hidden: int = 256
    gc: int = 32                    # invblock dense-block growth channels
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


def build_irn_spec(cfg: SRConfig, c: int) -> Tuple[List[LayerSpec], int]:
    """InvRescaleNet layer stack. Returns (spec, out_channels)."""
    spec: List[LayerSpec] = [LayerSpec("haar")]
    c *= 4
    for _ in range(cfg.octaves):
        spec.append(LayerSpec("haar"))
        c *= 4
        for _ in range(cfg.num_coupling):
            spec.append(LayerSpec(
                "invblock", clamp=cfg.clamp_irn,
                split_len1=min(cfg.lr_dims, c // 2), gc=cfg.dense_gc,
                compute=cfg.compute_dtype))
    return spec, c


def build_inn_spec(cfg: SRConfig, c: int = 3) -> Tuple[List[LayerSpec], int]:
    if cfg.architecture == "SRF":
        return build_srf_spec(cfg, c)
    return build_irn_spec(cfg, c)


def init_inn(gen: torch.Generator, spec: Sequence[LayerSpec], c_in: int = 3,
             dtype=torch.float32) -> List[Optional[Dict]]:
    """Initialize the params list aligned with ``spec`` on ``gen``'s device."""
    params: List[Optional[Dict]] = []
    c = c_in
    for layer in spec:
        if layer.kind in ("squeeze", "haar"):
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
        elif layer.kind == "invblock":
            len1 = layer.split_len1
            len2 = c - len1
            params.append({
                "F": S.dense_block_init(gen, len2, len1, layer.gc, dtype),
                "G": S.dense_block_init(gen, len1, len2, layer.gc, dtype),
                "H": S.dense_block_init(gen, len1, len2, layer.gc, dtype),
            })
        else:
            raise ValueError(layer.kind)
    return params


def _apply_layer(layer: LayerSpec, p: Optional[Dict], x: torch.Tensor,
                 rev: bool, with_log_det: bool, tp=None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if layer.kind == "squeeze":
        return (depth_to_space(x) if rev else space_to_depth(x)), None
    if layer.kind == "haar":
        y = haar_unsqueeze(x) if rev else haar_squeeze(x)
        if not with_log_det:
            return y, None
        n, h, w, c = x.shape
        ld = haar_log_det(h, w, c)
        return y, torch.full((n,), -ld if rev else ld, dtype=x.dtype,
                             device=x.device)
    if layer.kind == "permute":
        return permute_channels(x, layer.perm_inv if rev else layer.perm), None
    if layer.kind == "invblock":
        subnet = partial(S.dense_block_apply,
                         compute=S.compute_mode(layer.compute))
        if rev:
            if with_log_det:
                return C.inv_block_inverse_ld(p, x, subnet, layer.clamp,
                                              layer.split_len1)
            return C.inv_block_inverse(p, x, subnet, layer.clamp,
                                       layer.split_len1), None
        return C.inv_block_forward(p, x, subnet, layer.clamp,
                                   layer.split_len1)
    if layer.kind != "glow":
        raise ValueError(layer.kind)
    if layer.use_kernel and layer.kernel == 1 and not with_log_det:
        # the kernels return y only, so a log-det request takes the
        # convolution path (same math); they take whole weights
        return K.fused_coupling(p if tp is None else tp.whole(p),
                                x.contiguous(), layer.clamp,
                                layer.split_len1, inverse=rev), None
    subnet = partial(S.conv_subnet_apply if tp is None else tp.subnet,
                     compute=S.compute_mode(layer.compute))
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
              remat: bool = False,
              tp: Optional[Mapping[int, Any]] = None):
    """Run the INN forward (HR -> LR||z) or inverse (LR||z -> HR).

    Returns ``x`` or, with ``with_log_det``, ``(x, log_det per sample)``.
    ``remat=True`` wraps each coupling in ``torch.utils.checkpoint``: the
    backward keeps only each coupling's input and recomputes the coupling.
    ``tp``: the GLOW couplings that run tensor-parallel, by layer index
    (``parallel/sharding.py`` ``tp_couplings``); the others run whole.
    """
    log_det = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    pairs = list(enumerate(zip(spec, params)))
    if rev:
        pairs = pairs[::-1]
    for i, (layer, p) in pairs:
        tp_i = tp.get(i) if tp else None
        if remat and layer.kind in ("glow", "invblock"):
            x, ld = checkpoint(_apply_layer, layer, p, x, rev, with_log_det,
                               tp_i, use_reentrant=False)
        else:
            x, ld = _apply_layer(layer, p, x, rev, with_log_det, tp_i)
        if with_log_det and ld is not None:
            log_det = log_det + ld
    if with_log_det:
        return x, log_det
    return x


_GLOW_SUBNETS = (("s1", "s2"), ("conv1", "conv2"))
_INVBLOCK_SUBNETS = (("F", "G", "H"), tuple(f"conv{i}" for i in range(1, 6)))


def flat_params(params: Sequence[Optional[Dict]]) -> List[torch.Tensor]:
    """Every tensor of a params list, in a fixed order (the optimizer's)."""
    out = []
    for p in params:
        if p is None:
            continue
        subs, convs = _GLOW_SUBNETS if "s1" in p else _INVBLOCK_SUBNETS
        out += [p[s][c][k] for s in subs for c in convs for k in ("w", "b")]
    return out


def param_count(params: Sequence[Optional[Dict]]) -> int:
    """Number of scalars in a params list (the JAX package's
    ``param_count``)."""
    return sum(t.numel() for t in flat_params(params))


def params_to(params: Sequence[Optional[Dict]], device) -> List[Optional[Dict]]:
    """A copy of the params list with every tensor on ``device``."""
    return [None if p is None else
            {s: {c: {k: t.to(device) for k, t in conv.items()}
                 for c, conv in sub.items()} for s, sub in p.items()}
            for p in params]
