"""RAFT optical-flow inference in PyTorch: the pseudo-GT producer of the
flow pipeline.

Counterpart of ``sin_inn_tpu/models/raft.py``: the public RAFT architecture
(Teed & Deng, "RAFT: Recurrent All-Pairs Field Transforms for Optical Flow",
ECCV 2020) in both official variants, the "basic" model (BasicEncoder,
SepConvGRU, convex 8x upsampling) and ``--small`` (SmallEncoder with
BottleneckBlocks, plain ConvGRU, bilinear 8x upsampling; hidden 96, context
64, corr radius 3). :func:`load_torch_weights` reads an official checkpoint
(``raft-things.pth``, ``raft-small.pth``) and detects the variant from its
keys; :func:`make_raft_producer` wraps the model as the producer that
``data/flow_media.py`` ``generate_pseudo_gt`` calls.

Layout: activations NHWC in and out, as in the JAX package; the convolutions
see them through ``.permute(0, 3, 1, 2)`` (the ``channels_last`` memory
format cuDNN takes without a copy). Parameters are a flat dict keyed by the
official module paths (``fnet.conv1.weight`` ...) with conv kernels in the
official OIHW layout, so a checkpoint loads without a transpose. No kernel
of this module is hand-written: the convolutions run on cuDNN, the
correlation volume and its lookup on ``torch.bmm`` / ``torch.gather``.

Precision (``lookup_precision`` of :func:`raft_flow`): ``None`` keeps fp32
storage and lets cuDNN use TF32 for the convolutions, as ``ops/subnet.py``
``conv2d`` does; ``"highest"`` turns TF32 off for every convolution and
product of the call, through context managers that restore the flags, and
lets cuDNN autotune its fp32 algorithms (its heuristics pick a
pathologically slow one for two convolutions at batch 4).

The check against the official implementation's output on a real
``raft-things.pth`` waits for such a checkpoint in the repository: the
tests hold this module against the JAX package and the committed goldens
``tests/goldens/raft_{basic,small}.npz``, which a shared convention fault
of both would not reveal.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sin_inn_tpu_torch.ops.subnet import _cudnn_tf32, _matmul_tf32
from sin_inn_tpu_torch.ops.warp import sample_bilinear

Params = Dict[str, torch.Tensor]

# correlation pyramid (official defaults for the basic model)
CORR_LEVELS = 4
CORR_RADIUS = 4
HDIM = 128   # GRU hidden
CDIM = 128   # context

# --small variant dims (official RAFT(args.small) defaults)
S_HDIM = 96
S_CDIM = 64
S_CORR_RADIUS = 3

LOOKUPS = ("matmul", "take")


# ---------------------------------------------------------------------------
# Parameter schema and init (the official shapes, conv kernels OIHW)
# ---------------------------------------------------------------------------

def _encoder_schema(prefix: str, norm: str) -> Dict[str, Tuple[int, ...]]:
    """BasicEncoder parameter shapes. ``norm``: 'instance' (fnet; the
    official InstanceNorm2d is affine-free, so it has no parameters) or
    'batch' (cnet; inference BatchNorm: weight, bias, mean, var)."""
    s: Dict[str, Tuple[int, ...]] = {}

    def conv(name, kh, kw, cin, cout):
        s[f"{prefix}.{name}.weight"] = (cout, cin, kh, kw)
        s[f"{prefix}.{name}.bias"] = (cout,)

    def bn(name, c):
        if norm == "batch":
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                s[f"{prefix}.{name}.{leaf}"] = (c,)

    conv("conv1", 7, 7, 3, 64)
    bn("norm1", 64)
    dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
    for li, (cin, cout, stride) in enumerate(dims, start=1):
        for bi in range(2):
            b_cin = cin if bi == 0 else cout
            b_stride = stride if bi == 0 else 1
            base = f"layer{li}.{bi}"
            conv(f"{base}.conv1", 3, 3, b_cin, cout)
            conv(f"{base}.conv2", 3, 3, cout, cout)
            bn(f"{base}.norm1", cout)
            bn(f"{base}.norm2", cout)
            if b_stride != 1:
                conv(f"{base}.downsample.0", 1, 1, b_cin, cout)
                bn(f"{base}.downsample.1", cout)
    conv("conv2", 1, 1, 128, 256)
    return s


def _update_schema() -> Dict[str, Tuple[int, ...]]:
    s: Dict[str, Tuple[int, ...]] = {}
    p = "update_block"
    corr_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2   # 324

    def conv(name, kh, kw, cin, cout):
        s[f"{p}.{name}.weight"] = (cout, cin, kh, kw)
        s[f"{p}.{name}.bias"] = (cout,)

    # BasicMotionEncoder
    conv("encoder.convc1", 1, 1, corr_planes, 256)
    conv("encoder.convc2", 3, 3, 256, 192)
    conv("encoder.convf1", 7, 7, 2, 128)
    conv("encoder.convf2", 3, 3, 128, 64)
    conv("encoder.conv", 3, 3, 192 + 64, 126)
    # SepConvGRU (input = context 128 + motion 128 = 256; hidden 128)
    for g in ("convz1", "convr1", "convq1"):
        conv(f"gru.{g}", 1, 5, HDIM + 256, HDIM)
    for g in ("convz2", "convr2", "convq2"):
        conv(f"gru.{g}", 5, 1, HDIM + 256, HDIM)
    # FlowHead
    conv("flow_head.conv1", 3, 3, HDIM, 256)
    conv("flow_head.conv2", 3, 3, 256, 2)
    # convex-upsampling mask head
    conv("mask.0", 3, 3, HDIM, 256)
    conv("mask.2", 1, 1, 256, 64 * 9)
    return s


def _small_encoder_schema(prefix: str,
                          out_dim: int) -> Dict[str, Tuple[int, ...]]:
    """SmallEncoder parameter shapes. Neither small encoder has norm
    parameters (fnet: affine-free InstanceNorm2d, cnet: norm_fn='none')."""
    s: Dict[str, Tuple[int, ...]] = {}

    def conv(name, kh, kw, cin, cout):
        s[f"{prefix}.{name}.weight"] = (cout, cin, kh, kw)
        s[f"{prefix}.{name}.bias"] = (cout,)

    conv("conv1", 7, 7, 3, 32)
    dims = [(32, 32, 1), (32, 64, 2), (64, 96, 2)]
    for li, (cin, planes, stride) in enumerate(dims, start=1):
        for bi in range(2):
            b_cin = cin if bi == 0 else planes
            b_stride = stride if bi == 0 else 1
            base = f"layer{li}.{bi}"
            conv(f"{base}.conv1", 1, 1, b_cin, planes // 4)
            conv(f"{base}.conv2", 3, 3, planes // 4, planes // 4)
            conv(f"{base}.conv3", 1, 1, planes // 4, planes)
            if b_stride != 1:
                conv(f"{base}.downsample.0", 1, 1, b_cin, planes)
    conv("conv2", 1, 1, 96, out_dim)
    return s


def _small_update_schema() -> Dict[str, Tuple[int, ...]]:
    s: Dict[str, Tuple[int, ...]] = {}
    p = "update_block"
    corr_planes = CORR_LEVELS * (2 * S_CORR_RADIUS + 1) ** 2   # 196

    def conv(name, kh, kw, cin, cout):
        s[f"{p}.{name}.weight"] = (cout, cin, kh, kw)
        s[f"{p}.{name}.bias"] = (cout,)

    # SmallMotionEncoder (no convc2): output cat([out80, flow2]) = 82 ch
    conv("encoder.convc1", 1, 1, corr_planes, 96)
    conv("encoder.convf1", 7, 7, 2, 64)
    conv("encoder.convf2", 3, 3, 64, 32)
    conv("encoder.conv", 3, 3, 96 + 32, 80)
    # plain ConvGRU; input = context 64 + motion 82 = 146
    for g in ("convz", "convr", "convq"):
        conv(f"gru.{g}", 3, 3, S_HDIM + 146, S_HDIM)
    # FlowHead(96, hidden 128); no convex-mask head (bilinear upsampling)
    conv("flow_head.conv1", 3, 3, S_HDIM, 128)
    conv("flow_head.conv2", 3, 3, 128, 2)
    return s


def param_schema(variant: str = "basic") -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape (conv kernels OIHW)."""
    s = {}
    if variant == "small":
        s.update(_small_encoder_schema("fnet", 128))
        s.update(_small_encoder_schema("cnet", S_HDIM + S_CDIM))
        s.update(_small_update_schema())
        return s
    s.update(_encoder_schema("fnet", "instance"))
    s.update(_encoder_schema("cnet", "batch"))
    s.update(_update_schema())
    return s


def init_raft(gen: torch.Generator, variant: str = "basic") -> Params:
    """Random parameters of the official shapes on ``gen``'s device, drawn
    from ``gen`` (for tests; real use loads a pretrained checkpoint through
    :func:`load_torch_weights`)."""
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    params: Params = {}
    for name, shape in param_schema(variant).items():
        if name.endswith(("bias", "running_mean")):
            params[name] = 0.1 * torch.randn(shape, generator=gen, device=dev)
        elif len(shape) == 1:       # norm weight and running_var
            params[name] = uniform(shape, 0.5, 1.5)
        else:
            fan_in = shape[1] * shape[2] * shape[3]
            params[name] = (torch.randn(shape, generator=gen, device=dev)
                            / math.sqrt(fan_in))
    return params


def detect_variant(keys) -> str:
    """'small' iff the keys hold the plain ConvGRU's (the basic model's
    SepConvGRU has convz1 / convz2; --small has one convz)."""
    return "small" if any(k.endswith("gru.convz.weight") for k in keys) \
        else "basic"


def load_torch_weights(path: str, variant: Optional[str] = None,
                       device="cpu") -> Params:
    """Load an official RAFT checkpoint (a torch ``state_dict``, e.g.
    ``raft-things.pth`` or ``raft-small.pth`` of princeton-vl/RAFT) onto
    ``device``. ``variant=None`` detects it with :func:`detect_variant`.

    Strips the ``module.`` DataParallel prefix, unwraps a ``state_dict``
    entry, drops the batch-norm ``num_batches_tracked`` counters and keeps
    the conv kernels OIHW. Every key and shape of the schema is checked, so
    a wrong or truncated file fails here.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state_dict")
    if "state_dict" in sd and not any(k.startswith(("module.", "fnet."))
                                      for k in sd):
        sd = sd["state_dict"]

    params: Params = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        params[k] = v.detach()

    if variant is None:
        variant = detect_variant(params)
    schema = param_schema(variant)
    missing = sorted(set(schema) - set(params))
    if missing:
        raise ValueError(f"{path}: missing RAFT ({variant}) params: "
                         f"{missing[:5]} (+{max(len(missing) - 5, 0)})")
    for name, shape in schema.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{path}: {name} has shape "
                             f"{tuple(params[name].shape)}, want {shape}")
    return {k: params[k].to(device=device, dtype=torch.float32).contiguous()
            for k in schema}


# ---------------------------------------------------------------------------
# Building blocks (NHWC)
# ---------------------------------------------------------------------------

def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm2d (torch defaults: biased variance)."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def _norm(p: Params, prefix: str, x: torch.Tensor, norm: str) -> torch.Tensor:
    if norm == "none":          # small cnet: norm_fn='none'
        return x
    if norm == "instance":
        return _instance_norm(x)
    # inference-mode BatchNorm2d
    w = p[f"{prefix}.weight"]
    b = p[f"{prefix}.bias"]
    mean = p[f"{prefix}.running_mean"]
    var = p[f"{prefix}.running_var"]
    return (x - mean) * torch.rsqrt(var + 1e-5) * w + b


def _conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
          pad: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """NHWC conv with an OIHW kernel, torch-style symmetric padding (k // 2
    by default, or an explicit ``pad`` of (rows, cols)) and ``stride``."""
    w = p[f"{name}.weight"]
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = (kh // 2, kw // 2) if pad is None else pad
    out = F.conv2d(x.permute(0, 3, 1, 2), w, p[f"{name}.bias"],
                   stride=stride, padding=(ph, pw))
    return out.permute(0, 2, 3, 1)


def _res_block(p: Params, prefix: str, x: torch.Tensor, stride: int,
               norm: str) -> torch.Tensor:
    y = torch.relu(_norm(p, f"{prefix}.norm1",
                         _conv(p, f"{prefix}.conv1", x, stride=stride), norm))
    y = torch.relu(_norm(p, f"{prefix}.norm2",
                         _conv(p, f"{prefix}.conv2", y), norm))
    if stride != 1:
        x = _norm(p, f"{prefix}.downsample.1",
                  _conv(p, f"{prefix}.downsample.0", x, stride=stride), norm)
    return torch.relu(x + y)


def _encoder(p: Params, prefix: str, x: torch.Tensor,
             norm: str) -> torch.Tensor:
    """BasicEncoder: 1/8-resolution 256-channel features."""
    x = torch.relu(_norm(p, f"{prefix}.norm1",
                         _conv(p, f"{prefix}.conv1", x, stride=2), norm))
    for li, stride in ((1, 1), (2, 2), (3, 2)):
        x = _res_block(p, f"{prefix}.layer{li}.0", x, stride, norm)
        x = _res_block(p, f"{prefix}.layer{li}.1", x, 1, norm)
    return _conv(p, f"{prefix}.conv2", x)


def _bottleneck_block(p: Params, prefix: str, x: torch.Tensor, stride: int,
                      norm: str) -> torch.Tensor:
    """Official BottleneckBlock: 1x1 -> 3x3 (stride) -> 1x1 at planes // 4,
    relu after every (parameter-free) norm; 1x1 downsample when strided."""
    y = torch.relu(_norm(p, "", _conv(p, f"{prefix}.conv1", x), norm))
    y = torch.relu(_norm(p, "", _conv(p, f"{prefix}.conv2", y,
                                      stride=stride), norm))
    y = torch.relu(_norm(p, "", _conv(p, f"{prefix}.conv3", y), norm))
    if stride != 1:
        x = _norm(p, "", _conv(p, f"{prefix}.downsample.0", x,
                               stride=stride), norm)
    return torch.relu(x + y)


def _small_encoder(p: Params, prefix: str, x: torch.Tensor,
                   norm: str) -> torch.Tensor:
    """SmallEncoder: 1/8-resolution features (out_dim set by conv2)."""
    x = torch.relu(_norm(p, "", _conv(p, f"{prefix}.conv1", x, stride=2),
                         norm))
    for li, stride in ((1, 1), (2, 2), (3, 2)):
        x = _bottleneck_block(p, f"{prefix}.layer{li}.0", x, stride, norm)
        x = _bottleneck_block(p, f"{prefix}.layer{li}.1", x, 1, norm)
    return _conv(p, f"{prefix}.conv2", x)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(2, 2) of (Q, h, w, C): floors odd sizes, and a side under
    2 pools to an empty level, as in the JAX package."""
    q, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :2 * h2, :2 * w2].reshape(q, h2, 2, w2, 2, c)
    return x.sum(dim=(2, 4)) * 0.25


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------

def build_corr_pyramid(fmap1: torch.Tensor,
                       fmap2: torch.Tensor) -> List[torch.Tensor]:
    """All-pairs correlation pyramid.

    fmap1 / fmap2: (B, H, W, C) at 1/8 resolution. Level i: (B*H*W, H/2^i,
    W/2^i, 1). The full volume is one batched product divided by sqrt(C),
    then three 2x2 average pools.
    """
    b, h, w, c = fmap1.shape
    corr = torch.bmm(fmap1.reshape(b, h * w, c),
                     fmap2.reshape(b, h * w, c).transpose(1, 2)) / math.sqrt(c)
    pyramid = [corr.reshape(b * h * w, h, w, 1)]
    for _ in range(CORR_LEVELS - 1):
        pyramid.append(_avg_pool2(pyramid[-1]))
    return pyramid


def pad_corr_pyramid(pyramid, r: int = CORR_RADIUS) -> List[torch.Tensor]:
    """Zero-pad every level for the patch-form lookup, once a pair. The pad
    is the patch side (2r+2): a window whose true start lies beyond it is
    wholly out of frame, and the clamped patch then reads only the zero
    margin, as the official zero padding does."""
    p = 2 * r + 2
    return [F.pad(c[..., 0], (p, p, p, p)) for c in pyramid]


def lookup_corr_padded(padded, coords: torch.Tensor,
                       r: int = CORR_RADIUS) -> torch.Tensor:
    """Patch-form correlation lookup on a :func:`pad_corr_pyramid` pyramid.

    The (2r+1)^2 bilinear taps of a query sit at integer offsets around one
    coordinate, so they share its fractional weights: one ``torch.gather``
    of the (2r+2)^2 integer patch a query, then a separable two-tap hat
    combine, gives every sample. coords: (B, H, W, 2) as (x, y) at 1/8
    resolution. Returns (B, H, W, L*(2r+1)^2) in the official channel order:
    x-offset slow, y-offset fast, levels coarse-last.
    """
    b, h, w, _ = coords.shape
    n = 2 * r + 1
    p = n + 1
    flat = coords.reshape(b * h * w, 2)
    out = []
    for i, cpad in enumerate(padded):
        q, hp2, wp2 = cpad.shape
        hi, wi = hp2 - 2 * p, wp2 - 2 * p
        c = flat / (2 ** i)
        # clip before the integer cast: huge or infinite coordinates must
        # not wrap; anything past the pad margin reads zeros either way
        cx = torch.clamp(c[:, 0], -2.0 * p - wi, wi + 2.0 * p)
        cy = torch.clamp(c[:, 1], -2.0 * p - hi, hi + 2.0 * p)
        x0 = torch.floor(cx)
        y0 = torch.floor(cy)
        fx = (cx - x0)[:, None, None]
        fy = (cy - y0)[:, None, None]
        ys = torch.clamp(y0.long() - r + p, 0, hp2 - p)
        xs = torch.clamp(x0.long() - r + p, 0, wp2 - p)
        ar = torch.arange(p, device=coords.device)
        cells = (ar[:, None] * wp2 + ar[None, :]).reshape(-1)
        idx = (ys * wp2 + xs)[:, None] + cells[None]         # (Q, p*p)
        patch = torch.gather(cpad.reshape(q, hp2 * wp2), 1,
                             idx).reshape(q, p, p)
        rows = patch[:, :-1, :] * (1 - fy) + patch[:, 1:, :] * fy
        samp = rows[:, :, :-1] * (1 - fx) + rows[:, :, 1:] * fx  # (Q,[y],[x])
        out.append(samp.transpose(1, 2).reshape(b, h, w, n * n))
    return torch.cat(out, dim=-1)


def lookup_corr(pyramid, coords: torch.Tensor,
                r: int = CORR_RADIUS) -> torch.Tensor:
    """Sample a (2r+1)^2 neighbourhood around ``coords`` at every level: the
    patch form on a pyramid padded here (callers in a loop pad once with
    :func:`pad_corr_pyramid`)."""
    return lookup_corr_padded(pad_corr_pyramid(pyramid, r), coords, r)


def lookup_corr_matmul(pyramid, coords: torch.Tensor,
                       r: int = CORR_RADIUS,
                       precision=None) -> torch.Tensor:
    """Bilinear correlation lookup as two hat-weighted batched products.

    The read is separable bilinear sampling from each query's own (hi, wi)
    slice: ``rows[q] = RA[q] @ vol[q]`` and ``taps[q] = rows[q] @ CB[q]^T``,
    where RA / CB hold the two-tap hat rows ((1 - f) at floor + offset, f at
    floor + offset + 1) built from index compares. The bilinear weights are
    folded into the selection, and an index outside the slice matches no
    row, so it reads an exact zero (the official zero padding) with no
    padded copy. ``precision="highest"`` runs the products with TF32 off
    even where the caller allowed it.

    pyramid: the unpadded :func:`build_corr_pyramid` output. Returns (B, H,
    W, L*(2r+1)^2) in the official channel order (x slow, y fast).
    """
    b, h, w, _ = coords.shape
    n = 2 * r + 1
    flat = coords.reshape(b * h * w, 2)
    offs = torch.arange(n, device=coords.device) - r
    out = []
    for i, lvl in enumerate(pyramid):
        q, hi, wi, _ = lvl.shape
        vol = lvl[..., 0]                                 # (Q, hi, wi)
        c = flat / (2 ** i)
        # clip before the integer cast: huge or infinite coordinates must
        # not wrap; anything outside [0, hi / wi) matches no index
        cx = torch.clamp(c[:, 0], -2.0 * n, wi + 2.0 * n)
        cy = torch.clamp(c[:, 1], -2.0 * n, hi + 2.0 * n)
        x0 = torch.floor(cx)
        y0 = torch.floor(cy)
        fx = (cx - x0).to(vol.dtype)[:, None, None]
        fy = (cy - y0).to(vol.dtype)[:, None, None]
        ty = (y0.long()[:, None] + offs[None])[:, :, None]   # (Q, n, 1)
        tx = (x0.long()[:, None] + offs[None])[:, :, None]
        ks = torch.arange(hi, device=coords.device)[None, None]
        js = torch.arange(wi, device=coords.device)[None, None]
        ra = ((ks == ty).to(vol.dtype) * (1 - fy)
              + (ks == ty + 1).to(vol.dtype) * fy)          # (Q, n, hi)
        cb = ((js == tx).to(vol.dtype) * (1 - fx)
              + (js == tx + 1).to(vol.dtype) * fx)          # (Q, n, wi)
        with (_matmul_tf32(False) if precision == "highest"
              else contextlib.nullcontext()):
            rows = torch.bmm(ra, vol)                        # (Q, a, wi)
            taps = torch.bmm(rows, cb.transpose(1, 2))       # (Q, a, b)
        # official channel order: x-offset slow, y-offset fast
        out.append(taps.transpose(1, 2).reshape(b, h, w, n * n))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# Update blocks
# ---------------------------------------------------------------------------

def _sep_conv_gru(p: Params, net: torch.Tensor,
                  inp: torch.Tensor) -> torch.Tensor:
    g = "update_block.gru"
    for suffix, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([net, inp], dim=-1)
        z = torch.sigmoid(_conv(p, f"{g}.convz{suffix}", hx, pad=pad))
        r = torch.sigmoid(_conv(p, f"{g}.convr{suffix}", hx, pad=pad))
        q = torch.tanh(_conv(p, f"{g}.convq{suffix}",
                             torch.cat([r * net, inp], dim=-1), pad=pad))
        net = (1.0 - z) * net + z * q
    return net


def _motion_encoder(p: Params, flow: torch.Tensor,
                    corr: torch.Tensor) -> torch.Tensor:
    e = "update_block.encoder"
    cor = torch.relu(_conv(p, f"{e}.convc1", corr))
    cor = torch.relu(_conv(p, f"{e}.convc2", cor))
    flo = torch.relu(_conv(p, f"{e}.convf1", flow))
    flo = torch.relu(_conv(p, f"{e}.convf2", flo))
    out = torch.relu(_conv(p, f"{e}.conv", torch.cat([cor, flo], dim=-1)))
    return torch.cat([out, flow], dim=-1)


def _update_block(p: Params, net, inp, corr, flow):
    motion = _motion_encoder(p, flow, corr)
    net = _sep_conv_gru(p, net, torch.cat([inp, motion], dim=-1))
    dflow = _conv(p, "update_block.flow_head.conv2",
                  torch.relu(_conv(p, "update_block.flow_head.conv1", net)))
    mask = 0.25 * _conv(p, "update_block.mask.2",
                        torch.relu(_conv(p, "update_block.mask.0", net)))
    return net, mask, dflow


def _conv_gru(p: Params, net: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """Plain 3x3 ConvGRU (the --small update block's recurrence)."""
    g = "update_block.gru"
    hx = torch.cat([net, inp], dim=-1)
    z = torch.sigmoid(_conv(p, f"{g}.convz", hx))
    r = torch.sigmoid(_conv(p, f"{g}.convr", hx))
    q = torch.tanh(_conv(p, f"{g}.convq", torch.cat([r * net, inp], dim=-1)))
    return (1.0 - z) * net + z * q


def _small_motion_encoder(p: Params, flow: torch.Tensor,
                          corr: torch.Tensor) -> torch.Tensor:
    e = "update_block.encoder"
    cor = torch.relu(_conv(p, f"{e}.convc1", corr))
    flo = torch.relu(_conv(p, f"{e}.convf1", flow))
    flo = torch.relu(_conv(p, f"{e}.convf2", flo))
    out = torch.relu(_conv(p, f"{e}.conv", torch.cat([cor, flo], dim=-1)))
    return torch.cat([out, flow], dim=-1)


def _small_update_block(p: Params, net, inp, corr, flow):
    motion = _small_motion_encoder(p, flow, corr)
    net = _conv_gru(p, net, torch.cat([inp, motion], dim=-1))
    dflow = _conv(p, "update_block.flow_head.conv2",
                  torch.relu(_conv(p, "update_block.flow_head.conv1", net)))
    return net, dflow


# ---------------------------------------------------------------------------
# Upsampling
# ---------------------------------------------------------------------------

def upsample_flow_bilinear8(flow: torch.Tensor) -> torch.Tensor:
    """``upflow8``: 8 x the bilinear 8x resize with align_corners=True (the
    --small model has no convex mask head)."""
    b, h, w, _ = flow.shape
    ys = torch.arange(8 * h, dtype=flow.dtype, device=flow.device) \
        * ((h - 1) / (8 * h - 1))
    xs = torch.arange(8 * w, dtype=flow.dtype, device=flow.device) \
        * ((w - 1) / (8 * w - 1))
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy = gy[None].expand(b, 8 * h, 8 * w)
    gx = gx[None].expand(b, 8 * h, 8 * w)
    return 8.0 * sample_bilinear(flow, gx, gy, padding="border")


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned convex 8x upsampling. flow (B, H, W, 2), mask (B, H, W, 576).

    The official channel layout (``mask.view(N, 1, 9, 8, 8, H, W)``):
    channel k*64 + dy*8 + dx, k the 3x3 unfold window in row-major order.
    """
    b, h, w, _ = flow.shape
    padded = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    # taps[..., k, :] = 8 flow at (y + ky - 1, x + kx - 1), k = ky*3 + kx
    taps = torch.stack([padded[:, ky:ky + h, kx:kx + w, :]
                        for ky in range(3) for kx in range(3)], dim=3)
    m = torch.softmax(mask.reshape(b, h, w, 9, 64), dim=3)
    up = (m[..., None] * taps[:, :, :, :, None, :]).sum(dim=3)  # (B,H,W,64,2)
    up = up.reshape(b, h, w, 8, 8, 2)
    # d = dy*8 + dx; full-resolution pixel (8y + dy, 8x + dx)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(b, h, w, 2)


@torch.no_grad()
def raft_flow(params: Params, image1: torch.Tensor, image2: torch.Tensor,
              iters: int = 20, variant: str = "basic",
              lookup: str = "matmul", lookup_precision=None) -> torch.Tensor:
    """Flow from image1 to image2 at full resolution.

    image1 / image2: (B, H, W, 3) in [0, 255] on the params' device, H and
    W multiples of 8 (use :func:`pad_to_multiple` otherwise). Returns (B, H,
    W, 2) pixel flow as (dx, dy). ``iters`` refinement steps (the reference
    ran 20). ``variant``: "basic" (SepConvGRU, convex upsampling) or "small"
    (SmallEncoder, plain ConvGRU, bilinear upsampling, corr radius 3).
    ``lookup``: "matmul" (:func:`lookup_corr_matmul`) or "take" (the
    gathered patch form, :func:`lookup_corr_padded`). ``lookup_precision``:
    None (fp32 storage, TF32 allowed in cuDNN's convolutions) or "highest"
    (TF32 off for every convolution and product of the call).
    """
    if lookup not in LOOKUPS:
        raise ValueError(f"lookup={lookup!r}: want 'matmul' or 'take'")
    if lookup_precision not in (None, "highest"):
        raise ValueError(f"lookup_precision={lookup_precision!r}: want None "
                         "or 'highest'")
    highest = lookup_precision == "highest"
    # in fp32 without TF32, cuDNN's heuristics pick an algorithm with a
    # 17-25 GiB workspace for two of the motion encoder's 3x3 convolutions
    # at batch 4 (0.35-0.44 s each on an H100): that route autotunes
    with _cudnn_tf32(not highest, benchmark=True if highest else None), \
            (_matmul_tf32(False) if highest else contextlib.nullcontext()):
        return _raft_flow(params, image1, image2, iters, variant, lookup)


def _raft_flow(params, image1, image2, iters, variant, lookup):
    small = variant == "small"
    x1 = 2.0 * (image1 / 255.0) - 1.0
    x2 = 2.0 * (image2 / 255.0) - 1.0

    # the official fnet runs both images as one batch; instance norm keeps
    # the two halves independent
    fenc = _small_encoder if small else _encoder
    fmaps = fenc(params, "fnet", torch.cat([x1, x2], 0), "instance")
    fmap1, fmap2 = torch.chunk(fmaps, 2, dim=0)
    radius = S_CORR_RADIUS if small else CORR_RADIUS
    raw_pyramid = build_corr_pyramid(fmap1, fmap2)
    if lookup == "matmul":
        lookup_fn = lambda c: lookup_corr_matmul(raw_pyramid, c, r=radius)
    else:
        padded = pad_corr_pyramid(raw_pyramid, radius)
        lookup_fn = lambda c: lookup_corr_padded(padded, c, r=radius)

    if small:
        cnet = _small_encoder(params, "cnet", x1, "none")
        hdim = S_HDIM
    else:
        cnet = _encoder(params, "cnet", x1, "batch")
        hdim = HDIM
    net = torch.tanh(cnet[..., :hdim])
    inp = torch.relu(cnet[..., hdim:])

    b, h, w, _ = fmap1.shape
    coords0 = _coords_grid(b, h, w, fmap1.device)
    coords1 = coords0
    mask = None
    for _ in range(iters):
        corr = lookup_fn(coords1)
        flow = coords1 - coords0
        if small:
            net, dflow = _small_update_block(params, net, inp, corr, flow)
        else:
            # only the last iteration's mask is used
            net, mask, dflow = _update_block(params, net, inp, corr, flow)
        coords1 = coords1 + dflow
    if small:
        return upsample_flow_bilinear8(coords1 - coords0)
    if mask is None:
        mask = torch.zeros((b, h, w, 64 * 9), dtype=torch.float32,
                           device=fmap1.device)
    return upsample_flow_convex(coords1 - coords0, mask)


def pad_to_multiple(img: torch.Tensor, mult: int = 8):
    """Replicate-pad (B, H, W, C) up to the next multiple of ``mult`` (the
    official ``InputPadder``, Sintel mode: the padding split between both
    sides). Returns the padded tensor and the pads, as (before, after) per
    axis of (B, H, W, C)."""
    _, h, w, _ = img.shape
    ph = (-h) % mult
    pw = (-w) % mult
    pads = ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0))
    if ph or pw:
        img = F.pad(img.permute(0, 3, 1, 2),
                    (pads[2][0], pads[2][1], pads[1][0], pads[1][1]),
                    mode="replicate").permute(0, 2, 3, 1)
    return img, pads


def unpad(x: torch.Tensor, pads) -> torch.Tensor:
    _, (t, b), (l, r), _ = pads
    return x[:, t:x.shape[1] - b if b else None,
             l:x.shape[2] - r if r else None, :]


def make_raft_producer(ckpt_path: str, iters: int = 20, batch_pairs: int = 4,
                       device="cuda"):
    """A pseudo-GT flow producer backed by this module, on ``device``
    (``cuda`` unless the caller asks for the CPU; no card raises).

    Returns a callable ``(frame1, frame2) -> flow`` for
    ``data/flow_media.py`` ``generate_pseudo_gt``: frames are one (H, W, 3)
    pair or a (B, H, W, 3) batch of pairs, float in [0, 1], and the flow is
    (H, W, 2) or (B, H, W, 2) numpy, as (dx, dy). Its ``batch_pairs``
    attribute asks ``generate_pseudo_gt`` for that many consecutive pairs a
    call. The variant (basic or --small) is read from the checkpoint.
    """
    from sin_inn_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    params = load_torch_weights(ckpt_path, device=dev)
    variant = detect_variant(params)

    def producer(frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
        batched = np.asarray(frame1).ndim == 4
        f1 = torch.as_tensor(np.asarray(frame1, np.float32),
                             device=dev) * 255.0
        f2 = torch.as_tensor(np.asarray(frame2, np.float32),
                             device=dev) * 255.0
        if not batched:
            f1, f2 = f1[None], f2[None]
        f1, pads = pad_to_multiple(f1)
        f2, _ = pad_to_multiple(f2)
        flow = unpad(raft_flow(params, f1, f2, iters=iters, variant=variant),
                     pads)
        flow = flow.cpu().numpy()
        return flow if batched else flow[0]

    producer.batch_pairs = batch_pairs
    return producer
