"""Fused backward of the encoded coordinate MLP (K7 backward): CUDA kernel,
plain version and the autograd Function.

``fused_inr_backward`` replaces the TPU kernel ``_bwd_kernel`` of
``sin_inn_tpu/ops/pallas/inr.py`` in its ``const`` mask mode with
``prog=False`` (``_fused_bwd_call``): per tile of points it recomputes
encode -> mask -> MLP and emits the weight and bias gradients of every layer,
and nothing else (the coordinates, the mask and the parameter-free encodings
take no gradient). The kernel is ``csrc/inr_bwd.cu``; its header states what
bounds it on an H100 and how the design deals with that. The forward kernel
of the TPU package and its per-point mask modes serve the progressive nets
and are not ported yet.

:class:`FusedINR` is the counterpart of ``fused_encoded_mlp`` for a constant
mask: its forward is the plain encode -> mask -> MLP (as the TPU package's
``_xla_forward``) and keeps no (N, E) or (N, hidden) tensor for the backward,
only the points, the mask, the encoding constants and the weights. Its
backward is one K7 launch and one launch of the reduction kernel
(``ops/cuda/coupling.py`` ``reduce_weight_grads``).

Operand modes, as the TPU kernel's ``precise`` flag: ``bf16=False`` keeps
fp32 operands in every MLP product, ``bf16=True`` rounds both operands of
each product to bf16 and sums in fp32. The encoding's contraction over the
coordinates is fp32 in both.

The CUDA kernel needs: an encoding width and a hidden width that are
multiples of 4 (it reads float4), at least one hidden layer and at most 7,
at most 4 coordinates, and a tile of 32 rows x (E + hidden layers x H + O)
floats within the 227 KB of shared memory a block can have. (The TPU
kernel's multiple-of-128 rule answered the TPU's lanes.)

Routing is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes :func:`fused_inr_backward_plain`.
``fused_inr_backward.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.cuda.coupling import reduce_weight_grads
from sin_inn_tpu_torch.ops.encodings import ff_apply, rbf_apply

KINDS = ("rbf", "ff")
_TILE_ROWS = 32
_MAX_SMEM = 232448           # bytes of shared memory a block can have
_MAX_LAYERS = 8
_PLAIN_CHUNK = 16384         # rows per chunk of the plain version

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ b with fp32 accumulation; both operands rounded to bf16 first in
    the bf16 operand mode (products of bf16 values are exact in fp32)."""
    if bf16:
        a, b = _bf16_round(a), _bf16_round(b)
    return a @ b


def encode(kind: str, enc: Dict, x: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """a_0 = encoding(x) * mask, (n, E), with the arithmetic of
    ``ops/encodings.py`` (fp32 whatever the operand mode)."""
    apply_fn = rbf_apply if kind == "rbf" else ff_apply
    return apply_fn({}, enc, x) * mask


def fused_inr_forward_plain(kind: str, enc: Dict, layers: Layers,
                            x: torch.Tensor, mask: torch.Tensor,
                            bf16: bool = False) -> torch.Tensor:
    """encode -> mask -> MLP, (n, d) -> (n, O): relu between the layers,
    none after the last; biases added in fp32."""
    h = encode(kind, enc, x, mask)
    for i, (w, b) in enumerate(layers):
        h = _mm(h, w, bf16) + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def fused_inr_backward_plain(kind: str, enc: Dict, layers: Layers,
                             x: torch.Tensor, mask: torch.Tensor,
                             g: torch.Tensor, bf16: bool = False
                             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K7's backward: [(dW_l, db_l)] for the output
    cotangent g (n, O), by the hand-derived formulas (no autograd), in row
    chunks so that no (n, E) tensor is ever held."""
    grads = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in layers]
    for s in range(0, x.shape[0], _PLAIN_CHUNK):
        xs, gl = x[s:s + _PLAIN_CHUNK], g[s:s + _PLAIN_CHUNK].float()
        acts = [encode(kind, enc, xs, mask)]
        for w, b in layers[:-1]:
            acts.append(torch.relu(_mm(acts[-1], w, bf16) + b))
        for l in range(len(layers) - 1, -1, -1):
            dw, db = grads[l]
            dw += _mm(acts[l].t(), gl, bf16)
            db += gl.sum(0)
            if l > 0:
                gl = _mm(gl, layers[l][0].t(), bf16) * (acts[l] > 0)
    return grads


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("inr_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in ("sininn_inr_bwd_smem_bytes", "sininn_inr_bwd_slot_floats"):
        getattr(lib, fn).argtypes = [i32] * 4
        getattr(lib, fn).restype = i64
    lib.sininn_inr_bwd_blocks.argtypes = (
        [i32, i32, i64] + [i32] * 5 + [ctypes.POINTER(i32)])
    lib.sininn_inr_bwd_blocks.restype = i32
    lib.sininn_inr_bwd.argtypes = (
        [i32, i32, ptr, ptr, i64] + [i32] * 5 + [ptr] * 8 + [i32, ptr])
    lib.sininn_inr_bwd.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _dims(layers: Layers, x: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """(n_lin, d, E, H, O) of a net, checked for the shape the kernel's
    layout assumes: (E, H), (H, H)..., (H, O)."""
    n_lin = len(layers)
    if n_lin < 2:
        raise ValueError("the fused INR backward needs at least one hidden "
                         "layer")
    e, hidden = layers[0][0].shape
    out = layers[-1][0].shape[1]
    for l, (w, b) in enumerate(layers):
        want = (e if l == 0 else hidden, out if l == n_lin - 1 else hidden)
        if tuple(w.shape) != want or tuple(b.shape) != (want[1],):
            raise ValueError(f"layer {l}: weight {tuple(w.shape)}, bias "
                             f"{tuple(b.shape)}; the fused INR backward "
                             f"needs {want} and ({want[1]},)")
    return n_lin, x.shape[1], e, hidden, out


def kernel_supports(n_lin: int, d: int, e: int, hidden: int,
                    out: int) -> bool:
    """What ``csrc/inr_bwd.cu`` takes (see the module docstring)."""
    smem = 4 * _TILE_ROWS * (e + (n_lin - 1) * hidden + out)
    return (2 <= n_lin <= _MAX_LAYERS and 1 <= d <= 4 and e % 4 == 0
            and hidden % 4 == 0 and e >= 4 and hidden >= 4 and out >= 1
            and smem <= _MAX_SMEM)


def _grid(lib: ctypes.CDLL, bf16: bool, kind: str, n_points: int,
          dims: Tuple[int, int, int, int, int], device) -> Tuple[int, int]:
    """(blocks P, floats per slot) of one launch on ``device``."""
    n_lin, d, e, hidden, out = dims
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.sininn_inr_bwd_blocks(int(bf16), int(kind == "rbf"),
                                        n_points, n_lin, d, e, hidden, out,
                                        ctypes.byref(blocks))
    _raise_on(err, lib, "inr_bwd (grid)")
    return blocks.value, lib.sininn_inr_bwd_slot_floats(n_lin, e, hidden, out)


def scratch_bytes(n_points: int, layers: Layers, x: torch.Tensor,
                  kind: str = "rbf", bf16: bool = False) -> int:
    """Bytes of the per-block gradient slots one launch allocates on
    ``x``'s (CUDA) device."""
    blocks, slot = _grid(_lib(), bf16, kind, n_points, _dims(layers, x),
                         x.device)
    return 4 * blocks * slot


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.sininn_error_string(err).decode())


def _enc_operands(kind: str, enc: Dict):
    """The encoding constants as the kernel reads them, computed with the
    plain forward's own expressions."""
    if kind == "rbf":
        c = enc["centres"]
        return (c.contiguous(), (c * c).sum(-1).contiguous(),
                (enc["sigma"] ** 2).contiguous())
    return (enc["frequencies"].contiguous(), None, None)


def require_kernel(layers: Layers, x: torch.Tensor
                   ) -> Tuple[int, int, int, int, int]:
    """(n_lin, d, E, H, O) of a net that ``csrc/inr_bwd.cu`` takes; a
    ValueError that names the limits for any other. Nothing on the card gives
    way to plain autograd by itself: the caller asks for it with
    ``use_kernel="off"``."""
    n_lin, d, e, hidden, out = dims = _dims(layers, x)
    if not kernel_supports(*dims):
        smem = 4 * _TILE_ROWS * (e + (n_lin - 1) * hidden + out)
        raise ValueError(
            f"the fused INR backward kernel does not take d={d}, E={e}, "
            f"hidden={hidden}, {n_lin} layers, out={out}: it needs 1 <= d <= "
            f"4, 2 to {_MAX_LAYERS} layers, an encoding width and a hidden "
            f"width that are multiples of 4, and a {_TILE_ROWS}-row tile of "
            f"all activations within {_MAX_SMEM} bytes of shared memory "
            f"(this net needs {smem}). Train this net through ordinary "
            "autograd with use_kernel=\"off\" (--use-kernel off)")
    return dims


def _launch(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
            mask: torch.Tensor, g: torch.Tensor, bf16: bool):
    n_lin, d, e, hidden, out = require_kernel(layers, x)
    n = x.shape[0]
    dev = x.device
    ws = [w.detach().float().contiguous() for w, _ in layers]
    bs = [b.detach().float().contiguous() for _, b in layers]
    if bf16:
        ws = [_bf16_round(w) for w in ws]
    wts = [w.t().contiguous() if 0 < l < n_lin - 1 else None
           for l, w in enumerate(ws)]
    enc_ops = _enc_operands(kind, enc)
    tensors = [x, g, mask, *ws, *bs, *(t for t in wts if t is not None),
               *(t for t in enc_ops if t is not None)]
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"the fused INR backward takes float32 tensors "
                             f"on {dev}, got {t.dtype} on {t.device}")
    x, g, mask = x.contiguous(), g.contiguous(), mask.contiguous()

    def ptrs(ts):
        arr = (ctypes.c_void_p * _MAX_LAYERS)()
        for i, t in enumerate(ts):
            arr[i] = t.data_ptr() if t is not None else None
        return arr

    lib = _lib()
    blocks, slot = _grid(lib, bf16, kind, n, (n_lin, d, e, hidden, out), dev)
    partials = torch.empty((blocks, slot), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.sininn_inr_bwd(
            int(bf16), int(kind == "rbf"), x.data_ptr(), g.data_ptr(), n,
            n_lin, d, e, hidden, out, ptrs(ws), ptrs(bs), ptrs(wts),
            *[t.data_ptr() if t is not None else None for t in enc_ops],
            mask.data_ptr(), partials.data_ptr(), blocks, stream)
        _raise_on(err, lib, "inr_bwd")
        fused_inr_backward.launches += 1
    flat = reduce_weight_grads(partials)
    grads, at = [], 0
    for w, b in zip(ws, bs):
        dw = flat[at:at + w.numel()].view(w.shape)
        at += w.numel()
        grads.append((dw, flat[at:at + b.numel()]))
        at += b.numel()
    return grads


def _check(kind: str, x: torch.Tensor, mask: torch.Tensor,
           g: Optional[torch.Tensor], layers: Layers) -> None:
    if kind not in KINDS:
        raise ValueError(f"encoding kind must be one of {KINDS}, got {kind!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused INR kernel for device {x.device}")
    e = layers[0][0].shape[0]
    if x.dim() != 2 or mask.shape != (e,):
        raise ValueError(f"expected (n, d) points and an ({e},) mask, got "
                         f"{tuple(x.shape)} and {tuple(mask.shape)}")
    if g is not None and g.shape != (x.shape[0], layers[-1][0].shape[1]):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match "
                         f"({x.shape[0]}, {layers[-1][0].shape[1]})")


def fused_inr_backward(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
                       mask: torch.Tensor, g: torch.Tensor,
                       bf16: bool = False
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """K7 backward: [(dW_l, db_l)] of encode -> mask -> MLP at the points x
    (n, d) for the output cotangent g (n, O). kind: 'rbf' (enc: ``centres``
    (E, d), ``sigma`` (E,)) or 'ff' (enc: ``frequencies`` (d, E / 2));
    layers: [(W_l (K_l, N_l), b_l)]; mask: (E,)."""
    _check(kind, x, mask, g, layers)
    if x.device.type == "cpu":
        return fused_inr_backward_plain(kind, enc, layers, x, mask, g, bf16)
    if x.shape[0] == 0:
        return [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in layers]
    return _launch(kind, enc, layers, x, mask, g.float(), bf16)


class FusedINR(torch.autograd.Function):
    """Plain forward that keeps no activation, K7 backward.
    ``apply(kind, bf16, enc, x, mask, *leaves)`` with leaves = W_0, b_0, W_1,
    b_1, ...; gradients come back for the leaves only."""

    @staticmethod
    def forward(ctx, kind, bf16, enc, x, mask, *leaves):
        layers = list(zip(leaves[0::2], leaves[1::2]))
        _check(kind, x, mask, None, layers)
        if x.device.type == "cuda":
            require_kernel(layers, x)       # refuse before the step, not in it
        ctx.kind, ctx.bf16, ctx.enc = kind, bf16, enc
        ctx.save_for_backward(x, mask, *leaves)
        return fused_inr_forward_plain(kind, enc, layers, x, mask, bf16)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mask, *leaves = ctx.saved_tensors
        layers = list(zip(leaves[0::2], leaves[1::2]))
        grads = fused_inr_backward(ctx.kind, ctx.enc, layers, x, mask,
                                   g.contiguous(), ctx.bf16)
        flat = [t.to(leaf.dtype) for pair, (leaf, _) in zip(grads, layers)
                for t in pair]
        return (None, None, None, None, None, *flat)


def fused_inr(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              bf16: bool = False) -> torch.Tensor:
    """The differentiable fused INR: (n, d) points -> (n, O). ``enc`` holds
    the encoding's constant tensors (no gradient reaches them, ``x`` or
    ``mask``)."""
    if mask is None:
        mask = torch.ones(layers[0][0].shape[0], dtype=torch.float32,
                          device=x.device)
    leaves = [t for pair in layers for t in pair]
    return FusedINR.apply(kind, bf16, enc, x, mask.detach().float(), *leaves)


KERNELS = (fused_inr_backward,)
fused_inr_backward.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
