"""The fused encoded coordinate MLP (K7): CUDA kernels for its forward and
its backward, their plain versions and the autograd Function.

``fused_inr_forward`` replaces the TPU kernel ``_fwd_kernel`` of
``sin_inn_tpu/ops/pallas/inr.py`` (``_fused_fwd_call``) and
``fused_inr_backward`` its ``_bwd_kernel`` (``_fused_bwd_call``): per tile of
points, encode -> mask -> MLP, and for the backward a recompute of that chain
followed by the weight and bias gradients of every layer, and nothing else
(the coordinates, the mask and the parameter-free encodings take no
gradient). The kernels are ``csrc/inr_fwd.cu`` and ``csrc/inr_bwd.cu`` over
``csrc/inr_common.cuh``; their headers state what bounds them on an H100 and
how the design deals with that.

Nets. ``layers`` = [(W_l (K_l, N_l), b_l)]. A progressive net feeds the raw
coordinates in front of the encoding, so its W_0 is (d + E, H): the first d
rows are the coordinate rows (the TPU kernel's ``wc``), the rest the
encoding's. The wrappers tell the two by W_0's height against the
encoding's width E. Gradients come back in the leaves' shapes, the
coordinate rows' (``dwc``) inside dW_0.

Mask modes, told by the mask's form:

* ``const``: a (E,) vector, or (d + E,) for a progressive net (coordinate
  channels first), the same for every point;
* ``point``: the pair (mc (d, n), me (n, E)) of
  ``controllers.spatial_grid_mask_split``: the per-point mask streamed;
* ``slab``: ``controllers.SpatialSlabMask`` (enc (rows, res, E), coord (rows,
  res, d), wx (W, res)) with n = rows x W: the kernel rebuilds the mask of a
  tile from its image row's slab and the tile's rows of ``wx``, so the (n, E)
  mask never exists. A tile must not straddle two image rows: W is a
  multiple of the tile's 32 points.

``point`` and ``slab`` are for progressive nets only.

:class:`FusedINR` is the counterpart of ``fused_encoded_mlp``. For a
constant mask its forward is the plain encode -> mask -> MLP (as the TPU
package's ``_xla_forward``); for the per-point modes it is K7 forward. Either
way it keeps no (n, E) or (n, hidden) tensor for the backward, only the
points, the mask's operands, the encoding constants and the weights. Its
backward is one K7 backward launch and one launch of the reduction kernel
(``ops/cuda/coupling.py`` ``reduce_weight_grads``).

Operand modes, as the TPU kernel's ``precise`` flag: ``bf16=False`` keeps
fp32 operands in every product, ``bf16=True`` rounds both operands of each
MLP product, of the coordinate rows' product and of the slab rebuild to bf16
and sums in fp32. The encoding's contraction over the coordinates is fp32 in
both.

The CUDA kernels need: an encoding width and a hidden width that are
multiples of 4 (they read float4), at least one hidden layer and at most 7,
at most 4 coordinates, a hidden width of at most 256 and at most 8 outputs
(K7 forward holds a tile's whole hidden width in one block's warps and
takes the output layer as one 8-column tile), and, the routing's rule
(``kernel_supports``), 32 rows x (E + hidden layers x H + O) floats, plus
32 x 4 for a progressive net and 33 x res in slab mode, within the 227 KB of
shared memory a block can have (the tiles both kernels hold are smaller), as
is K7 forward's own block (``_fwd_smem_bytes``: 198 KB at the flow path's
widths). (The TPU kernel's multiple-of-128 rule answered the TPU's lanes.) The
backward's staged activations and gradient slots live in one scratch buffer
a launch (``scratch_bytes``: 385 MB at the flow path's shape); the forward
needs none.

Routing is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version. The profiler's counters
``launches.fused_inr_forward`` and ``launches.fused_inr_backward``
(``core/profiler.py``) count kernel launches; :func:`launch_counts` reads
them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from sin_inn_tpu_torch.core.profiler import (count, counters,
                                             reset_counters)
from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.cuda.coupling import reduce_weight_grads
from sin_inn_tpu_torch.ops.encodings import ff_apply, rbf_apply

KINDS = ("rbf", "ff")
MODES = ("const", "point", "slab")
TILE_ROWS = 32               # points per tile of both kernels
_MAX_SMEM = 232448           # bytes of shared memory a block can have
_MAX_LAYERS = 8
_MAX_HIDDEN = 256            # K7 forward: a tile's hidden width in one block
_MAX_OUT = 8                 # K7 forward: the output layer's one 8-col tile
_PLAIN_CHUNK = 16384         # rows per chunk of the plain versions

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]
Mask = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


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
    ``ops/encodings.py`` (fp32 whatever the operand mode). ``mask``: (E,) or
    (n, E)."""
    apply_fn = rbf_apply if kind == "rbf" else ff_apply
    return apply_fn({}, enc, x) * mask


def encoding_width(kind: str, enc: Dict) -> int:
    return (enc["centres"].shape[0] if kind == "rbf"
            else 2 * enc["frequencies"].shape[1])


class _Net(NamedTuple):
    """A call's operands as both the plain versions and the kernels read
    them."""
    mode: str                        # 'const' | 'point' | 'slab'
    prog: bool                       # coordinate rows in front of W_0
    d: int
    e: int                           # encoding width
    me: torch.Tensor                 # (E,) | (n, E) | (rows, res, E)
    mc: Optional[torch.Tensor]       # (d,) | (d, n) | (rows, res, d)
    wx: Optional[torch.Tensor]       # (W, res), slab mode


def _resolve(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
             mask: Optional[Mask]) -> _Net:
    """Check the operands' forms against each other and name the mode."""
    if kind not in KINDS:
        raise ValueError(f"encoding kind must be one of {KINDS}, got {kind!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused INR kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"expected (n, d) points, got {tuple(x.shape)}")
    n, d = x.shape
    e = encoding_width(kind, enc)
    rows0 = layers[0][0].shape[0]
    if rows0 not in (e, e + d):
        raise ValueError(f"the first layer has {rows0} rows; the encoding "
                         f"gives {e} channels (+ {d} coordinate rows for a "
                         "progressive net)")
    prog = rows0 == e + d
    if mask is None:
        mask = torch.ones(rows0, dtype=torch.float32, device=x.device)
    if isinstance(mask, torch.Tensor):
        if mask.shape != (rows0,):
            raise ValueError(f"expected a ({rows0},) mask, got "
                             f"{tuple(mask.shape)}")
        mask = mask.detach().float()
        return _Net("const", prog, d, e, mask[rows0 - e:],
                    mask[:d] if prog else None, None)
    if not prog:
        raise ValueError("a per-point mask (split pair or row slabs) is for "
                         "progressive nets")
    mask = tuple(t.detach().float() for t in mask)
    if len(mask) == 2:
        mc, me = mask
        if mc.shape != (d, n) or me.shape != (n, e):
            raise ValueError(f"expected a split mask (mc ({d}, {n}), me "
                             f"({n}, {e})), got {tuple(mc.shape)} and "
                             f"{tuple(me.shape)}")
        return _Net("point", True, d, e, me, mc, None)
    if len(mask) != 3:
        raise ValueError("a mask is a vector, a split pair (mc, me) or row "
                         "slabs (enc, coord, wx)")
    se, sc, wx = mask
    if (se.dim() != 3 or wx.dim() != 2 or se.shape[2] != e
            or sc.shape != (se.shape[0], se.shape[1], d)
            or wx.shape[1] != se.shape[1] or se.shape[0] * wx.shape[0] != n):
        raise ValueError(
            f"expected row slabs enc (rows, res, {e}), coord (rows, res, "
            f"{d}), wx (W, res) with rows x W = {n}, got "
            f"{tuple(se.shape)}, {tuple(sc.shape)}, {tuple(wx.shape)}")
    if wx.shape[0] % TILE_ROWS:
        raise ValueError(f"slab mode needs a frame width that is a multiple "
                         f"of the {TILE_ROWS}-point tile, got "
                         f"{wx.shape[0]}")
    return _Net("slab", True, d, e, se, sc, wx)


def _chunk_rows(net: _Net) -> int:
    """Rows per chunk of the plain versions: whole image rows in slab
    mode."""
    if net.mode != "slab":
        return _PLAIN_CHUNK
    w = net.wx.shape[0]
    return max(1, _PLAIN_CHUNK // w) * w


def _mask_values(net: _Net, s: int, t: int, bf16: bool):
    """(mev, mcv) of the rows [s, t): mev (E,) or (t - s, E), mcv (d,) or
    (t - s, d) or None. Slab mode contracts the rows' slabs with the x-axis
    weights, operands rounded to bf16 in the bf16 mode."""
    if net.mode == "const":
        return net.me, net.mc
    if net.mode == "point":
        return net.me[s:t], net.mc[:, s:t].t()
    w = net.wx.shape[0]
    rows = slice(s // w, -(-t // w))
    wx, se, sc = net.wx, net.me[rows], net.mc[rows]
    if bf16:
        wx, se, sc = _bf16_round(wx), _bf16_round(se), _bf16_round(sc)
    mev = torch.einsum("wr,SrE->SwE", wx, se).reshape(-1, net.e)
    mcv = torch.einsum("wr,SrD->SwD", wx, sc).reshape(-1, net.d)
    return mev, mcv


def _first_layer(net: _Net, layers: Layers):
    """(wc (d, H) or None, W_0's encoding rows (E, H))."""
    w0 = layers[0][0]
    return (w0[:net.d], w0[net.d:]) if net.prog else (None, w0)


def _recompute(kind, enc, net, layers, x, s, t, bf16, keep_last: bool):
    """The activations of rows [s, t): [a_0, ..., a_{L-1}] (and the output
    when ``keep_last``), and xm (the masked coordinates) or None."""
    xs = x[s:t]
    mev, mcv = _mask_values(net, s, t, bf16)
    acts = [encode(kind, enc, xs, mev)]
    xm = xs * mcv if net.prog else None
    wc, w0 = _first_layer(net, layers)
    n_lin = len(layers)
    for l, (w, b) in enumerate(layers):
        if l == n_lin - 1 and not keep_last:
            break
        z = _mm(acts[-1], w0 if l == 0 else w, bf16)
        if l == 0 and net.prog:
            z = z + _mm(xm, wc, bf16)
        z = z + b
        acts.append(torch.relu(z) if l < n_lin - 1 else z)
    return acts, xm


def fused_inr_forward_plain(kind: str, enc: Dict, layers: Layers,
                            x: torch.Tensor, mask: Optional[Mask] = None,
                            bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K7 forward: encode -> mask -> MLP, (n, d) ->
    (n, O): relu between the layers, none after the last; biases added in
    fp32. A constant mask runs in one piece; the per-point modes in row
    chunks, so that no (n, E) tensor is ever held."""
    net = _resolve(kind, enc, layers, x, mask)
    n = x.shape[0]
    step = n if net.mode == "const" else _chunk_rows(net)
    outs = [_recompute(kind, enc, net, layers, x, s, min(s + step, n), bf16,
                       True)[0][-1] for s in range(0, max(n, 1), max(step, 1))]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def fused_inr_backward_plain(kind: str, enc: Dict, layers: Layers,
                             x: torch.Tensor, mask: Optional[Mask],
                             g: torch.Tensor, bf16: bool = False
                             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K7 backward: [(dW_l, db_l)] for the output
    cotangent g (n, O), by the hand-derived formulas (no autograd), in row
    chunks so that no (n, E) tensor is ever held. For a progressive net the
    first d rows of dW_0 are the coordinate rows' gradient."""
    net = _resolve(kind, enc, layers, x, mask)
    grads = [(torch.zeros_like(w, dtype=torch.float32),
              torch.zeros_like(b, dtype=torch.float32)) for w, b in layers]
    n = x.shape[0]
    step = _chunk_rows(net)
    for s in range(0, n, step):
        t = min(s + step, n)
        gl = g[s:t].float()
        acts, xm = _recompute(kind, enc, net, layers, x, s, t, bf16, False)
        for l in range(len(layers) - 1, -1, -1):
            dw, db = grads[l]
            if l == 0 and net.prog:
                dw[:net.d] += _mm(xm.t(), gl, bf16)
                dw[net.d:] += _mm(acts[0].t(), gl, bf16)
            else:
                dw += _mm(acts[l].t(), gl, bf16)
            db += gl.sum(0)
            if l > 0:
                gl = _mm(gl, layers[l][0].t(), bf16) * (acts[l] > 0)
    return grads


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_I32, _I64, _PTR = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# (bf16, rbf, mode, prog, n_points, n_lin, d, e, hidden, out, res, w_img)
_SHAPE_ARGS = [_I32] * 4 + [_I64] + [_I32] * 7
# x, w[], b[], enc_a, enc_b, enc_c, me, mc, wx, wc
_OPERAND_ARGS = [_PTR] * 10


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("inr_bwd")
    # ..., scratch floats, slots, floats a slot
    lib.sininn_inr_bwd_plan.argtypes = (_SHAPE_ARGS
                                        + [ctypes.POINTER(_I64)] * 3)
    lib.sininn_inr_bwd_plan.restype = _I32
    # ..., g, scratch, partials, slots, stream
    lib.sininn_inr_bwd.argtypes = (_SHAPE_ARGS + _OPERAND_ARGS
                                   + [_PTR, _PTR, _PTR, _I64, _PTR])
    lib.sininn_inr_bwd.restype = _I32
    lib.sininn_error_string.argtypes = [_I32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.library("inr_fwd")
    lib.sininn_inr_fwd.argtypes = _SHAPE_ARGS + _OPERAND_ARGS + [_PTR, _PTR]
    lib.sininn_inr_fwd.restype = _I32
    lib.sininn_error_string.argtypes = [_I32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _dims(layers: Layers, x: torch.Tensor, prog: bool = False
          ) -> Tuple[int, int, int, int, int]:
    """(n_lin, d, E, H, O) of a net, checked for the shape the kernels'
    layout assumes: (E [+ d], H), (H, H)..., (H, O)."""
    n_lin = len(layers)
    if n_lin < 2:
        raise ValueError("the fused INR kernels need at least one hidden "
                         "layer")
    d = x.shape[1]
    rows0, hidden = layers[0][0].shape
    out = layers[-1][0].shape[1]
    for l, (w, b) in enumerate(layers):
        want = (rows0 if l == 0 else hidden, out if l == n_lin - 1 else hidden)
        if tuple(w.shape) != want or tuple(b.shape) != (want[1],):
            raise ValueError(f"layer {l}: weight {tuple(w.shape)}, bias "
                             f"{tuple(b.shape)}; the fused INR kernels "
                             f"need {want} and ({want[1]},)")
    return n_lin, d, rows0 - (d if prog else 0), hidden, out


def _smem_bytes(n_lin: int, e: int, hidden: int, out: int, prog: bool,
                res: int) -> int:
    """The routing's shared-memory rule (the tiles the kernels hold are
    smaller): every activation of a 32-row tile and the output cotangent;
    for a progressive net the masked coordinates (4 floats a row) and, in
    slab mode (``res`` > 0), the tile's rows of wx with a flag per
    column."""
    return (4 * TILE_ROWS * (e + (n_lin - 1) * hidden + out
                              + (4 if prog else 0))
            + 4 * (TILE_ROWS + 1) * res)


def _fwd_smem_bytes(hidden: int, res: int) -> int:
    """Shared memory of a K7 forward block (``csrc/inr_fwd.cu`` ``plan_of``):
    64 rows of activations (or, in slab mode, of the tile's wx), three
    32-row weight slices, two 32-column slices of u_0, the output layer's
    weights, the tile's coordinates and its slab header and flags."""
    hp = -(-hidden // 8) * 8
    wide = -(-hp // 32) * 32
    return 4 * (64 * max(wide + 4, res) + 3 * 32 * (wide + 8) + 2 * 64 * 36
                + 8 * hp + 3 * 64 * 4 + 2 * 64 + 3 + 2 * res)


def kernel_supports(n_lin: int, d: int, e: int, hidden: int, out: int,
                    prog: bool = False, res: int = 0) -> bool:
    """What ``csrc/inr_fwd.cu`` and ``csrc/inr_bwd.cu`` take (see the module
    docstring); ``prog``: a progressive net; ``res``: the slabs' cell
    resolution in slab mode."""
    return (2 <= n_lin <= _MAX_LAYERS and 1 <= d <= 4 and e % 4 == 0
            and hidden % 4 == 0 and e >= 4 and 4 <= hidden <= _MAX_HIDDEN
            and 1 <= out <= _MAX_OUT
            and _smem_bytes(n_lin, e, hidden, out, prog, res) <= _MAX_SMEM
            and _fwd_smem_bytes(hidden, res) <= _MAX_SMEM)


def require_kernel(layers: Layers, x: torch.Tensor, prog: bool = False,
                   res: int = 0) -> Tuple[int, int, int, int, int]:
    """(n_lin, d, E, H, O) of a net that the kernels take; a ValueError that
    names the limits for any other. Nothing on the card gives way to plain
    autograd by itself: the caller asks for it with ``use_kernel="off"``."""
    n_lin, d, e, hidden, out = dims = _dims(layers, x, prog)
    if not kernel_supports(*dims, prog=prog, res=res):
        raise ValueError(
            f"the fused INR kernels do not take d={d}, E={e}, "
            f"hidden={hidden}, {n_lin} layers, out={out}: they need 1 <= d <= "
            f"4, 2 to {_MAX_LAYERS} layers, an encoding width and a hidden "
            f"width that are multiples of 4, a hidden width of at most "
            f"{_MAX_HIDDEN}, at most {_MAX_OUT} outputs, and a {TILE_ROWS}-row "
            f"tile of all activations within {_MAX_SMEM} bytes of shared "
            f"memory (this net needs "
            f"{_smem_bytes(n_lin, e, hidden, out, prog, res)}). "
            "Run this net through the plain route and ordinary autograd "
            "with use_kernel=\"off\" (--use-kernel off)")
    return dims


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.sininn_error_string(err).decode())


def _enc_operands(kind: str, enc: Dict):
    """The encoding constants as the kernels read them, computed with the
    plain forward's own expressions."""
    if kind == "rbf":
        c = enc["centres"]
        return (c.contiguous(), (c * c).sum(-1).contiguous(),
                (enc["sigma"] ** 2).contiguous())
    return (enc["frequencies"].contiguous(), None, None)


def _ptr_array(ts):
    arr = (ctypes.c_void_p * _MAX_LAYERS)()
    for i, t in enumerate(ts):
        arr[i] = t.data_ptr() if t is not None else None
    return arr


class _Call(NamedTuple):
    """The arguments both C entry points share, and the tensors they point
    into (kept alive until the launch is queued)."""
    shape: tuple
    operands: tuple       # as _OPERAND_ARGS
    keep: tuple
    ws: list
    bs: list


def _prepare(kind: str, enc: Dict, net: _Net, layers: Layers,
             x: torch.Tensor, bf16: bool) -> _Call:
    res = net.wx.shape[1] if net.mode == "slab" else 0
    n_lin, d, e, hidden, out = require_kernel(layers, x, net.prog, res)
    dev = x.device
    ws = [w.detach().float().contiguous() for w, _ in layers]
    bs = [b.detach().float().contiguous() for _, b in layers]
    me, mc, wx = net.me, net.mc, net.wx
    if bf16:
        ws = [_bf16_round(w) for w in ws]
        if net.mode == "slab":
            me, mc, wx = _bf16_round(me), _bf16_round(mc), _bf16_round(wx)
    enc_ops = _enc_operands(kind, enc)
    x = x.contiguous()
    me = me.contiguous()
    mc = mc.contiguous() if mc is not None else None
    wx = wx.contiguous() if wx is not None else None
    keep = (x, me, mc, wx, *ws, *bs, *enc_ops)
    for t in keep:
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"the fused INR kernels take float32 tensors "
                             f"on {dev}, got {t.dtype} on {t.device}")
    # the kernels read the encoding rows of W_0 and its coordinate rows (the
    # first d of a progressive net's) apart
    w_ptrs = _ptr_array(ws)
    wc_ptr = None
    if net.prog:
        wc_ptr = ws[0].data_ptr()
        w_ptrs[0] = ws[0].data_ptr() + 4 * d * hidden
    ptr = lambda t: t.data_ptr() if t is not None else None
    shape = (int(bf16), int(kind == "rbf"), MODES.index(net.mode),
             int(net.prog), x.shape[0], n_lin, d, e, hidden, out, res,
             net.wx.shape[0] if net.mode == "slab" else 0)
    operands = (x.data_ptr(), w_ptrs, _ptr_array(bs),
                *[ptr(t) for t in enc_ops], ptr(me), ptr(mc), ptr(wx),
                wc_ptr)
    return _Call(shape, operands, keep, ws, bs)


def _plan(lib: ctypes.CDLL, call: _Call, device) -> Tuple[int, int, int]:
    """(floats of scratch, gradient slots, floats a slot) of one backward
    launch on ``device``."""
    out = [ctypes.c_longlong(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.sininn_inr_bwd_plan(*call.shape,
                                      *[ctypes.byref(v) for v in out])
    _raise_on(err, lib, "inr_bwd (plan)")
    return tuple(v.value for v in out)


def scratch_bytes(layers: Layers, x: torch.Tensor, kind: str, enc: Dict,
                  mask: Optional[Mask] = None, bf16: bool = False) -> int:
    """Bytes one backward launch allocates on ``x``'s (CUDA) device: the
    staged activations and cotangents of one row chunk with the packed
    weights, and the gradient slots."""
    net = _resolve(kind, enc, layers, x, mask)
    call = _prepare(kind, enc, net, layers, x, bf16)
    scratch, slots, slot = _plan(_bwd_lib(), call, x.device)
    return 4 * (scratch + slots * slot)


def _launch_backward(kind: str, enc: Dict, net: _Net, layers: Layers,
                     x: torch.Tensor, g: torch.Tensor, bf16: bool):
    call = _prepare(kind, enc, net, layers, x, bf16)
    dev = x.device
    g = g.contiguous()
    if g.device != dev or g.dtype != torch.float32:
        raise ValueError(f"the fused INR backward takes a float32 cotangent "
                         f"on {dev}, got {g.dtype} on {g.device}")
    lib = _bwd_lib()
    floats, slots, slot = _plan(lib, call, dev)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    partials = torch.empty((slots, slot), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.sininn_inr_bwd(*call.shape, *call.operands, g.data_ptr(),
                                 scratch.data_ptr(), partials.data_ptr(),
                                 slots, stream)
        _raise_on(err, lib, "inr_bwd")
        count("launches.fused_inr_backward")
    flat = reduce_weight_grads(partials)
    grads, at = [], 0
    for w, b in zip(call.ws, call.bs):
        dw = flat[at:at + w.numel()].view(w.shape)
        at += w.numel()
        grads.append((dw, flat[at:at + b.numel()]))
        at += b.numel()
    return grads


def _launch_forward(kind: str, enc: Dict, net: _Net, layers: Layers,
                    x: torch.Tensor, bf16: bool) -> torch.Tensor:
    call = _prepare(kind, enc, net, layers, x, bf16)
    dev = x.device
    out = torch.empty((x.shape[0], layers[-1][0].shape[1]),
                      dtype=torch.float32, device=dev)
    lib = _fwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.sininn_inr_fwd(*call.shape, *call.operands,
                                 out.data_ptr(), stream)
        _raise_on(err, lib, "inr_fwd")
        count("launches.fused_inr_forward")
    return out


def fused_inr_forward(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
                      mask: Optional[Mask] = None,
                      bf16: bool = False) -> torch.Tensor:
    """K7 forward: encode -> mask -> MLP at the points x (n, d) -> (n, O).
    kind: 'rbf' (enc: ``centres`` (E, d), ``sigma`` (E,)) or 'ff' (enc:
    ``frequencies`` (d, E / 2)); layers: [(W_l (K_l, N_l), b_l)], W_0 with
    the coordinate rows in front for a progressive net; mask: None, a
    vector, a split pair or row slabs (see the module docstring)."""
    net = _resolve(kind, enc, layers, x, mask)
    if x.device.type == "cpu":
        return fused_inr_forward_plain(kind, enc, layers, x, mask, bf16)
    if x.shape[0] == 0:
        return x.new_zeros((0, layers[-1][0].shape[1]), dtype=torch.float32)
    return _launch_forward(kind, enc, net, layers, x.float(), bf16)


def fused_inr_backward(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
                       mask: Optional[Mask], g: torch.Tensor,
                       bf16: bool = False
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """K7 backward: [(dW_l, db_l)] of encode -> mask -> MLP at the points x
    (n, d) for the output cotangent g (n, O). Operands as
    :func:`fused_inr_forward`; for a progressive net the first d rows of
    dW_0 are the coordinate rows' gradient."""
    net = _resolve(kind, enc, layers, x, mask)
    if g.shape != (x.shape[0], layers[-1][0].shape[1]):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match "
                         f"({x.shape[0]}, {layers[-1][0].shape[1]})")
    if x.device.type == "cpu":
        return fused_inr_backward_plain(kind, enc, layers, x, mask, g, bf16)
    if x.shape[0] == 0:
        return [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in layers]
    return _launch_backward(kind, enc, net, layers, x.float(), g.float(),
                            bf16)


class FusedINR(torch.autograd.Function):
    """A forward that keeps no activation (plain for a constant mask, K7
    forward for the per-point modes), K7 backward.
    ``apply(kind, bf16, enc, x, n_mask, *mask_tensors, *leaves)`` with
    ``n_mask`` the number of mask tensors (1: a vector, 2: a split pair, 3:
    row slabs) and leaves = W_0, b_0, W_1, b_1, ...; gradients come back for
    the leaves only."""

    @staticmethod
    def forward(ctx, kind, bf16, enc, x, n_mask, *rest):
        mask_ts, leaves = rest[:n_mask], rest[n_mask:]
        mask = mask_ts[0] if n_mask == 1 else tuple(mask_ts)
        layers = list(zip(leaves[0::2], leaves[1::2]))
        net = _resolve(kind, enc, layers, x, mask)
        ctx.kind, ctx.bf16, ctx.enc, ctx.n_mask = kind, bf16, enc, n_mask
        ctx.save_for_backward(x, *mask_ts, *leaves)
        if net.mode != "const":
            return fused_inr_forward(kind, enc, layers, x, mask, bf16)
        if x.device.type == "cuda":
            # refuse before the step, not in it
            require_kernel(layers, x, net.prog)
        return fused_inr_forward_plain(kind, enc, layers, x, mask, bf16)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        mask_ts, leaves = rest[:ctx.n_mask], rest[ctx.n_mask:]
        mask = mask_ts[0] if ctx.n_mask == 1 else tuple(mask_ts)
        layers = list(zip(leaves[0::2], leaves[1::2]))
        grads = fused_inr_backward(ctx.kind, ctx.enc, layers, x, mask,
                                   g.contiguous(), ctx.bf16)
        flat = [t.to(leaf.dtype) for pair, (leaf, _) in zip(grads, layers)
                for t in pair]
        return (None,) * (5 + ctx.n_mask) + tuple(flat)


def fused_inr(kind: str, enc: Dict, layers: Layers, x: torch.Tensor,
              mask: Optional[Mask] = None,
              bf16: bool = False) -> torch.Tensor:
    """The differentiable fused INR: (n, d) points -> (n, O). ``enc`` holds
    the encoding's constant tensors (no gradient reaches them, ``x`` or
    ``mask``)."""
    if mask is None:
        mask = torch.ones(layers[0][0].shape[0], dtype=torch.float32,
                          device=x.device)
    mask_ts = (mask,) if isinstance(mask, torch.Tensor) else tuple(mask)
    mask_ts = tuple(t.detach() for t in mask_ts)
    leaves = [t for pair in layers for t in pair]
    return FusedINR.apply(kind, bf16, enc, x, len(mask_ts), *mask_ts, *leaves)


KERNELS = (fused_inr_forward, fused_inr_backward)


def launch_counts() -> Dict[str, int]:
    c = counters()
    return {k.__name__: c.get(f"launches.{k.__name__}", 0) for k in KERNELS}


def reset_launch_counts() -> None:
    reset_counters(tuple(f"launches.{k.__name__}" for k in KERNELS))
