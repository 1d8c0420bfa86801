"""Fused GLOW coupling with 1x1-conv subnets: CUDA kernels and plain versions.

Four kernels replace the TPU kernels of ``sin_inn_tpu/ops/pallas/coupling.py``
(entry points of the same names):

* ``fused_glow_forward_1x1`` (K1, ``_coupling_fwd_kernel``) and
  ``fused_glow_inverse_1x1`` (K2, ``_coupling_inv_kernel``), in
  ``csrc/coupling_1x1.cu``: one launch runs the packing kernel (the OIHW
  weights into zero-padded operands, each element split into its TF32 high
  and low part) and one coupling kernel in which a block of 16 W rows (W
  warps, 8 where they fit: :func:`coupling_plan`) runs both subnets of the
  chain: each a two-layer product streamed over the hidden width in chunks
  of 32 by ``cp.async``, with the hidden layer kept in registers, and the
  affine step in shared memory. x is read once and y written once;
* ``fused_glow_backward_1x1`` (K3, ``_coupling_bwd_kernel``) and
  ``fused_glow_inverse_backward_1x1`` (K4, ``_coupling_inv_bwd_kernel``),
  the VJPs of K1 and K2, in ``csrc/coupling_1x1_bwd.cu``: one launch runs a
  packing kernel, four row phases (a two-layer product each, streamed over
  the hidden width on 128-row tiles; h and gz go to a scratch buffer, the
  relu gates as bits) and a weight stage that writes the eight weight and
  bias gradients of each chunk of rows into its own slot; a second kernel
  of that file (``reduce_weight_grads``) sums the slots in a fixed order,
  so the result is bitwise repeatable without atomics.

Every product of K1-K4 runs on the tensor cores in 3xTF32
(``csrc/tf32_mma.cuh``: each fp32 operand split into a TF32 high and low
part, three TF32 ``mma.sync`` products a product); that header also holds
the packing kernel of both files (``pack_kernel``). The sources' headers
state what bounds each kernel on an H100 (the tensor cores, and for K3/K4
the staged bytes), the tile, stage and slot sizes, and how the designs deal
with weights that do not fit in a block's shared memory and with the
cross-block gradient sum. K3/K4's recompute of the forward does not repeat
K1/K2's order of sums, so a relu gate whose pre-activation lies within
rounding of 0 may be set otherwise than in the forward or in the plain
version; :func:`relu_gate_slack` bounds what such a gate carries, for the
checks against the plain versions, and :func:`backward_relu_gates` reads
which gates a launch set.

Routing is by the tensor's device alone: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version (``torch.matmul`` and the
elementwise chain, in this module). Nothing falls back from one to the
other. :class:`FusedCoupling1x1` and :class:`FusedCouplingInverse1x1` are
the differentiable ops (counterparts of ``make_fused_coupling_full`` and
``make_fused_coupling_full_inv``): K1 or K2 forward, K3 or K4 backward, with
only the input and the weights saved.

Each wrapper counts its launches in the profiler's counters
(``launches.fused_glow_forward_1x1`` and so on, ``core/profiler.py``);
:func:`launch_counts` reads them all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from sin_inn_tpu_torch.core.profiler import (count, counters,
                                             reset_counters)
from sin_inn_tpu_torch.ops.coupling import glow_log_e
from sin_inn_tpu_torch.ops.cuda import _build

# dynamic shared memory a block may use on Hopper
_MAX_SMEM = 232_448

# the leaves of one coupling's params, in the kernels' operand order
LEAVES = (("s2", "conv1", "w"), ("s2", "conv1", "b"),
          ("s2", "conv2", "w"), ("s2", "conv2", "b"),
          ("s1", "conv1", "w"), ("s1", "conv1", "b"),
          ("s1", "conv2", "w"), ("s1", "conv2", "b"))


def param_leaves(params: Dict) -> List[torch.Tensor]:
    """One coupling's eight OIHW tensors in the order of :data:`LEAVES`."""
    return [params[s][c][k] for s, c, k in LEAVES]


def params_from_leaves(leaves: Sequence[torch.Tensor]) -> Dict:
    out: Dict = {}
    for (s, c, k), t in zip(LEAVES, leaves):
        out.setdefault(s, {}).setdefault(c, {})[k] = t
    return out


def _mats(params: Dict, c: int, len1: int) -> Tuple[List[torch.Tensor], int]:
    """1x1 conv params (OIHW) -> the kernel's operands and the hidden width:
    [w2a (len2, H), b2a, w2b (H, 2 len1), b2b, w1a (len1, H), b1a,
    w1b (H, 2 len2), b1b], with each weight as a (cin, cout) view."""
    if not 0 < len1 < c:
        raise ValueError(f"len1={len1} must lie in (0, {c})")
    len2 = c - len1
    hidden = params["s2"]["conv1"]["w"].shape[0]
    want = {"s2": (len2, 2 * len1), "s1": (len1, 2 * len2)}
    mats = []
    for sub in ("s2", "s1"):
        cin, cout = want[sub]
        for conv, shape in (("conv1", (hidden, cin, 1, 1)),
                            ("conv2", (cout, hidden, 1, 1))):
            w, b = params[sub][conv]["w"], params[sub][conv]["b"]
            if tuple(w.shape) != shape or tuple(b.shape) != (shape[0],):
                raise ValueError(
                    f"{sub}.{conv}: weight {tuple(w.shape)} / bias "
                    f"{tuple(b.shape)}, expected {shape} / ({shape[0]},) for "
                    f"C={c}, len1={len1}, hidden={hidden}")
            mats += [w[:, :, 0, 0].t(), b]
    return mats, hidden


def _grads_to_params(dw2a, db2a, dw2b, db2b, dw1a, db1a, dw1b, db1b) -> Dict:
    """(cin, cout) weight gradients and bias gradients -> OIHW params."""
    conv = lambda dw, db: {"w": dw.t().contiguous()[:, :, None, None],
                           "b": db}
    return {"s2": {"conv1": conv(dw2a, db2a), "conv2": conv(dw2b, db2b)},
            "s1": {"conv1": conv(dw1a, db1a), "conv2": conv(dw1b, db1b)}}


def _log_e_prime(s: torch.Tensor, clamp: float) -> torch.Tensor:
    """d/ds of ``glow_log_e``: (2/pi) / (1 + (s/clamp)^2)."""
    return (2.0 / torch.pi) / (1.0 + (s / clamp) ** 2)


def _plain(params: Dict, x: torch.Tensor, clamp: float, len1: int,
           inverse: bool, mm=torch.matmul) -> torch.Tensor:
    """The fused chain on (N, H, W, C) x; ``mm`` takes every product (a
    model of another arithmetic in tests)."""
    n, h, w, c = x.shape
    (w2a, b2a, w2b, b2b, w1a, b1a, w1b, b1b), _ = _mats(params, c, len1)
    len2 = c - len1
    v = x.reshape(-1, c).float()

    def r2(a):   # subnet s2 on x2 -> [s2 | t2], 2*len1 wide
        return mm(torch.relu(mm(a, w2a) + b2a), w2b) + b2b

    def r1(a):   # subnet s1 on y1 -> [s1 | t1], 2*len2 wide
        return mm(torch.relu(mm(a, w1a) + b1a), w1b) + b1b

    if not inverse:
        x1, x2 = v[:, :len1], v[:, len1:]
        r = r2(x2)
        y1 = torch.exp(glow_log_e(r[:, :len1], clamp)) * x1 + r[:, len1:]
        r = r1(y1)
        y2 = torch.exp(glow_log_e(r[:, :len2], clamp)) * x2 + r[:, len2:]
        out = torch.cat([y1, y2], dim=1)
    else:
        y1, y2 = v[:, :len1], v[:, len1:]
        r = r1(y1)
        x2 = (y2 - r[:, len2:]) * torch.exp(-glow_log_e(r[:, :len2], clamp))
        r = r2(x2)
        x1 = (y1 - r[:, len1:]) * torch.exp(-glow_log_e(r[:, :len1], clamp))
        out = torch.cat([x1, x2], dim=1)
    return out.to(x.dtype).reshape(n, h, w, c)


def fused_glow_forward_1x1_plain(params: Dict, x: torch.Tensor, clamp: float,
                                 len1: int) -> torch.Tensor:
    """Plain PyTorch version of the fused forward. x: (N, H, W, C)."""
    return _plain(params, x, clamp, len1, inverse=False)


def fused_glow_inverse_1x1_plain(params: Dict, y: torch.Tensor, clamp: float,
                                 len1: int) -> torch.Tensor:
    """Plain PyTorch version of the fused inverse. y: (N, H, W, C)."""
    return _plain(params, y, clamp, len1, inverse=True)


def _plain_rows(params: Dict, v: torch.Tensor, gg: torch.Tensor,
                clamp: float, len1: int, inverse: bool, flip1=None,
                flip2=None, mm=torch.matmul):
    """The hand-derived reverse chains of coupling.py:269-331 (forward) and
    :421-486 (inverse) in torch, on (M, C) fp32 rows v with cotangents gg.
    Returns each row's operands of the weight gradients (a2, gz2, h2, gr2,
    a1, gz1, h1, gr1), dx and the relu pre-activations (z1, z2). ``flip1``
    / ``flip2`` (bool, (M, H)) invert the relu gates of s1 / s2 where set;
    ``mm`` takes every product (a model of another arithmetic in tests)."""
    c = v.shape[-1]
    (w2a, b2a, w2b, b2b, w1a, b1a, w1b, b1b), _ = _mats(params, c, len1)
    len2 = c - len1
    le = lambda s: glow_log_e(s, clamp)
    lep = lambda s: _log_e_prime(s, clamp)
    gate = lambda h, flip: (h > 0) if flip is None else (h > 0) ^ flip

    if not inverse:
        x1, x2 = v[:, :len1], v[:, len1:]
        gy1, gy2 = gg[:, :len1], gg[:, len1:]
        # recompute the forward
        z2 = mm(x2, w2a) + b2a
        h2 = torch.relu(z2)
        r2 = mm(h2, w2b) + b2b
        s2, t2 = r2[:, :len1], r2[:, len1:]
        e2 = torch.exp(le(s2))
        y1 = e2 * x1 + t2
        z1 = mm(y1, w1a) + b1a
        h1 = torch.relu(z1)
        s1 = (mm(h1, w1b) + b1b)[:, :len2]
        e1 = torch.exp(le(s1))
        # y2 = e1 x2 + t1
        gx2 = gy2 * e1
        gr1 = torch.cat([gy2 * x2 * e1 * lep(s1), gy2], dim=1)
        gz1 = torch.where(gate(h1, flip1), mm(gr1, w1b.t()), 0.0)
        gy1 = gy1 + mm(gz1, w1a.t())
        # y1 = e2 x1 + t2
        gx1 = gy1 * e2
        gr2 = torch.cat([gy1 * x1 * e2 * lep(s2), gy1], dim=1)
        gz2 = torch.where(gate(h2, flip2), mm(gr2, w2b.t()), 0.0)
        gx2 = gx2 + mm(gz2, w2a.t())
        dx = torch.cat([gx1, gx2], dim=1)
        a2, a1 = x2, y1
    else:
        y1, y2 = v[:, :len1], v[:, len1:]
        gx1, gx2 = gg[:, :len1], gg[:, len1:]
        # recompute the inverse
        z1 = mm(y1, w1a) + b1a
        h1 = torch.relu(z1)
        r1 = mm(h1, w1b) + b1b
        s1, t1 = r1[:, :len2], r1[:, len2:]
        e1inv = torch.exp(-le(s1))
        x2 = (y2 - t1) * e1inv
        z2 = mm(x2, w2a) + b2a
        h2 = torch.relu(z2)
        r2 = mm(h2, w2b) + b2b
        s2, t2 = r2[:, :len1], r2[:, len1:]
        e2inv = torch.exp(-le(s2))
        x1 = (y1 - t2) * e2inv
        # x1 = (y1 - t2) e2inv
        gy1 = gx1 * e2inv
        gr2 = torch.cat([-gx1 * x1 * lep(s2), -gx1 * e2inv], dim=1)
        gz2 = torch.where(gate(h2, flip2), mm(gr2, w2b.t()), 0.0)
        gx2 = gx2 + mm(gz2, w2a.t())
        # x2 = (y2 - t1) e1inv
        gy2 = gx2 * e1inv
        gr1 = torch.cat([-gx2 * x2 * lep(s1), -gx2 * e1inv], dim=1)
        gz1 = torch.where(gate(h1, flip1), mm(gr1, w1b.t()), 0.0)
        gy1 = gy1 + mm(gz1, w1a.t())
        dx = torch.cat([gy1, gy2], dim=1)
        a2, a1 = x2, y1
    return (a2, gz2, h2, gr2, a1, gz1, h1, gr1), dx, (z1, z2)


def _plain_backward(params: Dict, x: torch.Tensor, g: torch.Tensor,
                    clamp: float, len1: int, inverse: bool):
    """The plain VJP of the fused forward (or inverse) at x for g. Returns
    (dparams, dx)."""
    c = x.shape[-1]
    (a2, gz2, h2, gr2, a1, gz1, h1, gr1), dx, _ = _plain_rows(
        params, x.reshape(-1, c).float(), g.reshape(-1, c).float(), clamp,
        len1, inverse)
    dparams = _grads_to_params(
        a2.t() @ gz2, gz2.sum(0), h2.t() @ gr2, gr2.sum(0),
        a1.t() @ gz1, gz1.sum(0), h1.t() @ gr1, gr1.sum(0))
    return dparams, dx.to(x.dtype).reshape(x.shape)


def relu_gate_slack(params: Dict, x: torch.Tensor, g: torch.Tensor,
                    clamp: float, len1: int, inverse: bool = False,
                    gates=None, tau: float = 1e-5):
    """How far another fp32 backward of K3 (K4 with ``inverse``) may stand
    from the plain one through the relu gates alone. A pre-activation within
    ``tau`` of 0 may be gated either way once the sums run in another order
    (or in 3xTF32), and the gate carries every term downstream of it in its
    row: that row's dx and its share of each weight and bias gradient.
    ``gates``, the other route's relu gates (s1's, s2's: (M, H) bool, z > 0;
    :func:`backward_relu_gates` reads K3's or K4's), keeps to the gates
    within ``tau`` of 0 that it sets otherwise than the plain chain; without
    it every gate within ``tau`` of 0 counts. For each such gate the plain
    chain of its row is run again with that gate alone inverted; the bounds
    are the sums over those gates of the absolute changes. Returns (dparams
    shaped like params, dx shaped like x), 0 where no gate counts."""
    c = x.shape[-1]
    v = x.reshape(-1, c).float()
    gg = g.reshape(-1, c).float()
    _, _, z = _plain_rows(params, v, gg, clamp, len1, inverse)
    close = [zi.abs() < tau for zi in z]
    if gates is not None:
        close = [n & (gi != (zi > 0)) for n, gi, zi in zip(close, gates, z)]
    near = [n.nonzero() for n in close]
    rows = torch.cat([n[:, 0] for n in near])
    flips = []
    for i, n in enumerate(near):
        f = torch.zeros((rows.numel(), z[0].shape[1]), dtype=torch.bool,
                        device=x.device)
        at = torch.arange(n.shape[0], device=x.device) + (
            near[0].shape[0] if i else 0)
        f[at, n[:, 1]] = True
        flips.append(f)
    base, dx0, _ = _plain_rows(params, v[rows], gg[rows], clamp, len1,
                               inverse)
    moved, dx1, _ = _plain_rows(params, v[rows], gg[rows], clamp, len1,
                                inverse, flip1=flips[0], flip2=flips[1])
    # each row's share of dW = a' d is the outer product of a and d, so the
    # sum of the absolute changes is |a|' |d - d0| (a and h do not move)
    (a2, gz2, h2, gr2, a1, gz1, h1, gr1) = base
    d = [(m - b).abs() for m, b in zip(moved, base)]
    dparams = _grads_to_params(
        a2.abs().t() @ d[1], d[1].sum(0), h2.abs().t() @ d[3], d[3].sum(0),
        a1.abs().t() @ d[5], d[5].sum(0), h1.abs().t() @ d[7], d[7].sum(0))
    sdx = torch.zeros_like(v).index_add_(0, rows, (dx1 - dx0).abs())
    return dparams, sdx.reshape(x.shape)


def fused_glow_backward_1x1_plain(params: Dict, x: torch.Tensor,
                                  g: torch.Tensor, clamp: float, len1: int):
    """Plain version of K3: the VJP of the fused forward at x for the
    cotangent g. Returns (dparams, dx), dparams shaped like params."""
    return _plain_backward(params, x, g, clamp, len1, inverse=False)


def fused_glow_inverse_backward_1x1_plain(params: Dict, y: torch.Tensor,
                                          g: torch.Tensor, clamp: float,
                                          len1: int):
    """Plain version of K4: the VJP of the fused inverse at y for the
    cotangent g. Returns (dparams, dy)."""
    return _plain_backward(params, y, g, clamp, len1, inverse=True)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("coupling_1x1")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sininn_coupling_1x1.argtypes = (
        [i32, i32, ptr, ptr, i64, i32, i32, i32] + [ptr] * 8
        + [ctypes.c_float, ptr, ptr])
    lib.sininn_coupling_1x1.restype = i32
    for fn in ("sininn_coupling_1x1_smem_bytes",
               "sininn_coupling_1x1_scratch_floats"):
        getattr(lib, fn).argtypes = [i32, i32, i32]
        getattr(lib, fn).restype = i64
    lib.sininn_coupling_1x1_plan.argtypes = [i32, i32, i32, ptr]
    lib.sininn_coupling_1x1_plan.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("coupling_1x1_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in ("sininn_coupling_1x1_bwd_smem_bytes",
               "sininn_coupling_1x1_bwd_slot_floats"):
        getattr(lib, fn).argtypes = [i32, i32, i32]
        getattr(lib, fn).restype = i64
    lib.sininn_coupling_1x1_bwd_scratch_floats.argtypes = [i32, i64, i32,
                                                           i32, i32]
    lib.sininn_coupling_1x1_bwd_scratch_floats.restype = i64
    lib.sininn_coupling_1x1_bwd_chunks.argtypes = [i64, i32, i32, i32]
    lib.sininn_coupling_1x1_bwd_chunks.restype = i64
    lib.sininn_coupling_1x1_bwd_hidden_offset.argtypes = [i32, i64, i32, i32,
                                                          i32, i32]
    lib.sininn_coupling_1x1_bwd_hidden_offset.restype = i64
    lib.sininn_coupling_1x1_bwd.argtypes = (
        [i32, i32, ptr, ptr, ptr, i64, i32, i32, i32] + [ptr] * 8
        + [ctypes.c_float, ptr, ptr, i64, ptr])
    lib.sininn_coupling_1x1_bwd.restype = i32
    lib.sininn_reduce_partials.argtypes = [ptr, i32, i64, ptr, ptr]
    lib.sininn_reduce_partials.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC {what}, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coupling kernel takes float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"coupling kernel needs a contiguous NHWC {what}")


def _check_weights(tensors: Sequence[torch.Tensor], device) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"coupling weights must be float32 on "
                             f"{device}, got {t.dtype} on {t.device}")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.sininn_error_string(err).decode())


def _launch(params: Dict, x: torch.Tensor, clamp: float, len1: int,
            inverse: bool) -> torch.Tensor:
    """One K1 or K2 launch (its packing kernel and the coupling kernel) on
    the current stream. Returns the output; the caller counts the launch."""
    _check_input(x, "input")
    c = x.shape[-1]
    mats, hidden = _mats(params, c, len1)   # checks the shapes
    _check_weights(mats, x.device)
    # the OIHW weights and the biases as stored, in LEAVES order
    leaves = [t.detach().contiguous() for t in param_leaves(params)]
    lib = _lib()
    smem = lib.sininn_coupling_1x1_smem_bytes(c, len1, hidden)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"C={c}, len1={len1}, hidden={hidden}: no tile of "
                         f"the coupling fits in {_MAX_SMEM} bytes of shared "
                         f"memory")
    scratch = torch.empty(
        lib.sininn_coupling_1x1_scratch_floats(c, len1, hidden),
        dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    m = x.numel() // c
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.sininn_coupling_1x1(
            int(inverse), int(x.dtype == torch.bfloat16), x.data_ptr(),
            out.data_ptr(), m, c, len1, hidden,
            *[t.data_ptr() for t in leaves], float(clamp),
            scratch.data_ptr(), stream)
    _raise_on(err, lib, "coupling_1x1")
    return out


def coupling_plan(c: int, len1: int, hidden: int) -> Tuple[int, int, int]:
    """The plan of a K1/K2 launch: the warps a block (16 rows each; the most
    that fit in shared memory) and the passes over the columns of the s2
    and of the s1 subnet's second product (1 where every Wb chunk fits).
    Raises a ValueError if no block fits."""
    out = (ctypes.c_int * 3)()
    if _lib().sininn_coupling_1x1_plan(c, len1, hidden, out) != 0:
        raise ValueError(f"C={c}, len1={len1}, hidden={hidden}: no tile of "
                         f"the coupling fits in {_MAX_SMEM} bytes of shared "
                         f"memory")
    return tuple(out)


def _launch_backward(params: Dict, x: torch.Tensor, g: torch.Tensor,
                     clamp: float, len1: int, inverse: bool):
    """One K3 or K4 launch (its staged kernels, counted here as one) and one
    reduction launch on the current stream. Returns (dparams, dx) and the
    launch's scratch buffer."""
    _check_input(x, "input")
    _check_input(g, "cotangent")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match the input "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    c = x.shape[-1]
    mats, hidden = _mats(params, c, len1)   # checks the shapes
    _check_weights(mats, x.device)
    # the OIHW weights and the biases as stored, in LEAVES order
    leaves = [t.detach().contiguous() for t in param_leaves(params)]
    lib = _bwd_lib()
    smem = lib.sininn_coupling_1x1_bwd_smem_bytes(c, len1, hidden)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"C={c}, len1={len1}, hidden={hidden}: no tile of "
                         f"the backward fits in {_MAX_SMEM} bytes of shared "
                         f"memory")
    m = x.numel() // c
    scratch = torch.empty(
        lib.sininn_coupling_1x1_bwd_scratch_floats(int(inverse), m, c, len1,
                                                   hidden),
        dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        chunks = lib.sininn_coupling_1x1_bwd_chunks(m, c, len1, hidden)
        if chunks <= 0:
            raise RuntimeError("coupling_1x1_bwd: the weight stage's grid "
                               "query failed")
        partials = torch.empty(
            (chunks, lib.sininn_coupling_1x1_bwd_slot_floats(c, len1,
                                                             hidden)),
            dtype=torch.float32, device=x.device)
        err = lib.sininn_coupling_1x1_bwd(
            int(inverse), int(x.dtype == torch.bfloat16), x.data_ptr(),
            g.data_ptr(), dx.data_ptr(), m, c, len1, hidden,
            *[t.data_ptr() for t in leaves], float(clamp),
            scratch.data_ptr(), partials.data_ptr(), chunks, stream)
        _raise_on(err, lib, "coupling_1x1_bwd")
        count("launches.fused_glow_inverse_backward_1x1" if inverse
              else "launches.fused_glow_backward_1x1")
    grads = reduce_weight_grads(partials)
    len2 = c - len1
    sizes = [len2 * hidden, hidden, hidden * 2 * len1, 2 * len1,
             len1 * hidden, hidden, hidden * 2 * len2, 2 * len2]
    parts = list(torch.split(grads, sizes))
    for i, shape in ((0, (len2, hidden)), (2, (hidden, 2 * len1)),
                     (4, (len1, hidden)), (6, (hidden, 2 * len2))):
        parts[i] = parts[i].view(shape)
    return _grads_to_params(*parts), dx, scratch


def backward_relu_gates(params: Dict, x: torch.Tensor, g: torch.Tensor,
                        clamp: float, len1: int, inverse: bool = False):
    """One K3 (K4 with ``inverse``) launch on CUDA tensors, with the relu
    gates its recompute set: ((dparams, dx), (gates of s1, gates of s2)),
    each gate (M, H) bool, h > 0 of the h1 and h2 the launch left in its
    scratch. For the checks against the plain version
    (:func:`relu_gate_slack`'s ``gates``); the launch is counted."""
    if _device_of(x) != "cuda" or x.numel() == 0:
        raise ValueError("backward_relu_gates reads a kernel launch: it "
                         "needs a non-empty CUDA input")
    dparams, dx, scratch = _launch_backward(params, x, g, clamp, len1,
                                            inverse)
    c = x.shape[-1]
    m = x.numel() // c
    _, hidden = _mats(params, c, len1)
    hp = -(-hidden // 32) * 32      # the kernel's hidden width, padded
    lib = _bwd_lib()
    gates = []
    for sub in (1, 2):
        at = lib.sininn_coupling_1x1_bwd_hidden_offset(
            int(inverse), m, c, len1, hidden, sub)
        h = scratch[at:at + m * hp].view(m, hp)[:, :hidden]
        gates.append(h > 0)
    return (dparams, dx), tuple(gates)


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no coupling kernel for device {x.device}")
    return x.device.type


def fused_glow_forward_1x1(params: Dict, x: torch.Tensor, clamp: float,
                           len1: int) -> torch.Tensor:
    """Fused forward of a 1x1-subnet GLOW coupling. x: (N, H, W, C)."""
    if _device_of(x) == "cpu":
        return fused_glow_forward_1x1_plain(params, x, clamp, len1)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch(params, x, clamp, len1, inverse=False)
    count("launches.fused_glow_forward_1x1")
    return out


def fused_glow_inverse_1x1(params: Dict, y: torch.Tensor, clamp: float,
                           len1: int) -> torch.Tensor:
    """Fused inverse (exact inverse of the forward kernel). y: (N, H, W, C)."""
    if _device_of(y) == "cpu":
        return fused_glow_inverse_1x1_plain(params, y, clamp, len1)
    if y.numel() == 0:
        return torch.empty_like(y)
    out = _launch(params, y, clamp, len1, inverse=True)
    count("launches.fused_glow_inverse_1x1")
    return out


def _zero_grads(params: Dict, x: torch.Tensor):
    return (params_from_leaves([torch.zeros_like(t)
                                for t in param_leaves(params)]),
            torch.zeros_like(x))


def fused_glow_backward_1x1(params: Dict, x: torch.Tensor, g: torch.Tensor,
                            clamp: float, len1: int):
    """VJP of the fused forward at x for the cotangent g (K3).
    Returns (dparams, dx)."""
    if _device_of(x) == "cpu":
        return fused_glow_backward_1x1_plain(params, x, g, clamp, len1)
    if x.numel() == 0:
        return _zero_grads(params, x)
    return _launch_backward(params, x, g, clamp, len1, inverse=False)[:2]


def fused_glow_inverse_backward_1x1(params: Dict, y: torch.Tensor,
                                    g: torch.Tensor, clamp: float, len1: int):
    """VJP of the fused inverse at y for the cotangent g (K4).
    Returns (dparams, dy)."""
    if _device_of(y) == "cpu":
        return fused_glow_inverse_backward_1x1_plain(params, y, g, clamp,
                                                     len1)
    if y.numel() == 0:
        return _zero_grads(params, y)
    return _launch_backward(params, y, g, clamp, len1, inverse=True)[:2]


def reduce_weight_grads(partials: torch.Tensor) -> torch.Tensor:
    """The sum over the first axis of K3's or K4's per-block gradient
    partials (blocks, slot), taken in a fixed order by the reduction kernel
    of ``csrc/coupling_1x1_bwd.cu``."""
    if _device_of(partials) == "cpu":
        return partials.sum(0)
    if (partials.dim() != 2 or partials.dtype != torch.float32
            or not partials.is_contiguous() or partials.numel() == 0):
        raise ValueError(f"expected contiguous float32 (blocks, slot) "
                         f"partials, got {tuple(partials.shape)} "
                         f"{partials.dtype}")
    blocks, slot = partials.shape
    out = torch.empty(slot, dtype=torch.float32, device=partials.device)
    lib = _bwd_lib()
    with torch.cuda.device(partials.device):
        err = lib.sininn_reduce_partials(
            partials.data_ptr(), blocks, slot, out.data_ptr(),
            torch.cuda.current_stream(partials.device).cuda_stream)
    _raise_on(err, lib, "reduce_partials")
    count("launches.reduce_weight_grads")
    return out


class FusedCoupling1x1(torch.autograd.Function):
    """K1 forward, K3 backward. ``apply(x, clamp, len1, *leaves)`` with the
    eight OIHW leaves in :data:`LEAVES` order; gradients come back in the
    leaves' own shapes."""

    @staticmethod
    def forward(ctx, x, clamp, len1, *leaves):
        ctx.clamp, ctx.len1 = clamp, len1
        ctx.save_for_backward(x, *leaves)
        return fused_glow_forward_1x1(params_from_leaves(leaves), x, clamp,
                                      len1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        dparams, dx = fused_glow_backward_1x1(
            params_from_leaves(leaves), x, g.contiguous(), ctx.clamp,
            ctx.len1)
        return (dx, None, None, *param_leaves(dparams))


class FusedCouplingInverse1x1(torch.autograd.Function):
    """K2 forward, K4 backward; as :class:`FusedCoupling1x1`."""

    @staticmethod
    def forward(ctx, y, clamp, len1, *leaves):
        ctx.clamp, ctx.len1 = clamp, len1
        ctx.save_for_backward(y, *leaves)
        return fused_glow_inverse_1x1(params_from_leaves(leaves), y, clamp,
                                      len1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, *leaves = ctx.saved_tensors
        dparams, dy = fused_glow_inverse_backward_1x1(
            params_from_leaves(leaves), y, g.contiguous(), ctx.clamp,
            ctx.len1)
        return (dy, None, None, *param_leaves(dparams))


def fused_coupling(params: Dict, x: torch.Tensor, clamp: float, len1: int,
                   inverse: bool = False) -> torch.Tensor:
    """The differentiable fused coupling (forward, or inverse)."""
    fn = FusedCouplingInverse1x1 if inverse else FusedCoupling1x1
    return fn.apply(x, clamp, len1, *param_leaves(params))


KERNELS = (fused_glow_forward_1x1, fused_glow_inverse_1x1,
           fused_glow_backward_1x1, fused_glow_inverse_backward_1x1,
           reduce_weight_grads)


def launch_counts() -> Dict[str, int]:
    c = counters()
    return {k.__name__: c.get(f"launches.{k.__name__}", 0) for k in KERNELS}


def reset_launch_counts() -> None:
    reset_counters(tuple(f"launches.{k.__name__}" for k in KERNELS))
