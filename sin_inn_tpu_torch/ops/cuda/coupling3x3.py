"""GLOW coupling with 3x3-conv subnets (K8): CUDA kernels and plain versions.

Counterpart of ``sin_inn_tpu/ops/pallas/coupling3x3.py`` with the same
public names and no ``interpret=`` argument: a CUDA tensor launches the
kernels or raises, a CPU tensor takes the plain version. Nothing falls back
from one to the other.

* ``half_coupling_3x3`` (K8 forward, ``csrc/coupling_3x3.cu``) computes one
  half coupling, ``y = exp(le(s)) x_aff + t`` or, with ``inverse``,
  ``(x_aff - t) exp(-le(s))``, with ``[s | t] = conv2(relu(conv1(x_in)))``
  (SAME 3x3 convolutions), the hidden layer kept on the chip a 32-channel
  chunk at a time. Both convolutions are implicit GEMMs on the tensor cores
  in 3xTF32 (three TF32 ``mma.sync`` products a product, fp32 accuracy),
  the weights packed on every call. The TPU's whole-image, half and
  row-band kernels differ only in how they tile this function; on the card
  one launch is one half, so ``fused_glow3_forward`` / ``_inverse`` and the
  ``glow3_*_halves`` are two launches each.
* ``half_coupling_3x3_backward`` (K8 backward, ``csrc/coupling_3x3_bwd.cu``)
  is the VJP of one half: dx_in, dx_aff and the four weight and bias
  gradients, every product in 3xTF32 on the tensor cores, the weight
  gradients summed per chunk of pixels into gradient slots that
  ``reduce_weight_grads`` (``ops/cuda/coupling.py``) adds in a fixed order,
  so it is bitwise repeatable.
* ``make_fused_coupling3(clamp, len1)``: K8 primal, backward by recomputing
  the coupling through the convolution route (``ops/coupling.py`` over
  ``ops/subnet.py``, cuDNN on the card), as the JAX package recomputes it in
  XLA. ``make_half_banded`` / ``make_fused_coupling3_banded``: K8 primal
  and K8 backward as ``torch.autograd.Function``s.

The kernels take fp32 tensors only: Caff (the affine half's channels) up
to 384; Caff, the hidden width and, in the backward, Cin multiples of 4;
and a Cin whose smallest tile (8 x 4 pixels with a 2-pixel halo) fits a
block's shared memory (Cin up to 312 at Caff 96). Any other shape or dtype
raises a ValueError naming the limit. No entry point reaches this
module: the INN keeps its 3x3 couplings on the convolution route, as the
JAX package does (``models/inn.py``).

Each wrapper counts its launches in the profiler's counters
(``launches.half_coupling_3x3`` and so on, ``core/profiler.py``);
:func:`launch_counts` reads them.
"""

from __future__ import annotations

import ctypes
import functools
from functools import partial
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sin_inn_tpu_torch.core.profiler import (count, counters,
                                             reset_counters)
from sin_inn_tpu_torch.ops import coupling as C
from sin_inn_tpu_torch.ops import subnet as S
from sin_inn_tpu_torch.ops.coupling import glow_log_e
from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.cuda import coupling as K

_MAX_SMEM = 232_448

# one subnet's leaves, in the autograd Functions' operand order
SUB_LEAVES = (("conv1", "w"), ("conv1", "b"), ("conv2", "w"), ("conv2", "b"))


def sub_leaves(sub: Dict) -> List[torch.Tensor]:
    return [sub[c][k] for c, k in SUB_LEAVES]


def sub_from_leaves(leaves: Sequence[torch.Tensor]) -> Dict:
    out: Dict = {}
    for (c, k), t in zip(SUB_LEAVES, leaves):
        out.setdefault(c, {})[k] = t
    return out


def _conv3x3(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """SAME 3x3 convolution of NHWC ``x`` with the OIHW kernel ``w`` as
    nine shifted products over the zero-padded input, in fp32 (the form of
    the TPU kernels' ``_conv3x3``)."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wk = w.float().permute(2, 3, 1, 0)        # (3, 3, cin, cout)
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + h, dx:dx + wd] @ wk[dy, dx]
            acc = term if acc is None else acc + term
    return acc if b is None else acc + b.float()


def _flip_t(w: torch.Tensor) -> torch.Tensor:
    """The OIHW kernel of the transposed convolution: flipped, in and out
    swapped."""
    return w.flip(2, 3).transpose(0, 1)


def _weight_grad(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum over pixels p of a[p + tap] g[p]^T for each of the nine taps
    (a zero-padded), as an OIHW gradient (cout, cin, 3, 3)."""
    n, h, wd, ca = a.shape
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    gf = g.reshape(-1, g.shape[-1])
    taps = [ap[:, dy:dy + h, dx:dx + wd].reshape(-1, ca).t() @ gf
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).view(3, 3, ca, -1).permute(3, 2, 0, 1)


def _shapes(sub: Dict, x_in: torch.Tensor, x_aff: torch.Tensor
            ) -> Tuple[int, int, int]:
    """(cin, caff, hidden), after checking the subnet against the inputs."""
    if x_in.dim() != 4 or x_aff.dim() != 4 or \
            x_in.shape[:3] != x_aff.shape[:3]:
        raise ValueError(f"expected NHWC x_in and x_aff of one size, got "
                         f"{tuple(x_in.shape)} and {tuple(x_aff.shape)}")
    cin, caff = x_in.shape[-1], x_aff.shape[-1]
    hid = sub["conv1"]["w"].shape[0]
    want = {"conv1": (hid, cin, 3, 3), "conv2": (2 * caff, hid, 3, 3)}
    for conv, shape in want.items():
        w, b = sub[conv]["w"], sub[conv]["b"]
        if tuple(w.shape) != shape or tuple(b.shape) != (shape[0],):
            raise ValueError(f"{conv}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, expected {shape} / "
                             f"({shape[0]},) for Cin={cin}, Caff={caff}")
    return cin, caff, hid


def half_coupling_3x3_plain(sub_params: Dict, x_in: torch.Tensor,
                            x_aff: torch.Tensor, clamp: float,
                            inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of one half coupling, in fp32."""
    _, caff, _ = _shapes(sub_params, x_in, x_aff)
    h = torch.relu(_conv3x3(x_in, sub_params["conv1"]["w"],
                            sub_params["conv1"]["b"]))
    r = _conv3x3(h, sub_params["conv2"]["w"], sub_params["conv2"]["b"])
    le = glow_log_e(r[..., :caff], clamp)
    t = r[..., caff:]
    xa = x_aff.float()
    y = (xa - t) * torch.exp(-le) if inverse else torch.exp(le) * xa + t
    return y.to(x_aff.dtype)


def _plain_cotangents(sub_params: Dict, x_in: torch.Tensor,
                      x_aff: torch.Tensor, g: torch.Tensor, clamp: float,
                      inverse: bool):
    """The plain backward up to the relu gate, in fp32: (x_in, z = conv1's
    pre-activation, h, gr = [gs | gt], gh = h's cotangent, dx_aff)."""
    _, caff, _ = _shapes(sub_params, x_in, x_aff)
    w2, b2 = sub_params["conv2"]["w"], sub_params["conv2"]["b"]
    x, xa, gg = x_in.float(), x_aff.float(), g.float()
    z = _conv3x3(x, sub_params["conv1"]["w"], sub_params["conv1"]["b"])
    h = torch.relu(z)
    r = _conv3x3(h, w2, b2)
    s, t = r[..., :caff], r[..., caff:]
    le = glow_log_e(s, clamp)
    lp = K._log_e_prime(s, clamp)
    if inverse:
        einv = torch.exp(-le)
        gs = -gg * ((xa - t) * einv) * lp
        gt = -gg * einv
        dx_aff = gg * einv
    else:
        e = torch.exp(le)
        gs = gg * xa * e * lp
        gt = gg
        dx_aff = gg * e
    gr = torch.cat([gs, gt], dim=-1)
    return x, z, h, gr, _conv3x3(gr, _flip_t(w2)), dx_aff


def half_coupling_3x3_backward_plain(sub_params: Dict, x_in: torch.Tensor,
                                     x_aff: torch.Tensor, g: torch.Tensor,
                                     clamp: float, inverse: bool = False):
    """Plain version of K8 backward, hand-derived as the TPU's
    ``_half_band_bwd_kernel`` on the whole image. Returns (dsub, dx_in,
    dx_aff), dsub shaped like the subnet's params."""
    x, z, h, gr, gh, dx_aff = _plain_cotangents(sub_params, x_in, x_aff, g,
                                                clamp, inverse)
    gz = torch.where(z > 0, gh, 0.0)
    dx_in = _conv3x3(gz, _flip_t(sub_params["conv1"]["w"]))
    dsub = {"conv1": {"w": _weight_grad(x, gz), "b": gz.sum((0, 1, 2))},
            "conv2": {"w": _weight_grad(h, gr), "b": gr.sum((0, 1, 2))}}
    return dsub, dx_in.to(x_in.dtype), dx_aff.to(x_aff.dtype)


def relu_gate_slack(sub_params: Dict, x_in: torch.Tensor,
                    x_aff: torch.Tensor, g: torch.Tensor, clamp: float,
                    inverse: bool = False, tau: float = 1e-5):
    """How far another fp32 backward of the half may stand from the plain
    one through the relu gate alone: a conv1 pre-activation within ``tau``
    of 0 may be gated either way once the sums run in another order, which
    adds or drops its term. Returns elementwise bounds (dx_in, dW1 OIHW,
    db1): the sums of the absolute values of those terms (0 where no gate
    is that close)."""
    x, z, _, _, gh, _ = _plain_cotangents(sub_params, x_in, x_aff, g, clamp,
                                          inverse)
    near = torch.where(z.abs() < tau, gh.abs(), 0.0)
    w1 = sub_params["conv1"]["w"]
    return (_conv3x3(near, _flip_t(w1).abs()), _weight_grad(x.abs(), near),
            near.sum((0, 1, 2)))


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    if name == "coupling_3x3":
        lib.sininn_coupling_3x3_smem_bytes.argtypes = [i32, i32]
        lib.sininn_coupling_3x3_smem_bytes.restype = i64
        lib.sininn_coupling_3x3_scratch_floats.argtypes = [i32, i32, i32]
        lib.sininn_coupling_3x3_scratch_floats.restype = i64
        lib.sininn_coupling_3x3.argtypes = (
            [i32, ptr, ptr, ptr] + [i32] * 6 + [ptr] * 4
            + [ctypes.c_float, ptr, ptr])
        lib.sininn_coupling_3x3.restype = i32
    else:
        for fn in ("smem_bytes", "scratch_floats", "slot_floats"):
            f = getattr(lib, f"sininn_coupling_3x3_bwd_{fn}")
            f.argtypes = [i32, i32, i32]
            f.restype = i64
        lib.sininn_coupling_3x3_bwd_chunks.argtypes = [i64, i32, i32, i32]
        lib.sininn_coupling_3x3_bwd_chunks.restype = i64
        lib.sininn_coupling_3x3_bwd.argtypes = (
            [i32] + [ptr] * 9 + [i64] + [i32] * 6 + [ptr] * 4
            + [ctypes.c_float, ptr, ptr])
        lib.sininn_coupling_3x3_bwd.restype = i32
    return lib


def _check_smem(smem: int, what: str, caff: int) -> None:
    """Raise a ValueError naming the limit a launch's shapes break."""
    if smem < 0:
        raise ValueError(f"{what}: the K8 kernels take Caff up to 384, got "
                         f"{caff}")
    if smem > _MAX_SMEM:
        raise ValueError(f"{what} needs {smem} bytes of shared memory for "
                         f"its block (max {_MAX_SMEM})")


def _check_kernel_inputs(tensors: Sequence[torch.Tensor], caff: int,
                         hid: int, cin=None) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"the K8 kernels take float32 tensors on one "
                             f"device, got {t.dtype} on {t.device}")
    for name, v in (("Caff", caff), ("hidden", hid), ("Cin", cin)):
        if v is not None and v % 4:
            raise ValueError(f"the K8 kernels need {name} a multiple of 4, "
                             f"got {v}")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.sininn_error_string(err).decode())


def _weights(sub: Dict) -> List[torch.Tensor]:
    """w1, b1, w2, b2 as stored (OIHW): the kernels pack them on every
    call, since the optimizer updates them in place."""
    return [sub[c][k].detach().contiguous() for c, k in SUB_LEAVES]


def half_coupling_3x3(sub_params: Dict, x_in: torch.Tensor,
                      x_aff: torch.Tensor, clamp: float,
                      inverse: bool = False) -> torch.Tensor:
    """One fused half coupling: subnet(x_in) -> affine on x_aff (NHWC)."""
    if K._device_of(x_in) == "cpu":
        return half_coupling_3x3_plain(sub_params, x_in, x_aff, clamp,
                                       inverse)
    cin, caff, hid = _shapes(sub_params, x_in, x_aff)
    mats = _weights(sub_params)
    _check_kernel_inputs([x_in, x_aff, *mats], caff, hid)
    lib = _lib("coupling_3x3")
    _check_smem(lib.sininn_coupling_3x3_smem_bytes(cin, caff),
                f"K8 forward (Cin={cin}, Caff={caff})", caff)
    if x_in.numel() == 0 or x_aff.numel() == 0:
        return torch.empty_like(x_aff)
    x_in, x_aff = x_in.contiguous(), x_aff.contiguous()
    y = torch.empty_like(x_aff)
    packed = torch.empty(lib.sininn_coupling_3x3_scratch_floats(cin, caff,
                                                                hid),
                         device=x_in.device)
    n, h, w, _ = x_in.shape
    with torch.cuda.device(x_in.device):
        err = lib.sininn_coupling_3x3(
            int(inverse), x_in.data_ptr(), x_aff.data_ptr(), y.data_ptr(),
            n, h, w, cin, caff, hid, *[t.data_ptr() for t in mats],
            float(clamp), packed.data_ptr(),
            torch.cuda.current_stream(x_in.device).cuda_stream)
    _raise_on(err, lib, "coupling_3x3")
    count("launches.half_coupling_3x3")
    return y


def backward_chunks(m: int, cin: int, caff: int, hid: int) -> int:
    """Gradient slots (chunks of pixels) K8 backward uses for m pixels on
    the current card."""
    return _lib("coupling_3x3_bwd").sininn_coupling_3x3_bwd_chunks(
        m, cin, caff, hid)


def half_coupling_3x3_backward(sub_params: Dict, x_in: torch.Tensor,
                               x_aff: torch.Tensor, g: torch.Tensor,
                               clamp: float, inverse: bool = False):
    """VJP of one half coupling at (x_in, x_aff) for the cotangent g of its
    output (K8 backward). Returns (dsub, dx_in, dx_aff)."""
    if K._device_of(x_in) == "cpu":
        return half_coupling_3x3_backward_plain(sub_params, x_in, x_aff, g,
                                                clamp, inverse)
    cin, caff, hid = _shapes(sub_params, x_in, x_aff)
    if g.shape != x_aff.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the "
                         f"output {tuple(x_aff.shape)}")
    mats = _weights(sub_params)
    _check_kernel_inputs([x_in, x_aff, g, *mats], caff, hid, cin)
    lib = _lib("coupling_3x3_bwd")
    _check_smem(lib.sininn_coupling_3x3_bwd_smem_bytes(cin, caff, hid),
                f"K8 backward (Cin={cin}, Caff={caff}, hidden={hid})", caff)
    if x_in.numel() == 0:
        return ({c: {k: torch.zeros_like(t) for k, t in conv.items()}
                 for c, conv in sub_params.items()},
                torch.zeros_like(x_in), torch.zeros_like(x_aff))
    x_in, x_aff, g = x_in.contiguous(), x_aff.contiguous(), g.contiguous()
    n, h, w, _ = x_in.shape
    m = n * h * w
    hp = -(-hid // 32) * 32
    dev = x_in.device
    dx_in, dx_aff = torch.empty_like(x_in), torch.empty_like(x_aff)
    h_buf = torch.empty((n, h, w, hp), device=dev)
    gz_buf = torch.empty_like(h_buf)
    gr_buf = torch.empty((n, h, w, 2 * caff), device=dev)
    packed = torch.empty(lib.sininn_coupling_3x3_bwd_scratch_floats(
        cin, caff, hid), device=dev)
    with torch.cuda.device(dev):
        chunks = backward_chunks(m, cin, caff, hid)
        if chunks <= 0:
            raise RuntimeError("coupling_3x3_bwd: no gradient slot plan on "
                               "this device")
        partials = torch.empty(
            (chunks, lib.sininn_coupling_3x3_bwd_slot_floats(cin, caff, hid)),
            device=dev)
        err = lib.sininn_coupling_3x3_bwd(
            int(inverse), x_in.data_ptr(), x_aff.data_ptr(), g.data_ptr(),
            dx_in.data_ptr(), dx_aff.data_ptr(), h_buf.data_ptr(),
            gz_buf.data_ptr(), gr_buf.data_ptr(), partials.data_ptr(),
            chunks, n, h, w, cin, caff, hid, *[t.data_ptr() for t in mats],
            float(clamp), packed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "coupling_3x3_bwd")
    count("launches.half_coupling_3x3_backward")
    del h_buf, gz_buf, gr_buf, packed
    sums = K.reduce_weight_grads(partials)
    n1 = (9 * cin + 1) * hid
    g1 = sums[:n1].view(9 * cin + 1, hid)
    g2 = sums[n1:].view(9 * hid + 1, 2 * caff)
    oihw = lambda v, ci: v.view(3, 3, ci, -1).permute(3, 2, 0, 1).contiguous()
    dsub = {"conv1": {"w": oihw(g1[:-1], cin), "b": g1[-1]},
            "conv2": {"w": oihw(g2[:-1], hid), "b": g2[-1]}}
    return dsub, dx_in, dx_aff


def glow3_forward_halves(params: Dict, x: torch.Tensor, clamp: float,
                         len1: int) -> torch.Tensor:
    """Full 3x3 coupling as two half-coupling launches."""
    x1, x2 = x[..., :len1], x[..., len1:]
    y1 = half_coupling_3x3(params["s2"], x2, x1, clamp, False)
    y2 = half_coupling_3x3(params["s1"], y1, x2, clamp, False)
    return torch.cat([y1, y2], dim=-1)


def glow3_inverse_halves(params: Dict, y: torch.Tensor, clamp: float,
                         len1: int) -> torch.Tensor:
    y1, y2 = y[..., :len1], y[..., len1:]
    x2 = half_coupling_3x3(params["s1"], y1, y2, clamp, True)
    x1 = half_coupling_3x3(params["s2"], x2, y1, clamp, True)
    return torch.cat([x1, x2], dim=-1)


# The TPU's whole-image kernels hold one image's hidden layer in VMEM; a
# block on the card holds a tile of it, so the whole coupling is the halves.
fused_glow3_forward = glow3_forward_halves
fused_glow3_inverse = glow3_inverse_halves


class _Coupling3Recompute(torch.autograd.Function):
    """K8 primal; backward by autograd of the convolution route."""

    @staticmethod
    def forward(ctx, x, clamp, len1, inverse, compute, *leaves):
        ctx.args = (clamp, len1, inverse, compute)
        ctx.save_for_backward(x, *leaves)
        fn = fused_glow3_inverse if inverse else fused_glow3_forward
        return fn(K.params_from_leaves(leaves), x, clamp, len1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        clamp, len1, inverse, compute = ctx.args
        x, *leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
        subnet = partial(S.conv_subnet_apply, compute=compute)
        params = K.params_from_leaves(leaves)
        with torch.enable_grad():
            out = (C.glow_coupling_inverse(params, x, subnet, clamp, len1)
                   if inverse else
                   C.glow_coupling_forward(params, x, subnet, clamp, len1)[0])
            grads = torch.autograd.grad(out, [x, *leaves], g)
        return (grads[0], None, None, None, None, *grads[1:])


@functools.lru_cache(maxsize=None)
def make_fused_coupling3(clamp: float, len1: int, compute=None):
    """(forward, inverse) differentiable ops for the 3x3-subnet coupling:
    K8 primal, the backward recomputed through the convolution route in
    ``compute`` mode (``ops/subnet.py`` ``conv2d``)."""
    def fwd(params, x):
        return _Coupling3Recompute.apply(x, clamp, len1, False, compute,
                                         *K.param_leaves(params))

    def inv(params, y):
        return _Coupling3Recompute.apply(y, clamp, len1, True, compute,
                                         *K.param_leaves(params))
    return fwd, inv


class HalfCoupling3x3(torch.autograd.Function):
    """K8 forward, K8 backward for one half. ``apply(x_in, x_aff, clamp,
    inverse, *leaves)`` with the subnet's four leaves in
    :data:`SUB_LEAVES` order."""

    @staticmethod
    def forward(ctx, x_in, x_aff, clamp, inverse, *leaves):
        ctx.clamp, ctx.inverse = clamp, inverse
        ctx.save_for_backward(x_in, x_aff, *leaves)
        return half_coupling_3x3(sub_from_leaves(leaves), x_in, x_aff, clamp,
                                 inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x_in, x_aff, *leaves = ctx.saved_tensors
        dsub, dx_in, dx_aff = half_coupling_3x3_backward(
            sub_from_leaves(leaves), x_in, x_aff, g.contiguous(), ctx.clamp,
            ctx.inverse)
        return (dx_in, dx_aff, None, None, *sub_leaves(dsub))


@functools.lru_cache(maxsize=None)
def make_half_banded(clamp: float, inverse: bool):
    """Differentiable half coupling with K8 forward and K8 backward (the
    TPU's row bands have no counterpart: the kernel tiles in 2-D)."""
    def half(sub_params, x_in, x_aff):
        return HalfCoupling3x3.apply(x_in, x_aff, clamp, inverse,
                                     *sub_leaves(sub_params))
    return half


@functools.lru_cache(maxsize=None)
def make_fused_coupling3_banded(clamp: float, len1: int):
    """(forward, inverse) for the full 3x3 coupling from two differentiable
    halves; y1 (x2 in the inverse) is the only intermediate kept for the
    backward."""
    h_fwd = make_half_banded(clamp, False)
    h_inv = make_half_banded(clamp, True)

    def fwd(params, x):
        x1, x2 = x[..., :len1], x[..., len1:]
        y1 = h_fwd(params["s2"], x2, x1)
        y2 = h_fwd(params["s1"], y1, x2)
        return torch.cat([y1, y2], dim=-1)

    def inv(params, y):
        y1, y2 = y[..., :len1], y[..., len1:]
        x2 = h_inv(params["s1"], y1, y2)
        x1 = h_inv(params["s2"], x2, y1)
        return torch.cat([x1, x2], dim=-1)
    return fwd, inv


KERNELS = (half_coupling_3x3, half_coupling_3x3_backward)


def launch_counts() -> Dict[str, int]:
    c = counters()
    return {k.__name__: c.get(f"launches.{k.__name__}", 0) for k in KERNELS}


def reset_launch_counts() -> None:
    reset_counters(tuple(f"launches.{k.__name__}" for k in KERNELS))
