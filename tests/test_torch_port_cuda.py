"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a machine with the card and nvcc:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Tolerance for fp32 storage: 1e-4 + 1e-4 |plain| (sums over the hidden width
in another order, K1-K4's products in 3xTF32 on the tensor cores, atanf
against torch.atan); bf16 storage: one bf16 rounding step. Weight and bias
gradients of the backward kernels: 1e-3 of the largest |plain| of each
(sums over all rows in another order); K3/K4's dx and leaves each plus
``relu_gate_slack`` over the gates the launch set otherwise than the plain
version at a pre-activation within 1e-5 of 0 (such a gate may go either
way: 3xTF32 products and another order). The
windowed splat (K5) and gather (K6, forward and gradient mode): 1e-5 +
1e-5 |plain| (K5 sums in fixed point, the plain version in fp32 in another
order; K6 repeats the plain arithmetic); their local-window forms (K5
local, K6 local) the same; K5 and K5 local bit for bit as the CPU model of
their fixed-point sums (``tests/torch_port_helpers.py``), and so bitwise
repeatable.
The fused INR backward (K7): each weight and bias
gradient within 1e-3 of the largest |plain| of it, bitwise repeatable, in
every mask mode and with the coordinate rows of a progressive net; the fused
INR forward (K7 forward): 1e-4 + 1e-4 |plain| in fp32 (sums over up to 515
channels in another order, 3xTF32 products), 2e-2 in the bf16 operand mode
(activations near a bf16 tie round either way), bitwise repeatable, and in
fp32 normwise within 1e-5 (one-pass TF32 would give about 1e-4); the
train step's kernel route within a normwise 1e-3 of autograd's.
"""

import pytest
import torch
from torch_port_helpers import k5_local_model, k5_model

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.ops import subnet as S
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.cuda import gather as K6
from sin_inn_tpu_torch.ops.cuda import inr as K7
from sin_inn_tpu_torch.ops.cuda import splat as K5

pytestmark = pytest.mark.cuda

CLAMP = 1.2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def _params(c, len1, hidden, dev, kernel=1):
    gen = R.root_generator(c * 1000 + len1)
    len2 = c - len1
    p = {"s1": S.conv_subnet_init(gen, len1, 2 * len2, kernel, hidden),
         "s2": S.conv_subnet_init(gen, len2, 2 * len1, kernel, hidden)}
    return {s: {k: {n: t.to(dev) for n, t in conv.items()}
                for k, conv in sub.items()} for s, sub in p.items()}


@pytest.mark.parametrize("shape,len1,hidden", [
    ((2, 9, 13, 48), 24, 256),     # ragged last tile
    ((1, 5, 7, 192), 96, 256),
    ((3, 4, 5, 12), 5, 32),        # uneven split, narrow hidden
    ((1, 9, 15, 48), 24, 256),     # M = 135: a 128-row tile and 7 rows
    ((3, 37, 41, 192), 96, 256),   # M = 4,551: not a multiple of 128
    ((8, 88, 160, 48), 24, 256),   # the flagship's batch-8 octaves
    ((8, 44, 80, 192), 96, 256),
    ((1, 7, 73, 256), 128, 256),   # M = 511, 4 passes over Wb's columns
    ((1, 7, 73, 384), 192, 256),   # 6-warp blocks, 24 passes
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(dev, shape, len1, hidden, dtype):
    p = _params(shape[-1], len1, hidden, dev)
    x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).to(dtype)
    step = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    with torch.inference_mode():
        K.reset_launch_counts()
        for fn, plain in ((K.fused_glow_forward_1x1,
                           K.fused_glow_forward_1x1_plain),
                          (K.fused_glow_inverse_1x1,
                           K.fused_glow_inverse_1x1_plain)):
            got = fn(p, x, CLAMP, len1).float()
            ref = plain(p, x, CLAMP, len1).float()
            torch.cuda.synchronize()
            assert ((got - ref).abs() <= 1e-4 + step * ref.abs()).all()
        counts = K.launch_counts()
        assert counts["fused_glow_forward_1x1"] == 1
        assert counts["fused_glow_inverse_1x1"] == 1


@pytest.mark.parametrize("c,len1,hidden,plan", [
    (12, 5, 32, (8, 1, 1)),
    (48, 24, 256, (8, 1, 1)),
    (192, 96, 256, (8, 1, 1)),
    (256, 128, 256, (8, 4, 4)),
    (384, 192, 256, (6, 24, 24)),
])
def test_kernel_plan(dev, c, len1, hidden, plan):
    """The block heights and passes of ``test_kernels_match_plain``'s
    shapes: one pass of 8 warps on the SRF path, the narrower plans at the
    wider C."""
    assert K.coupling_plan(c, len1, hidden) == plan


def test_kernel_round_trip(dev):
    p = _params(48, 24, 256, dev)
    x = torch.randn((4, 16, 16, 48), device=dev)
    with torch.inference_mode():
        back = K.fused_glow_inverse_1x1(
            p, K.fused_glow_forward_1x1(p, x, CLAMP, 24), CLAMP, 24)
    assert (back - x).abs().max().item() <= 1e-4


def _assert_grads_close(got, ref, dx, dx_ref, step, slack):
    """The backward's limits, each plus the terms of the relu gates within
    rounding of 0 (``slack``: ``K.relu_gate_slack`` of the same call)."""
    sp, sdx = slack
    for a, b, s in zip(K.param_leaves(got), K.param_leaves(ref),
                       K.param_leaves(sp)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert ((a - b).abs() - s).max().item() <= 1e-3 * b.abs().max().item()
    dx, dx_ref = dx.float(), dx_ref.float()
    assert ((dx - dx_ref).abs() <= 1e-4 + step * dx_ref.abs() + sdx).all()


@pytest.mark.parametrize("shape,len1,hidden", [
    ((2, 9, 13, 48), 24, 256),     # ragged last tile
    ((1, 5, 7, 192), 96, 256),
    ((3, 4, 5, 12), 5, 32),        # uneven split, narrow hidden
    ((4, 44, 80, 48), 24, 256),    # many tiles per block
    ((3, 37, 41, 48), 24, 256),    # M = 4,551: neither 128-row tiles nor
                                   # 2,048-row slots divide it
    ((8, 88, 160, 48), 24, 256),   # the flagship's batch-8 octaves
    ((8, 44, 80, 192), 96, 256),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain(dev, shape, len1, hidden, dtype):
    p = _params(shape[-1], len1, hidden, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    step = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    gated = {inverse: K.backward_relu_gates(p, x, g, CLAMP, len1, inverse)
             for inverse in (False, True)}
    K.reset_launch_counts()
    for fn, plain in ((K.fused_glow_backward_1x1,
                       K.fused_glow_backward_1x1_plain),
                      (K.fused_glow_inverse_backward_1x1,
                       K.fused_glow_inverse_backward_1x1_plain)):
        dp, dx = fn(p, x, g, CLAMP, len1)
        rp, rx = plain(p, x, g, CLAMP, len1)
        torch.cuda.synchronize()
        assert dx.dtype == dtype
        inverse = fn is K.fused_glow_inverse_backward_1x1
        (_, dx_gated), gates = gated[inverse]
        assert torch.equal(dx, dx_gated)      # the gates of this result
        slack = K.relu_gate_slack(p, x, g, CLAMP, len1, inverse, gates)
        _assert_grads_close(dp, rp, dx, rx, step, slack)
    counts = K.launch_counts()
    assert counts["fused_glow_backward_1x1"] == 1
    assert counts["fused_glow_inverse_backward_1x1"] == 1
    assert counts["reduce_weight_grads"] == 2


def test_backward_is_deterministic(dev):
    p = _params(192, 96, 256, dev)
    x = torch.randn((2, 22, 40, 192), device=dev)
    g = torch.randn_like(x)
    a = K.fused_glow_backward_1x1(p, x, g, CLAMP, 96)
    b = K.fused_glow_backward_1x1(p, x, g, CLAMP, 96)
    for u, v in zip(K.param_leaves(a[0]) + [a[1]],
                    K.param_leaves(b[0]) + [b[1]]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("shape,len1", [((8, 88, 160, 48), 24),
                                        ((8, 44, 80, 192), 96)])
@pytest.mark.parametrize("inverse", [False, True])
def test_backward_is_deterministic_at_flagship_shapes(dev, shape, len1,
                                                      inverse):
    p = _params(shape[-1], len1, 256, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    fn = (K.fused_glow_inverse_backward_1x1 if inverse
          else K.fused_glow_backward_1x1)
    a = fn(p, x, g, CLAMP, len1)
    b = fn(p, x, g, CLAMP, len1)
    for u, v in zip(K.param_leaves(a[0]) + [a[1]],
                    K.param_leaves(b[0]) + [b[1]]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("inverse", [False, True])
def test_gradients_flow_through_backward_kernels(dev, inverse):
    """Autograd through the fused Functions launches K1/K2 forward and
    K3/K4 backward, and matches the plain backward."""
    p = _params(48, 24, 256, dev)
    for t in K.param_leaves(p):
        t.requires_grad_(True)
    x = torch.randn((2, 6, 7, 48), device=dev, requires_grad=True)
    g = torch.randn((2, 6, 7, 48), device=dev)
    K.reset_launch_counts()
    out = K.fused_coupling(p, x, CLAMP, 24, inverse=inverse)
    (out * g).sum().backward()
    counts = K.launch_counts()
    fwd = "fused_glow_inverse_1x1" if inverse else "fused_glow_forward_1x1"
    bwd = ("fused_glow_inverse_backward_1x1" if inverse
           else "fused_glow_backward_1x1")
    assert counts[fwd] == 1 and counts[bwd] == 1
    assert counts["reduce_weight_grads"] == 1
    plain = (K.fused_glow_inverse_backward_1x1_plain if inverse
             else K.fused_glow_backward_1x1_plain)
    detached = K.params_from_leaves([t.detach() for t in K.param_leaves(p)])
    rp, rx = plain(detached, x.detach(), g, CLAMP, 24)
    got = K.params_from_leaves([t.grad for t in K.param_leaves(p)])
    _, gates = K.backward_relu_gates(detached, x.detach(), g, CLAMP, 24,
                                     inverse)
    slack = K.relu_gate_slack(detached, x.detach(), g, CLAMP, 24, inverse,
                              gates)
    _assert_grads_close(got, rp, x.grad, rx, 1e-4, slack)


@pytest.mark.parametrize("inverse", [False, True])
def test_backward_relu_gates_differ_only_near_zero(dev, inverse):
    """The relu gates K3/K4 set, read back from the launch, are the plain
    version's except at pre-activations within rounding of 0."""
    p = _params(48, 24, 256, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((8, 88, 160, 48), generator=gen, device=dev)
    g = torch.randn((8, 88, 160, 48), generator=gen, device=dev)
    (_, dx), gates = K.backward_relu_gates(p, x, g, CLAMP, 24, inverse)
    fn = (K.fused_glow_inverse_backward_1x1 if inverse
          else K.fused_glow_backward_1x1)
    assert torch.equal(dx, fn(p, x, g, CLAMP, 24)[1])
    _, _, z = K._plain_rows(p, x.reshape(-1, 48), g.reshape(-1, 48), CLAMP,
                            24, inverse)
    for gi, zi in zip(gates, z):
        assert gi.shape == zi.shape and gi.dtype == torch.bool
        flipped = gi != (zi > 0)
        assert (zi.abs()[flipped] < 1e-5).all()
        assert gi.sum() > zi.numel() // 4        # the gates are not all off


def test_kernel_refuses_what_it_cannot_take(dev):
    p = _params(48, 24, 256, dev)
    x = torch.randn((2, 4, 4, 48), device=dev)
    with torch.inference_mode():
        with pytest.raises(ValueError):
            K.fused_glow_forward_1x1(p, x.transpose(1, 2), CLAMP, 24)
        with pytest.raises(TypeError):
            K.fused_glow_forward_1x1(p, x.half(), CLAMP, 24)
        with pytest.raises(ValueError):
            K.fused_glow_forward_1x1(_params(48, 24, 256, "cpu"), x,
                                     CLAMP, 24)
        with pytest.raises(ValueError):
            K.fused_glow_backward_1x1(p, x, x[..., :12].contiguous(),
                                      CLAMP, 24)


def _flow(gen, n, h, w, amp, dev):
    """A smooth flow of amplitude ``amp`` px plus a little noise."""
    ys = torch.linspace(0, 3.14, h, device=dev)[None, :, None]
    xs = torch.linspace(0, 6.28, w, device=dev)[None, None, :]
    fx = amp * torch.sin(xs + ys) + torch.randn((n, h, w), generator=gen,
                                                device=dev)
    fy = amp * torch.cos(xs - ys) + torch.randn((n, h, w), generator=gen,
                                                device=dev)
    return torch.stack([fx, fy], -1).contiguous()


@pytest.mark.parametrize("shape,c,bounds,amp", [
    ((2, 40, 50), 3, (8, 8), 5.0),        # in the window
    ((1, 200, 300), 3, (8, 8), 20.0),     # beyond it: the drop rule
    ((1, 436, 1024), 3, (64, 128), 90.0),  # the flow path's shape
    ((1, 130, 260), 5, (13, 70), 30.0),   # unpadded bounds
    ((300, 240, 8), 3, (8, 8), 3.0),      # more image rows than grid rows
    ((2, 45, 301), 3, (8, 8), 20.0),      # no multiple of the 128-column
    ((1, 37, 260), 5, (8, 64), 10.0),     # block or of the 8-row chunk
])
def test_windowed_kernels_match_plain(dev, shape, c, bounds, amp):
    gen = torch.Generator(device=dev).manual_seed(2)
    n, h, w = shape
    a = torch.rand((n, h, w, c), generator=gen, device=dev)
    fl = _flow(gen, n, h, w, amp, dev)
    K5.reset_launch_counts()
    K6.reset_launch_counts()
    for coord in (K6.resample_coord(h, w), ((1.0, 0.0), (1.0, 0.0))):
        got = K6.gather_region(a, fl, *bounds, coord)
        ref = K6.gather_region_plain(a, fl, *bounds, coord)
        torch.cuda.synchronize()
        assert ((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()
    v = torch.rand((n, h, w, 5), generator=gen, device=dev)
    got = K5.splat_region(v, fl, *bounds)
    ref = K5.splat_region_plain(v, fl, *bounds)
    torch.cuda.synchronize()
    assert ((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()
    assert K6.launch_counts() == {"gather_region": 2,
                                  "gather_region_grads": 0,
                                  "gather_region_local": 0,
                                  "gather_region_local_grads": 0}
    assert K5.launch_counts() == {"splat_region": 1, "splat_region_local": 0}


@pytest.mark.parametrize("shape,c,bounds,amp", [
    ((1, 200, 300), 5, (8, 8), 20.0),     # the drop rule
    ((2, 130, 260), 3, (13, 70), 30.0),   # unpadded bounds, two images
    ((1, 436, 1024), 5, (64, 128), 90.0),  # the flow path's shape
])
def test_splat_kernels_are_their_fixed_point_model(dev, shape, c, bounds,
                                                   amp):
    """K5 and K5 local give the CPU model's bits (fixed-point sums: any
    order of the atomics gives them), so two launches agree bitwise."""
    from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

    gen = torch.Generator(device=dev).manual_seed(21)
    n, h, w = shape
    fl = _flow(gen, n, h, w, amp, dev)
    v = torch.rand((n, h, w, c), generator=gen, device=dev)
    v[..., -1] = 1.0
    got = K5.splat_region(v, fl, *bounds)
    again = K5.splat_region(v, fl, *bounds)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), k5_model(v.cpu(), fl.cpu(), *bounds))
    offs = tile_flow_offsets(fl, 128, 128, 2 * bounds[0], 0)
    ldy = max(bounds[0] // 2, 1)
    got = K5.splat_region_local(v, fl, offs.off_out, offs.off_src, ldy,
                                bounds[1])
    again = K5.splat_region_local(v, fl, offs.off_out, offs.off_src, ldy,
                                  bounds[1])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), k5_local_model(
        v.cpu(), fl.cpu(), offs.off_out.cpu(), ldy, bounds[1]))


def test_splat_kernel_non_finite_values(dev):
    """A value that is Inf or NaN: the plain version's NaN and Inf pixels,
    the finite ones within the limit; more than 8 channels are refused."""
    gen = torch.Generator(device=dev).manual_seed(22)
    v = torch.rand((1, 40, 60, 5), generator=gen, device=dev)
    v[0, 5, 7, 0] = float("inf")
    v[0, 5, 8, 0] = float("-inf")
    v[0, 20, 30, 1] = float("nan")
    v[0, 33, 50, 2] = float("-inf")
    fl = _flow(gen, 1, 40, 60, 2.0, dev)
    got = K5.splat_region(v, fl, 4, 8)
    ref = K5.splat_region_plain(v, fl, 4, 8)
    torch.cuda.synchronize()
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(ref))
    fin = torch.isfinite(ref)
    assert ((got - ref)[fin].abs() <= 1e-5 + 1e-5 * ref[fin].abs()).all()
    model = k5_model(v.cpu(), fl.cpu(), 4, 8)
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(model))
    nan0 = lambda t: torch.where(torch.isnan(t), 0.0, t)
    assert torch.equal(nan0(got.cpu()), nan0(model))
    with pytest.raises(ValueError, match="at most 8 channels"):
        K5.splat_region(torch.rand((1, 8, 8, 9), device=dev),
                        torch.zeros((1, 8, 8, 2), device=dev), 4, 4)


def test_gather_kernel_takes_an_unaligned_flow(dev):
    """K6 and K6 local on a flow 4 but not 8 bytes aligned (a view one
    float into its storage): the per-value loads, the same arithmetic."""
    from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

    gen = torch.Generator(device=dev).manual_seed(4)
    n, h, w = 1, 40, 200
    a = torch.rand((n, h, w, 3), generator=gen, device=dev)
    base = torch.empty(n * h * w * 2 + 1, device=dev)
    fl = base[1:].view(n, h, w, 2)
    fl.copy_(_flow(gen, n, h, w, 6.0, dev))
    assert fl.data_ptr() % 8 == 4
    coord = K6.resample_coord(h, w)
    close = lambda g, r: bool(((g - r).abs() <= 1e-5 + 1e-5 * r.abs()).all())
    assert close(K6.gather_region(a, fl, 8, 8, coord),
                 K6.gather_region_plain(a, fl, 8, 8, coord))
    off = tile_flow_offsets(fl, 128, 128, 24, 0).off_src
    assert close(K6.gather_region_local(a, fl, off, 8, 64, 24, 0, coord),
                 K6.gather_region_plain(a, fl, 8, 64, coord, off_src=off))


def test_softsplat_region_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    img = torch.rand((1, 436, 1024, 3), generator=gen, device=dev)
    fl = _flow(gen, 1, 436, 1024, 40.0, dev)
    metric = -torch.rand((1, 436, 1024, 1), generator=gen, device=dev)
    soft, cov = K5.softsplat_region_with_coverage(img, fl, metric, 64, 128)
    cat = torch.cat([img * metric.exp(), metric.exp(),
                     torch.ones_like(metric)], -1)
    ref = K5.splat_region_plain(cat, fl, 64, 128)
    assert ((cov - ref[..., -1:]).abs() <= 1e-5 + 1e-5 * ref[..., -1:].abs()
            ).all()
    den = ref[..., 3:4]
    want = torch.where(den != 0, ref[..., :3] / torch.where(den == 0, 1.0,
                                                            den), 0.0)
    assert (soft - want).abs().max().item() <= 1e-4


def test_windowed_kernels_refuse_what_they_cannot_take(dev):
    a = torch.rand((1, 8, 8, 3), device=dev)
    fl = torch.zeros((1, 8, 8, 2), device=dev)
    with pytest.raises(ValueError):
        K6.resample2d_region(a.transpose(1, 2), fl, 8, 8)
    with pytest.raises(ValueError):
        K5.splat_region(a, fl.cpu(), 8, 8)
    with pytest.raises(TypeError):
        K5.splat_region(a.half(), fl, 8, 8)


@pytest.mark.parametrize("shape,c,bounds,amp", [
    ((2, 40, 50), 3, (8, 8), 5.0),         # in the window
    ((1, 200, 300), 5, (8, 8), 20.0),      # beyond it: the drop rule
    ((1, 436, 1024), 5, (64, 128), 90.0),  # the flow path's shape
    ((1, 130, 260), 3, (13, 70), 0.0),     # zero flow: dhat(0) = dhat(1) = 0
])
def test_gather_grads_kernel_matches_plain(dev, shape, c, bounds, amp):
    gen = torch.Generator(device=dev).manual_seed(4)
    n, h, w = shape
    a = torch.rand((n, h, w, c), generator=gen, device=dev)
    q = torch.randn((n, h, w, c), generator=gen, device=dev)
    fl = (_flow(gen, n, h, w, amp, dev) if amp
          else torch.zeros((n, h, w, 2), device=dev))
    K6.reset_launch_counts()
    for coord in (K6.resample_coord(h, w), K6.RAW):
        got = K6.gather_region_grads(a, fl, q, *bounds, coord)
        ref = K6.gather_region_grads_plain(a, fl, q, *bounds, coord)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert ((g - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()
        if not amp and coord == K6.RAW:
            assert not got[1].any() and not got[2].any()
    assert K6.launch_counts() == {"gather_region": 0,
                                  "gather_region_grads": 2,
                                  "gather_region_local": 0,
                                  "gather_region_local_grads": 0}


def test_windowed_functions_backward_on_the_card(dev):
    """The Functions' backward on CUDA tensors against the CPU's plain
    versions, and the launches they make."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, h, w = 1, 130, 260
    img = torch.rand((n, h, w, 3), generator=gen, device=dev)
    v = torch.rand((n, h, w, 5), generator=gen, device=dev)
    fl = _flow(gen, n, h, w, 6.0, dev)
    wgt = torch.randn((n, h, w, 5), generator=gen, device=dev)
    grads = {}
    for d in (dev, torch.device("cpu")):
        K5.reset_launch_counts()
        K6.reset_launch_counts()
        i_, v_, f_ = (t.to(d).clone().requires_grad_() for t in (img, v, fl))
        loss = ((K6.resample2d_region(i_, f_, 16, 16) * wgt[..., :3].to(d)
                 ).sum() + (K5.splat_region(v_, f_, 16, 16) * wgt.to(d)).sum())
        loss.backward()
        grads[d.type] = [t.grad.cpu() for t in (i_, v_, f_)]
        if d.type == "cuda":
            torch.cuda.synchronize()
            # forward K6 + K5; backward 2 K6 grads and the image's K5 splat
            assert K6.launch_counts() == {"gather_region": 1,
                                          "gather_region_grads": 2,
                                          "gather_region_local": 0,
                                          "gather_region_local_grads": 0}
            assert K5.launch_counts() == {"splat_region": 2,
                                          "splat_region_local": 0}
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert ((g - r).abs() <= 1e-4 + 1e-4 * r.abs()).all()


@pytest.mark.parametrize("kind,n,widths", [
    ("rbf", 5000, (64, 32, 32, 4)),        # ragged last tile
    ("ff", 4096, (128, 64, 4)),
    ("rbf", 446_464, (512, 256, 256, 256, 4)),   # the flow path's shape
    ("rbf", 333, (36, 20, 20, 3)),         # widths that are not multiples of 8
    # three row chunks of the staged kernel (at most 32,768 rows each), N no
    # multiple of its 32-row tile or 128-row product tile, H no multiple of
    # its 64-column tile, O of 8
    ("ff", 70_001, (64, 48, 48, 5)),
])
def test_inr_backward_kernel_matches_plain(dev, kind, n, widths):
    gen = torch.Generator(device=dev).manual_seed(6)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    e = widths[0]
    if kind == "rbf":
        enc = {"centres": torch.rand((e, 3), generator=gen, device=dev) * 2 - 1,
               "sigma": rand(e).abs() * 3 + 1}
    else:
        enc = {"frequencies": rand(3, e // 2) * 4}
    layers = [(rand(a, b) / a ** 0.5, rand(b) * 0.1)
              for a, b in zip(widths[:-1], widths[1:])]
    x = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
    mask = torch.rand(e, generator=gen, device=dev)
    g = 1e-3 * (0.5 + rand(n, widths[-1]))
    K7.reset_launch_counts()
    for bf16 in (False, True):
        got = K7.fused_inr_backward(kind, enc, layers, x, mask, g, bf16)
        again = K7.fused_inr_backward(kind, enc, layers, x, mask, g, bf16)
        ref = K7.fused_inr_backward_plain(kind, enc, layers, x, mask, g, bf16)
        torch.cuda.synchronize()
        for pg, pa, pr in zip(got, again, ref):
            for a_, b_, r_ in zip(pg, pa, pr):
                assert torch.equal(a_, b_)
                assert (a_ - r_).abs().max() <= 1e-3 * r_.abs().max()
    assert K7.launch_counts() == {"fused_inr_forward": 0,
                                  "fused_inr_backward": 4}


def test_inr_backward_kernel_refuses_what_it_cannot_take(dev):
    x = torch.rand((64, 3), device=dev)
    enc = {"centres": torch.rand((30, 3), device=dev),
           "sigma": torch.ones(30, device=dev)}
    layers = [(torch.rand((30, 16), device=dev), torch.rand(16, device=dev)),
              (torch.rand((16, 4), device=dev), torch.rand(4, device=dev))]
    with pytest.raises(ValueError, match="multiples of 4"):     # E = 30
        K7.fused_inr_backward("rbf", enc, layers, x,
                              torch.ones(30, device=dev),
                              torch.rand((64, 4), device=dev))


def test_inr_apply_refuses_widths_the_kernel_cannot_take(dev):
    """Through the model: ``use_kernel="auto"`` on the card raises in the
    forward for a net the kernel cannot take, launches nothing, and does
    not take autograd by itself; ``use_kernel="off"`` trains it."""
    import dataclasses

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.models.inr import build_inr, inr_apply

    x = torch.rand((64, 3), device=dev) * 2 - 1
    for widths, why in ((dict(hidden_dim=512), "shared memory"),
                        (dict(num_frequencies=64, hidden_dim=18),
                         "multiples of 4")):
        cfg = FlowConfig(device="cuda", **widths)
        spec, params, consts = build_inr(R.root_generator(3), "RBF", cfg, dev)
        for l in params["mlp"]:
            l["w"].requires_grad_()
        K7.reset_launch_counts()
        with pytest.raises(ValueError, match=f"{why}.*use-kernel off"):
            inr_apply(spec, params, consts, x)
        off = inr_apply(dataclasses.replace(spec, use_kernel="off"), params,
                        consts, x)
        off.sum().backward()
        assert all(l["w"].grad is not None for l in params["mlp"])
        assert K7.launch_counts() == {"fused_inr_forward": 0,
                                      "fused_inr_backward": 0}


def test_flow_train_step_kernel_route_matches_autograd(dev):
    """One train step's parameter gradients at a small frame: the kernel
    route (K7 backward, K5 local and K6 local at local dy 8) against
    ``use_kernel="off"`` (autograd through the plain INR and the windowed
    forms, no kernel)."""
    import dataclasses

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inr import flat_leaves
    from sin_inn_tpu_torch.train import flow as FT

    cfg = FlowConfig(device="cuda", num_frequencies=64, hidden_dim=64,
                     splat_max_dy=16, splat_max_dx=16)
    spec, state, consts = FT.create_flow_state(R.root_generator(7), cfg)
    vid = torch.from_numpy(moving_texture_video(2, 136, 200, seed=1)).to(dev)
    batch = {"frame1": vid[0:1], "frame2": vid[1:2],
             "times": torch.tensor([0.0], device=dev), "scale": 40.0}
    leaves = [t for _, t in flat_leaves(state.params)]
    grads = []
    for kind in ("auto", "off"):
        sp = dataclasses.replace(spec, use_kernel=kind)
        for t in leaves:
            t.grad = None
        for mod in (K5, K6, K7):
            mod.reset_launch_counts()
        loss, aux = FT.flow_loss(sp, cfg.replace(use_kernel=kind),
                                 state.params, consts, batch)
        loss.backward()
        torch.cuda.synchronize()
        grads.append([t.grad.clone() for t in leaves])
        on = int(kind == "auto")
        assert ("flow_dev_y" in aux) == bool(on)
        assert K5.launch_counts() == {"splat_region": 0,
                                      "splat_region_local": 2 * on}
        assert K6.launch_counts() == {"gather_region": 0,
                                      "gather_region_grads": 0,
                                      "gather_region_local": 2 * on,
                                      "gather_region_local_grads": 4 * on}
        assert K7.launch_counts() == {"fused_inr_forward": 0,
                                      "fused_inr_backward": on}
    for a, b in zip(*grads):
        assert (a - b).norm() <= 1e-3 * b.norm()


@pytest.mark.parametrize("shape,c,bounds,caps,detail", [
    ((1, 136, 160), 3, (8, 18), (24, 0), 2.0),      # in the local window
    ((1, 200, 300), 5, (8, 64), (24, 0), 12.0),     # beyond it
    ((1, 436, 1024), 5, (32, 128), (64, 0), 30.0),  # the flow path's shape
    ((2, 136, 300), 3, (16, 64), (64, 128), 2.0),   # column offsets
    ((2, 45, 301), 3, (8, 64), (24, 0), 5.0),       # no multiple of the
    ((1, 37, 260), 5, (8, 18), (24, 0), 2.0),       # block or of 8 rows
])
def test_local_window_kernels_match_plain(dev, shape, c, bounds, caps,
                                          detail):
    """K5 local, K6 local and K6 local grads against their plain versions
    on the same offsets, with launch counts."""
    from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

    gen = torch.Generator(device=dev).manual_seed(9)
    n, h, w = shape
    fl = _flow(gen, n, h, w, detail, dev)
    fl = fl + torch.tensor([110.0 if caps[1] else -15.0, 20.0], device=dev)
    offs = tile_flow_offsets(fl, 128, 128, *caps)
    a = torch.rand((n, h, w, c), generator=gen, device=dev)
    q = torch.randn((n, h, w, c), generator=gen, device=dev)
    K5.reset_launch_counts()
    K6.reset_launch_counts()
    close = lambda g, r: bool(((g - r).abs() <= 1e-5 + 1e-5 * r.abs()).all())
    got = K5.splat_region_local(a, fl, offs.off_out, offs.off_src, *bounds)
    ref = K5.splat_region_local_plain(a, fl, offs.off_out, *bounds)
    torch.cuda.synchronize()
    assert close(got, ref)
    for coord in (K6.resample_coord(h, w), K6.RAW):
        got = K6.gather_region_local(a, fl, offs.off_src, *bounds, *caps,
                                     coord)
        ref = K6.gather_region_plain(a, fl, *bounds, coord,
                                     off_src=offs.off_src)
        assert close(got, ref)
        got = K6.gather_region_local_grads(a, fl, q, offs.off_src, *bounds,
                                           coord)
        ref = K6.gather_region_grads_plain(a, fl, q, *bounds, coord,
                                           off_src=offs.off_src)
        torch.cuda.synchronize()
        assert all(close(g, r) for g, r in zip(got, ref))
    assert K5.launch_counts() == {"splat_region": 0, "splat_region_local": 1}
    assert K6.launch_counts() == {"gather_region": 0,
                                  "gather_region_grads": 0,
                                  "gather_region_local": 2,
                                  "gather_region_local_grads": 2}


def test_local_window_functions_backward_on_the_card(dev):
    """The local Functions' backward on CUDA tensors against the CPU's plain
    versions: K6 local grads for the flows, K5 local (with the effective
    displacement's own offsets) for the image."""
    from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

    gen = torch.Generator(device=dev).manual_seed(10)
    n, h, w = 1, 136, 200
    img = torch.rand((n, h, w, 3), generator=gen, device=dev)
    v = torch.rand((n, h, w, 5), generator=gen, device=dev)
    fl = _flow(gen, n, h, w, 4.0, dev) + torch.tensor([0.0, 20.0],
                                                      device=dev)
    wgt = torch.randn((n, h, w, 5), generator=gen, device=dev)
    grads = {}
    for d in (dev, torch.device("cpu")):
        K5.reset_launch_counts()
        K6.reset_launch_counts()
        i_, v_, f_ = (t.to(d).clone().requires_grad_() for t in (img, v, fl))
        offs = tile_flow_offsets(f_, 128, 128, 24, 0)
        loss = ((K6.resample2d_region_local(i_, f_, offs.off_src, 8, 16, 24,
                                            0) * wgt[..., :3].to(d)).sum()
                + (K5.splat_region_local(v_, f_, offs.off_out, offs.off_src,
                                         8, 16) * wgt.to(d)).sum())
        loss.backward()
        grads[d.type] = [t.grad.cpu() for t in (i_, v_, f_)]
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert K6.launch_counts() == {"gather_region": 0,
                                          "gather_region_grads": 0,
                                          "gather_region_local": 1,
                                          "gather_region_local_grads": 2}
            assert K5.launch_counts() == {"splat_region": 0,
                                          "splat_region_local": 2}
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert ((g - r).abs() <= 1e-4 + 1e-4 * r.abs()).all()


# ---------------------------------------------------------------------------
# K7 forward, and K7 backward in the per-point mask modes and with the
# coordinate rows of a progressive net
# ---------------------------------------------------------------------------

def _prog_net(gen, dev, kind, e, hidden, n_hidden, out=4, d=3):
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    if kind == "rbf":
        enc = {"centres": torch.rand((e, d), generator=gen, device=dev) * 2 - 1,
               "sigma": rand(e).abs() * 3 + 1}
    else:
        enc = {"frequencies": rand(d, e // 2) * 4}
    widths = [e + d] + [hidden] * n_hidden + [out]
    layers = [(rand(a, b) / a ** 0.5, rand(b) * 0.1)
              for a, b in zip(widths[:-1], widths[1:])]
    return enc, layers


def _masks(gen, dev, mode, rows, w, res, e, d=3):
    """A seeded mask of the mode with values in [0, 1], and its dense (n,
    d + E) form."""
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    if mode == "const":
        m = u(d + e)
        return m, m[None].expand(rows * w, -1)
    if mode == "point":
        mc, me = u(d, rows * w), u(rows * w, e)
        return (mc, me), torch.cat([mc.t(), me], -1)
    # hat-like weights: a few non-zero columns per row of wx
    wx = torch.zeros((w, res), device=dev)
    centre = torch.linspace(1, res - 2, w, device=dev)
    for off in (-1, 0, 1):
        j = (centre.long() + off).clamp(0, res - 1)
        wx[torch.arange(w, device=dev), j] += u(w) / 3
    se, sc = u(rows, res, e), u(rows, res, d)
    dense = torch.cat([torch.einsum("wr,SrD->SwD", wx, sc).reshape(-1, d),
                       torch.einsum("wr,SrE->SwE", wx, se).reshape(-1, e)], -1)
    return (se, sc, wx), dense


@pytest.mark.parametrize("kind,mode,rows,w,res,widths", [
    ("ff", "const", 5, 37, 0, (64, 32, 2)),          # ragged last tile
    ("rbf", "const", 3, 64, 0, (36, 20, 1)),
    ("ff", "point", 7, 45, 0, (64, 32, 2)),          # ragged last tile
    ("rbf", "point", 4, 64, 0, (128, 64, 3)),
    ("ff", "slab", 6, 64, 5, (64, 32, 2)),
    ("rbf", "slab", 3, 96, 34, (36, 20, 1)),
    ("ff", "slab", 436, 1024, 50, (512, 256, 3)),    # the flow path's shape
    # three row chunks of the staged backward: a ragged N, and a chunk
    # boundary inside an image row of the slabs
    ("ff", "point", 67, 1001, 0, (64, 32, 2)),
    ("rbf", "slab", 70, 1024, 8, (64, 32, 2)),
])
def test_inr_kernels_match_plain_in_every_mask_mode(dev, kind, mode, rows, w,
                                                    res, widths):
    """K7 forward within 1e-4 + 1e-4 |plain| (sums over up to 515 channels
    in another order), K7 backward with every leaf, the coordinate rows
    among them, within 1e-3 of its largest |plain| and bitwise repeatable;
    fp32 and bf16 operands. The plain version with the factored mask agrees
    with the dense mask through autograd."""
    gen = torch.Generator(device=dev).manual_seed(12)
    e, hidden, n_hidden = widths
    enc, layers = _prog_net(gen, dev, kind, e, hidden, n_hidden)
    n = rows * w
    x = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
    mask, dense = _masks(gen, dev, mode, rows, w, res, e)
    g = 1e-3 * (0.5 + torch.randn((n, 4), generator=gen, device=dev))
    K7.reset_launch_counts()
    for bf16 in (False, True):
        out = K7.fused_inr_forward(kind, enc, layers, x, mask, bf16)
        twice = K7.fused_inr_forward(kind, enc, layers, x, mask, bf16)
        ref = K7.fused_inr_forward_plain(kind, enc, layers, x, mask, bf16)
        torch.cuda.synchronize()
        tol = 1e-4 if not bf16 else 2e-2     # bf16: ties broken elsewhere
        assert ((out - ref).abs() <= tol + tol * ref.abs()).all()
        assert torch.equal(out, twice)
        if not bf16:     # 3xTF32: fp32's accuracy (one-pass TF32: ~1e-4)
            assert (out - ref).norm() <= 1e-5 * ref.norm()
        got = K7.fused_inr_backward(kind, enc, layers, x, mask, g, bf16)
        again = K7.fused_inr_backward(kind, enc, layers, x, mask, g, bf16)
        want = K7.fused_inr_backward_plain(kind, enc, layers, x, mask, g,
                                           bf16)
        torch.cuda.synchronize()
        for pg, pa, pr in zip(got, again, want):
            for a_, b_, r_ in zip(pg, pa, pr):
                assert a_.shape == r_.shape and torch.equal(a_, b_)
                assert (a_ - r_).abs().max() <= 1e-3 * r_.abs().max()
    assert K7.launch_counts() == {"fused_inr_forward": 4,
                                  "fused_inr_backward": 4}
    if n > 100_000:
        return
    # the dense mask through autograd
    leaves = [t.clone().requires_grad_() for pair in layers for t in pair]
    code = torch.cat([x, K7.encode(kind, enc, x, 1.0)], -1) * dense
    h = code
    for i in range(0, len(leaves), 2):
        h = h @ leaves[i] + leaves[i + 1]
        if i < len(leaves) - 2:
            h = torch.relu(h)
    ref = K7.fused_inr_forward_plain(kind, enc, layers, x, mask)
    assert ((h - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()
    (h * g).sum().backward()
    want = K7.fused_inr_backward_plain(kind, enc, layers, x, mask, g)
    for leaf, r_ in zip(leaves, [t for pair in want for t in pair]):
        assert (leaf.grad - r_).abs().max() <= 1e-3 * r_.abs().max()


def test_fused_inr_function_runs_the_forward_kernel_for_slabs(dev):
    """The Function: K7 forward as the primal of the slab mode (with and
    without gradients), the plain forward for a constant mask; one K7
    backward either way."""
    gen = torch.Generator(device=dev).manual_seed(13)
    enc, layers = _prog_net(gen, dev, "ff", 64, 32, 2)
    x = torch.rand((4 * 64, 3), generator=gen, device=dev) * 2 - 1
    slabs, _ = _masks(gen, dev, "slab", 4, 64, 5, 64)
    vec, _ = _masks(gen, dev, "const", 4, 64, 0, 64)
    for mask, fwd in ((slabs, 1), (vec, 0)):
        leaves = [(w.clone().requires_grad_(), b.clone().requires_grad_())
                  for w, b in layers]
        K7.reset_launch_counts()
        out = K7.fused_inr("ff", enc, leaves, x, mask)
        out.sum().backward()
        torch.cuda.synchronize()
        assert K7.launch_counts() == {"fused_inr_forward": fwd,
                                      "fused_inr_backward": 1}
        assert all(w.grad.shape == w.shape for w, _ in leaves)
        with torch.no_grad():
            served = K7.fused_inr("ff", enc, leaves, x, mask)
        assert torch.equal(served, out.detach())
        assert K7.launch_counts()["fused_inr_forward"] == 2 * fwd
    with pytest.raises(ValueError, match="multiple of the 32-point tile"):
        bad, _ = _masks(gen, dev, "slab", 4, 40, 5, 64)
        K7.fused_inr_forward("ff", enc, layers, x[:4 * 40], bad)


def _sub3(gen, cin, cout, hidden, dev):
    return {k: {n: t.to(dev) for n, t in conv.items()}
            for k, conv in S.conv_subnet_init(gen, cin, cout, 3,
                                              hidden).items()}


@pytest.mark.parametrize("shape,cin,hidden", [
    ((2, 88, 160, 48), 24, 256),     # the SRF flagship's first octave
    ((2, 44, 80, 192), 96, 256),     # its second octave
    ((1, 11, 13, 20), 12, 16),       # ragged tiles in both directions
])
def test_k8_matches_plain(dev, shape, cin, hidden):
    """K8 forward and inverse within 1e-4 + 1e-4 |plain| of the plain
    version; K8 backward within 1e-4 + 1e-4 |plain| (dx) and 1e-3 of each
    leaf's largest |plain|, each beside the relu gate slack where a gate is
    within rounding of 0 (``relu_gate_slack``), bitwise the same over two
    calls."""
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = R.root_generator(shape[-1] + hidden)
    caff = shape[-1] - cin
    sub = _sub3(gen, cin, 2 * caff, hidden, dev)
    g_dev = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g_dev, device=dev)
    x_in, x_aff = x[..., caff:], x[..., :caff]
    g = torch.randn(x_aff.shape, generator=g_dev, device=dev)
    K8.reset_launch_counts()
    for inverse in (False, True):
        got = K8.half_coupling_3x3(sub, x_in, x_aff, CLAMP, inverse)
        ref = K8.half_coupling_3x3_plain(sub, x_in, x_aff, CLAMP, inverse)
        torch.cuda.synchronize()
        assert ((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()
        d1 = K8.half_coupling_3x3_backward(sub, x_in, x_aff, g, CLAMP,
                                           inverse)
        d2 = K8.half_coupling_3x3_backward(sub, x_in, x_aff, g, CLAMP,
                                           inverse)
        rd = K8.half_coupling_3x3_backward_plain(sub, x_in, x_aff, g, CLAMP,
                                                 inverse)
        # a conv1 pre-activation within 1e-5 of 0 may be gated either way:
        # dx_in and conv1's leaves may move by its term (the slack)
        sdx, sw1, sb1 = K8.relu_gate_slack(sub, x_in, x_aff, g, CLAMP,
                                           inverse)
        torch.cuda.synchronize()
        for a, b, sl in zip(d1[1:], rd[1:], (sdx, 0.0)):
            assert ((a - b).abs() <= 1e-4 + 1e-4 * b.abs() + sl).all()
        for c in ("conv1", "conv2"):
            for k in ("w", "b"):
                a, b = d1[0][c][k], rd[0][c][k]
                sl = {("conv1", "w"): sw1, ("conv1", "b"): sb1}.get((c, k), 0)
                assert a.shape == b.shape
                assert ((a - b).abs() - sl).max() <= 1e-3 * b.abs().max()
                assert torch.equal(a, d2[0][c][k])
        assert all(torch.equal(a, b) for a, b in zip(d1[1:], d2[1:]))
    assert K8.launch_counts() == {"half_coupling_3x3": 2,
                                  "half_coupling_3x3_backward": 4}


def test_k8_autograd_ops_on_the_card(dev):
    """The banded op (K8 forward and backward) and the recompute op (K8
    forward, the convolution route's backward) against autograd of the
    convolution route with TF32 off: normwise 1e-3; round trip 1e-4."""
    from sin_inn_tpu_torch.ops import coupling as C
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8

    c, len1, hidden = 48, 24, 256
    gen = R.root_generator(7)
    p = {"s1": _sub3(gen, len1, 2 * (c - len1), hidden, dev),
         "s2": _sub3(gen, c - len1, 2 * len1, hidden, dev)}
    g_dev = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, 22, 40, c), generator=g_dev, device=dev)
    subnet = lambda q, v: S.conv_subnet_apply(q, v, compute="highest")

    def grads(fn):
        q = {s: {k: {n: t.clone().requires_grad_(True)
                     for n, t in conv.items()} for k, conv in sub.items()}
             for s, sub in p.items()}
        xx = x.clone().requires_grad_(True)
        out = fn(q, xx)
        torch.sin(out).sum().backward()
        return out.detach(), [xx.grad] + [t.grad for t in K.param_leaves(q)]

    for inverse in (False, True):
        def conv_route(q, v):
            if inverse:
                return C.glow_coupling_inverse(q, v, subnet, CLAMP, len1)
            return C.glow_coupling_forward(q, v, subnet, CLAMP, len1)[0]
        ref, rg = grads(conv_route)
        for ops, counts in (
                (K8.make_fused_coupling3_banded(CLAMP, len1), (2, 2)),
                (K8.make_fused_coupling3(CLAMP, len1, "highest"), (2, 0))):
            K8.reset_launch_counts()
            out, og = grads(ops[int(inverse)])
            torch.cuda.synchronize()
            assert K8.launch_counts() == {
                "half_coupling_3x3": counts[0],
                "half_coupling_3x3_backward": counts[1]}
            assert ((out - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()
            for a, b in zip(og, rg):
                assert (a - b).norm() <= 1e-3 * b.norm()
    fwd, inv = K8.make_fused_coupling3_banded(CLAMP, len1)
    with torch.no_grad():
        assert (inv(p, fwd(p, x)) - x).abs().max() <= 1e-4


def test_k8_refuses_what_it_cannot_take(dev):
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8

    gen = R.root_generator(3)
    x = torch.randn((1, 8, 8, 16), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        K8.half_coupling_3x3(_sub3(gen, 10, 12, 16, dev), x[..., :10],
                             x[..., 10:], CLAMP)
    with pytest.raises(ValueError, match="float32"):
        sub = _sub3(gen, 8, 16, 16, dev)
        K8.half_coupling_3x3(sub, x[..., :8].double(), x[..., 8:].double(),
                             CLAMP)
    with pytest.raises(ValueError, match="shared memory"):
        K8.half_coupling_3x3(_sub3(gen, 8, 16, 4096, dev), x[..., :8],
                             x[..., 8:], CLAMP)
