"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a machine with the card and nvcc:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Tolerance for fp32 storage: 1e-4 + 1e-4 |plain| (sums over the hidden width
in another order, atanf against torch.atan); bf16 storage: one bf16
rounding step. Weight and bias gradients of the backward kernels: 1e-3 of
the largest |plain| of each (sums over all rows in another order). The
windowed splat (K5) and gather (K6): 1e-5 + 1e-5 |plain| (K5 sums with
atomics in a run-dependent order; K6 repeats the plain arithmetic).
"""

import pytest
import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.ops import subnet as S
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.cuda import gather as K6
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


def test_kernel_round_trip(dev):
    p = _params(48, 24, 256, dev)
    x = torch.randn((4, 16, 16, 48), device=dev)
    with torch.inference_mode():
        back = K.fused_glow_inverse_1x1(
            p, K.fused_glow_forward_1x1(p, x, CLAMP, 24), CLAMP, 24)
    assert (back - x).abs().max().item() <= 1e-4


def _assert_grads_close(got, ref, dx, dx_ref, step):
    for a, b in zip(K.param_leaves(got), K.param_leaves(ref)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()
    dx, dx_ref = dx.float(), dx_ref.float()
    assert ((dx - dx_ref).abs() <= 1e-4 + step * dx_ref.abs()).all()


@pytest.mark.parametrize("shape,len1,hidden", [
    ((2, 9, 13, 48), 24, 256),     # ragged last tile
    ((1, 5, 7, 192), 96, 256),
    ((3, 4, 5, 12), 5, 32),        # uneven split, narrow hidden
    ((4, 44, 80, 48), 24, 256),    # many tiles per block
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain(dev, shape, len1, hidden, dtype):
    p = _params(shape[-1], len1, hidden, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    step = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    K.reset_launch_counts()
    for fn, plain in ((K.fused_glow_backward_1x1,
                       K.fused_glow_backward_1x1_plain),
                      (K.fused_glow_inverse_backward_1x1,
                       K.fused_glow_inverse_backward_1x1_plain)):
        dp, dx = fn(p, x, g, CLAMP, len1)
        rp, rx = plain(p, x, g, CLAMP, len1)
        torch.cuda.synchronize()
        assert dx.dtype == dtype
        _assert_grads_close(dp, rp, dx, rx, step)
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
    _assert_grads_close(got, rp, x.grad, rx, 1e-4)


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
    assert K6.launch_counts() == {"gather_region": 2}
    assert K5.launch_counts() == {"splat_region": 1}


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
