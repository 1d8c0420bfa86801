"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a machine with the card and nvcc:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Tolerance for fp32 storage: 1e-4 + 1e-4 |plain| (sums over the hidden width
in another order, atanf against torch.atan); bf16 storage: one bf16
rounding step. Weight and bias gradients of the backward kernels: 1e-3 of
the largest |plain| of each (sums over all rows in another order).
"""

import pytest
import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.ops import subnet as S
from sin_inn_tpu_torch.ops.cuda import coupling as K

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
