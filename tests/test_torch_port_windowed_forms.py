"""The windowed forms of the warp and the splat (``use_kernel="off"`` with
window bounds) held against the JAX package's ``resample2d_windowed`` and
``softsplat_windowed_with_coverage`` / ``splat_windowed`` (with their
hand-derived backwards) on the CPU: values and the gradients of both
arguments, on flows inside the windows and beyond them (the drop rules run),
with and without the column window, and at integer flows, where every tap
lies on a pixel centre and autograd must give the one-sided derivative of
the reference's backward.

Tolerances: 1e-5 for values and gradients (fp32, sums in another order; the
warp's coordinate is one fused multiply-add in both), except the flow
gradient of the normalised softmax splat, held normwise to 1e-4 (its
division by splatted weights amplifies rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops import splat as JS
from sin_inn_tpu.ops import warp as JW
from sin_inn_tpu_torch.ops import splat as TS
from sin_inn_tpu_torch.ops import warp as TW
from torch_port_helpers import one_torch_thread  # noqa: F401

N, H, W = 2, 24, 40


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flow(seed, amp, integer=False):
    rng = np.random.RandomState(seed)
    if integer:
        return rng.randint(-amp, amp + 1, (N, H, W, 2)).astype(np.float32)
    ys = np.linspace(0, 1, H)[None, :, None]
    xs = np.linspace(0, 1, W)[None, None, :]
    f = lambda a, b: amp * np.sin(2 * np.pi * (a * xs + b * ys)
                                  + rng.uniform(0, 6))
    ones = np.ones((N, 1, 1))
    return (np.stack([f(1, .5) * ones, f(.5, 1) * ones], -1)
            + 0.1 * rng.randn(N, H, W, 2)).astype(np.float32)


# (flow amplitude, integer flow, max_dy, max_dx); amplitude 9 leaves the
# 4 px windows, amplitude 2 stays inside
FLOWS = {"inside": (2.0, False), "beyond": (9.0, False),
         "integer": (3, True)}
WINDOWS = {"rows": (4, None), "both": (4, 4)}


def _grads(jfn, tfn, a, fl, wgt):
    """Values and the gradients of sum(out * wgt) in both arguments."""
    jout, vjp = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(fl))
    ja, jf = vjp(jnp.asarray(wgt))
    ta, tf = _t(a).requires_grad_(), _t(fl).requires_grad_()
    tout = tfn(ta, tf)
    (tout * _t(wgt)).sum().backward()
    return ((tout.detach(), jout), (ta.grad, ja), (tf.grad, jf))


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("flow", list(FLOWS))
def test_resample2d_windowed_matches_jax(flow, window):
    amp, integer = FLOWS[flow]
    dy, dx = WINDOWS[window]
    rng = np.random.RandomState(1)
    img = rng.rand(N, H, W, 3).astype(np.float32)
    wgt = rng.randn(N, H, W, 3).astype(np.float32)
    fl = _flow(2, amp, integer)
    pairs = _grads(
        lambda i, f: JW.resample2d_windowed(i, f, dy, 8, dx, 16),
        lambda i, f: TW.resample2d_windowed(i, f, dy, 8, dx, 16),
        img, fl, wgt)
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if flow == "beyond":
        exact = TW.resample2d(_t(img), _t(fl)).numpy()
        assert np.abs(exact - pairs[0][0].numpy()).max() > 0.1


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("flow", list(FLOWS))
def test_splat_windowed_matches_jax(flow, window):
    amp, integer = FLOWS[flow]
    dy, dx = WINDOWS[window]
    rng = np.random.RandomState(3)
    v = rng.rand(N, H, W, 4).astype(np.float32)
    wgt = rng.randn(N, H, W, 4).astype(np.float32)
    fl = _flow(4, amp, integer)
    pairs = _grads(
        lambda a, f: JS.splat_windowed(a, f, dy, 2, max_dx=dx, col_chunk=16),
        lambda a, f: TS.splat_windowed(a, f, dy, 2, dx, 16),
        v, fl, wgt)
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if flow == "beyond":
        exact = TS.splat_scatter(_t(v), _t(fl)).numpy()
        assert np.abs(exact - pairs[0][0].numpy()).max() > 0.1


@pytest.mark.parametrize("flow", ["inside", "beyond"])
def test_softsplat_windowed_with_coverage_matches_jax(flow):
    amp, integer = FLOWS[flow]
    rng = np.random.RandomState(5)
    img = rng.rand(N, H, W, 3).astype(np.float32)
    metric = -rng.rand(N, H, W, 1).astype(np.float32)
    fl = _flow(6, amp, integer)
    wgt = rng.randn(N, H, W, 3).astype(np.float32)

    def jfn(i, f):
        return JS.softsplat_windowed_with_coverage(i, f, jnp.asarray(metric),
                                                   4, 2)

    (js, jc), vjp = jax.vjp(jfn, jnp.asarray(img), jnp.asarray(fl))
    ji, jf = vjp((jnp.asarray(wgt), jnp.zeros_like(jc)))
    ti, tf = _t(img).requires_grad_(), _t(fl).requires_grad_()
    ts, tc = TS.softsplat_windowed_with_coverage(ti, tf, _t(metric), 4, 2)
    assert not tc.requires_grad
    (ts * _t(wgt)).sum().backward()
    for got, ref in ((ts.detach(), js), (tc, jc), (ti.grad, ji)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the flow gradient passes through num / den with den the splatted
    # weights, some of them slivers of a tap: 1/den^2 amplifies rounding of
    # the sums (the JAX windowed and exact forms differ by 5e-5 here), so it
    # is held normwise
    jf = np.asarray(jf)
    assert np.linalg.norm(tf.grad.numpy() - jf) <= 1e-4 * np.linalg.norm(jf)
