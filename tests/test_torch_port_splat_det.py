"""K5's fixed-point sums (``csrc/splat_region.cu``) modelled on the CPU and
held against the JAX package's Pallas splat kernel (``_region_kernel``) in
interpret mode and against the port's plain versions, in the static and the
local form.

The kernel adds each contribution v wr wk (fp32, as the plain version forms
it) as an integer at the scale 2^q_c of its channel, q_c = 62 - e with
SH SW max|v_c| < 2^e, with 64-bit integer atomics, and converts each sum
once to fp32. ``tests/torch_port_helpers.py`` ``splat_fixed_point`` does the
same arithmetic with int64 ``index_add_``; the card test
(``tests/test_torch_port_cuda.py``) holds the kernel to it bit for bit.

Tolerances, each with its reason:
* against the Pallas kernel and the plain versions: the card's
  1e-5 + 1e-5 |ref| (fp32 sums in another order on their side; the model's
  fixed point resolves 2^-q_c, about 3e-14 max|v_c| at these windows);
* under a permutation of the source pixels: bitwise the same (integer
  sums do not depend on the order; an fp32 sum does);
* the largest value at its window's bound: no int64 sum reaches 2^62, and
  the pixel that sums every source is within fp32's rounding of the exact
  sum;
* a value that is Inf or NaN: NaN and Inf at exactly the plain version's
  pixels, with its signs, and the finite pixels within 1e-5 + 1e-5 |plain|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops.pallas import offsets as JO
from sin_inn_tpu.ops.pallas import splat as JS
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from sin_inn_tpu_torch.ops.splat import _hat
from torch_port_helpers import k5_local_model, k5_model


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(got - ref)
    assert np.isfinite(err).all()
    assert (err <= 1e-5 + 1e-5 * np.abs(ref)).all(), err.max()
    return err.max()


def _smooth_flow(n, h, w, amp, seed):
    """A seeded smooth flow of +-``amp`` px (targets off integers)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 6, 2)
        out.append(np.stack([amp * np.sin(xx / 23.0 + yy / 17.0 + ph[0]),
                             amp * np.cos(xx / 13.0 - yy / 29.0 + ph[1])],
                            -1) + 0.0371)
    return np.stack(out).astype(np.float32)


def _softsplat_values(n, h, w, seed):
    """What the flow path splats: [frame exp(-20 m), exp(-20 m), ones]."""
    rng = np.random.RandomState(seed)
    frame = rng.rand(n, h, w, 3).astype(np.float32)
    e = np.exp(-20.0 * rng.rand(n, h, w, 1)).astype(np.float32)
    return np.concatenate([frame * e, e, np.ones_like(e)], -1)


# (n, h, w), flow amplitude, bounds: in the window, beyond it (the drop
# rule), unpadded bounds on a ragged image
STATIC = {
    "inside": ((1, 136, 160), 5.0, (8, 8)),
    "beyond": ((1, 200, 300), 20.0, (8, 8)),
    "ragged": ((2, 130, 260), 30.0, (13, 70)),
}


@pytest.mark.parametrize("name", list(STATIC))
def test_static_model_matches_pallas_kernel_and_plain(name):
    (n, h, w), amp, (dy, dx) = STATIC[name]
    v = _softsplat_values(n, h, w, seed=len(name))
    fl = _smooth_flow(n, h, w, amp, seed=h)
    ref = JS._splat_region_call(jnp.asarray(v), jnp.asarray(fl), dy, dx, True)
    got = k5_model(_t(v), _t(fl), dy, dx).numpy()
    err = _close(got, ref)
    _close(got, TK5.splat_region_plain(_t(v), _t(fl), dy, dx).numpy())
    print(f"\nK5 model against the Pallas kernel ({name}): {err:.3e}")


# (shape, detail, drift_x, loc_dy, loc_dx, cap_y, cap_x), as in
# test_torch_port_local_windows.py
LOCAL = {
    "inside": ((1, 136, 160), 2.0, -15.0, 8, 18, 24, 0),
    "beyond": ((1, 200, 300), 12.0, -15.0, 8, 64, 24, 0),
    "columns": ((1, 136, 300), 2.0, 110.0, 16, 64, 64, 128),
}


def _local_flow(n, h, w, detail, drift_x, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 6, 2)
        base = np.stack([drift_x + 0.0371 + 6.0 * xx / w,
                         20.0371 + 3.0 * yy / h], -1)
        wave = np.stack([np.cos(xx / 17.0 + yy / 21.0 + ph[0]),
                         np.sin(xx / 19.0 - yy / 15.0 + ph[1])], -1)
        out.append(base + detail * 0.97123 * wave)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("name", list(LOCAL))
def test_local_model_matches_pallas_kernel_and_plain(name):
    (n, h, w), detail, drift_x, ldy, ldx, capy, capx = LOCAL[name]
    fl = _local_flow(n, h, w, detail, drift_x, seed=3)
    v = _softsplat_values(n, h, w, seed=4)
    offs = JO.tile_flow_offsets(jnp.asarray(fl), 128, 128, capy, capx)
    ref = JS._splat_region_call_local(jnp.asarray(v), jnp.asarray(fl),
                                      offs.off_out, ldy, ldx, capy, capx,
                                      True)
    off = _t(offs.off_out)
    got = k5_local_model(_t(v), _t(fl), off, ldy, ldx).numpy()
    err = _close(got, ref)
    _close(got, TK5.splat_region_local_plain(_t(v), _t(fl), off, ldy,
                                             ldx).numpy())
    print(f"\nK5 local model against the Pallas kernel ({name}): {err:.3e}")


@pytest.mark.parametrize("local", [False, True])
def test_fixed_point_sum_does_not_depend_on_the_order(local):
    """The model's contributions added in random orders of the source
    pixels: the same bits every time."""
    n, h, w = 1, 136, 160
    v = _t(_softsplat_values(n, h, w, seed=7))
    fl = _smooth_flow(n, h, w, 3.0, seed=8)
    if local:
        off = _t(JO.tile_flow_offsets(jnp.asarray(fl), 128, 128, 8,
                                      0).off_out)
        run = lambda order: k5_local_model(v, _t(fl), off, 4, 8, order)
    else:
        run = lambda order: k5_model(v, _t(fl), 8, 8, order)
    want = run(None)
    rng = np.random.RandomState(9)
    for _ in range(3):
        got = run(torch.from_numpy(rng.permutation(n * h * w)))
        assert torch.equal(got, want)
    _close(want.numpy(), (TK5.splat_region_local_plain(v, _t(fl), off, 4, 8)
                          if local else
                          TK5.splat_region_plain(v, _t(fl), 8, 8)).numpy())


def test_scale_rule_at_the_largest_value():
    """Every source of a window on one pixel at the largest |v|: the int64
    sum stays under 2^62 and the result is fp32's rounding of the exact sum;
    a channel of all zeros and one of huge values take their own scales."""
    # 64 x 128 sources, every flow onto pixel (40, 70) exactly (weight 1);
    # the windows (dy 64, dx 128: SH x SW = 256 x 384) hold them all
    h, w = 64, 128
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fl = np.stack([70.0 - xs, 40.0 - ys], -1)[None].astype(np.float32)
    big = np.float32(3.0e38 / (h * w))       # the sum stays finite
    v = np.zeros((1, h, w, 3), np.float32)
    v[..., 0] = 1.0
    v[..., 2] = big
    got = k5_model(_t(v), _t(fl), 64, 128)
    assert got[0, 40, 70, 0].item() == h * w
    assert got[0, 40, 70, 1].item() == 0.0
    assert abs(got[0, 40, 70, 2].item() / (float(big) * h * w) - 1) < 2 ** -23
    others = got.clone()
    others[0, 40, 70] = 0
    assert not others.any()
    # the exponent: 62 - e with 256 384 max|v| < 2^e, so the largest sum
    # (every source at max|v|) times 2^q is under 2^62
    for m in (1.0, float(big), 1e-30, 3.4e38):
        e = np.frexp(np.float64(256 * 384) * m)[1]
        q = min(max(62 - e, -126), 126)
        assert 256 * 384 * m * 2.0 ** q < 2.0 ** 62
    # the flow path's values: q = 45, a resolution of 2.8e-14
    assert 62 - np.frexp(np.float64(256 * 384) * 1.0)[1] == 45


def test_non_finite_values_give_the_plain_versions_nan_and_inf():
    n, h, w = 1, 40, 60
    v = _softsplat_values(n, h, w, seed=11)
    v[0, 5, 7, 0] = np.inf
    v[0, 5, 8, 0] = -np.inf       # meets the +Inf at a shared tap: NaN
    v[0, 20, 30, 1] = np.nan
    v[0, 33, 50, 2] = -np.inf     # alone: -Inf
    v[0, 0, 0, 3] = np.inf        # at the border: taps outside the image
    fl = _smooth_flow(n, h, w, 2.0, seed=12)
    for local in (False, True):
        if local:
            offs = JO.tile_flow_offsets(jnp.asarray(fl), 128, 128, 8, 0)
            off = _t(offs.off_out)
            got = k5_local_model(_t(v), _t(fl), off, 4, 8).numpy()
            ref = TK5.splat_region_local_plain(_t(v), _t(fl), off, 4,
                                               8).numpy()
        else:
            got = k5_model(_t(v), _t(fl), 4, 8).numpy()
            ref = TK5.splat_region_plain(_t(v), _t(fl), 4, 8).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
        assert np.isnan(ref).any() and np.isinf(ref).any()
        fin = np.isfinite(ref)
        _close(got[fin], ref[fin])


def test_model_taps_are_the_plain_versions():
    """The model's contributions are the plain splat's: with one source
    pixel, the four taps hold v hat hat exactly."""
    v = np.zeros((1, 8, 9, 1), np.float32)
    v[0, 3, 4, 0] = 0.7
    fl = np.zeros((1, 8, 9, 2), np.float32)
    fl[0, 3, 4] = (1.25, 2.5)
    got = k5_model(_t(v), _t(fl), 8, 8)[0, ..., 0]
    ty, tx = torch.tensor(3.0 + 2.5), torch.tensor(4.0 + 1.25)
    for r in (5, 6):
        for k in (5, 6):
            want = (torch.tensor(0.7) * _hat(ty - r)) * _hat(tx - k)
            assert got[r, k].item() == want.item()
    assert got.count_nonzero() == 4
