"""The local-window pieces of the port held against the JAX package on the
CPU: the tile offsets (``ops/offsets.py`` against
``sin_inn_tpu/ops/pallas/offsets.py``), the plain versions of K5 local and
K6 local (forward and gradient modes) against the Pallas kernels in
interpret mode on the same offsets, and the gradients of the differentiable
wrappers against ``jax.vjp`` of the JAX ones.

Flows: a smooth field on a 20 px row drift with +-2 px of detail (inside
the local windows), the same with +-12 px of detail (beyond them, so the
drop rule runs), and one with a 110 px column drift for the column offsets.
Tolerances: offsets exactly equal, deviations 1e-5 + 1e-5 relative (the
tile means are sums of 16,384 fp32 values in another order); the splat 2e-6
and the gather and every gradient 1e-5, as for the static kernels (sums in
another order; the gather's coordinate is one fused multiply-add in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops.pallas import gather as JG
from sin_inn_tpu.ops.pallas import offsets as JO
from sin_inn_tpu.ops.pallas import splat as JS
from sin_inn_tpu_torch.ops import offsets as TO
from sin_inn_tpu_torch.ops.cuda import gather as TG
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from torch_port_helpers import one_torch_thread  # noqa: F401


def _flow(n, h, w, detail, drift_x=-15.0, seed=0):
    """A smooth flow: 20 px row drift, ``drift_x`` column drift, and
    +-``detail`` px of seeded waves (constants keep targets off integers)."""
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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# (shape, detail, drift_x, loc_dy, loc_dx, cap_y, cap_x)
CASES = {
    "inside": ((1, 136, 160), 2.0, -15.0, 8, 18, 24, 0),
    "beyond": ((1, 200, 300), 12.0, -15.0, 8, 64, 24, 0),
    "columns": ((1, 136, 300), 2.0, 110.0, 16, 64, 64, 128),
}


@pytest.mark.parametrize("n,h,w,cap_y,cap_x", [
    (1, 136, 160, 24, 0), (2, 136, 160, 64, 128), (1, 200, 300, 24, 128),
    (1, 200, 300, 64, 0)])
def test_tile_flow_offsets_match_jax(n, h, w, cap_y, cap_x):
    for detail, drift_x in ((2.0, -15.0), (12.0, 110.0)):
        fl = _flow(n, h, w, detail, drift_x, seed=n + h)
        ref = JO.tile_flow_offsets(jnp.asarray(fl), 128, 128, cap_y, cap_x)
        got = TO.tile_flow_offsets(_t(fl), 128, 128, cap_y, cap_x)
        for name in ("off_src", "off_out"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        for name in ("dev_src", "dev_out"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, rtol=1e-5)
        fine = TO.tile_deviation_fine(_t(fl), 128, 128)
        np.testing.assert_allclose(
            fine.numpy(), np.asarray(JO.tile_deviation_fine(
                jnp.asarray(fl), 128, 128)), atol=1e-5, rtol=1e-5)
    # the offsets are quantized (rows to 8, columns to 128) and capped
    assert not (got.off_out[..., 1] % 8).any()
    assert not (got.off_out[..., 0] % 128).any()
    assert got.off_src[..., 1].abs().max() <= cap_y
    if cap_x == 0:
        assert not got.off_src[..., 0].any()


def test_tile_flow_offsets_keep_no_graph_and_refuse_bad_caps():
    fl = _t(_flow(1, 40, 50, 2.0)).requires_grad_()
    offs = TO.tile_flow_offsets(fl, 128, 128, 24, 0)
    assert not any(t.requires_grad for t in offs)
    assert offs.off_src.shape == (1, 1, 1, 2)
    with pytest.raises(ValueError, match="cap_x"):
        TO.tile_flow_offsets(fl, 128, 128, 24, 64)


def _case(name, c, seed=3):
    shape, detail, drift_x, ldy, ldx, capy, capx = CASES[name]
    n, h, w = shape
    fl = _flow(n, h, w, detail, drift_x, seed=seed)
    rng = np.random.RandomState(seed)
    v = rng.rand(n, h, w, c).astype(np.float32)
    offs = JO.tile_flow_offsets(jnp.asarray(fl), 128, 128, capy, capx)
    return v, fl, offs, (ldy, ldx, capy, capx)


@pytest.mark.parametrize("name", list(CASES))
def test_splat_local_plain_matches_pallas_kernel(name):
    v, fl, offs, (ldy, ldx, capy, capx) = _case(name, 3)
    ref = JS._splat_region_call_local(jnp.asarray(v), jnp.asarray(fl),
                                      offs.off_out, ldy, ldx, capy, capx,
                                      True)
    got = TK5.splat_region_local_plain(_t(v), _t(fl), _t(offs.off_out), ldy,
                                       ldx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    exact = TK5.splat_scatter(_t(v), _t(fl)).numpy()
    dropped = np.abs(exact - np.asarray(ref)).max()
    assert (dropped > 0.1) == (name == "beyond"), dropped


@pytest.mark.parametrize("name", list(CASES))
def test_gather_local_plain_matches_pallas_kernel(name):
    a, fl, offs, (ldy, ldx, capy, capx) = _case(name, 5, seed=4)
    h, w = fl.shape[1:3]
    q = np.random.RandomState(5).randn(*a.shape).astype(np.float32)
    off = _t(offs.off_src)
    # forward mode at resample coordinates (the warp), C = 3
    a3 = a[..., :3]
    coord = JG._resample_coord(h, w)
    ref = JG._gather_region_call_local(
        jnp.asarray(a3), jnp.asarray(fl), None, offs.off_src, ldy, ldx,
        capy, capx, coord, False, True)
    got = TG.gather_region_plain(_t(a3), _t(fl), ldy, ldx,
                                 TG.resample_coord(h, w), off_src=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # gradient mode: C = 3 at resample coordinates (the warp's backward) and
    # C = 5 raw (the splat's backward)
    for c, jc, tc in ((3, coord, TG.resample_coord(h, w)),
                      (5, JG._RAW, TG.RAW)):
        ref = JG._gather_region_call_local(
            jnp.asarray(a[..., :c]), jnp.asarray(fl),
            jnp.asarray(q[..., :c]), offs.off_src, ldy, ldx, capy, capx, jc,
            True, True)
        got = TG.gather_region_grads_plain(
            _t(a[..., :c]), _t(fl), _t(q[..., :c]), ldy, ldx, tc,
            off_src=off)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_splat_region_local_gradients_match_jax():
    v, fl, offs, (ldy, ldx, capy, capx) = _case("beyond", 4, seed=6)
    wgt = np.random.RandomState(7).randn(*v.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v_, f_: JS.splat_region_local(
        ldy, ldx, capy, capx, True, v_, f_, offs.off_out, offs.off_src),
        jnp.asarray(v), jnp.asarray(fl))
    jv, jf = vjp(jnp.asarray(wgt))
    tv, tf = _t(v).requires_grad_(), _t(fl).requires_grad_()
    out = TK5.splat_region_local(tv, tf, _t(offs.off_out), _t(offs.off_src),
                                 ldy, ldx)
    (out * _t(wgt)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), atol=1e-5)


def test_resample2d_region_local_gradients_match_jax():
    img, fl, offs, (ldy, ldx, capy, capx) = _case("beyond", 3, seed=8)
    gct = np.random.RandomState(9).randn(*img.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda i_, f_: JG.resample2d_region_local(
        ldy, ldx, capy, capx, True, i_, f_, offs.off_src),
        jnp.asarray(img), jnp.asarray(fl))
    ji, jf = vjp(jnp.asarray(gct))
    ti, tf = _t(img).requires_grad_(), _t(fl).requires_grad_()
    out = TG.resample2d_region_local(ti, tf, _t(offs.off_src), ldy, ldx, capy,
                                     capx)
    (out * _t(gct)).sum().backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), atol=1e-5)


def test_local_wrappers_route_and_check(monkeypatch):
    """CPU tensors take the plain versions (no launch counted); the image
    gradient of the warp is computed only when the image requires one;
    offsets of the wrong shape are refused."""
    img, fl, offs, (ldy, ldx, capy, capx) = _case("inside", 3)
    ti, tf = _t(img), _t(fl).requires_grad_()
    off = _t(offs.off_src)
    TG.reset_launch_counts()
    TK5.reset_launch_counts()
    called = []
    monkeypatch.setattr(TO, "tile_flow_offsets",
                        lambda *a, **k: called.append(1))
    TG.resample2d_region_local(ti, tf, off, ldy, ldx, capy, capx
                               ).sum().backward()
    assert tf.grad is not None and not called
    assert set(TG.launch_counts().values()) == {0}
    assert set(TK5.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="offsets"):
        TG.resample2d_region_local(ti, tf, off[:, :, :0], ldy, ldx, capy,
                                   capx)
    with pytest.raises(ValueError, match="offsets"):
        TK5.splat_region_local(ti, tf, off, off.double(), ldy, ldx)
