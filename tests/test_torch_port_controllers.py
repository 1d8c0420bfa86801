"""The port's progressive controllers held against the JAX package on the
CPU: every controller over a few block cycles of seeded losses, the mask
producers of the spatial controller against JAX and against each other, the
scatter-free grid update against the scatter form, and the states' way
through ``ctrl_state_from_jax`` and the checkpoint dict.

Integers and booleans are compared exactly; masks within 1e-6 (the same
fp32 operations, contractions summed in another order); the accumulated
per-cell losses and visit counts, sums over hundreds of points that grow past
1, within 1e-6 + 1e-5 of their size. Where a state depends on a threshold (``smoothed > epsilon``,
``best < epsilon``, ``slope > -grad_epsilon``) the seeded losses clear it by
a margin that the test states, since a loss within rounding of a threshold
may fall on either side in the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.models import controllers as JC
from sin_inn_tpu.models import inr as JI
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.models import controllers as TC
from sin_inn_tpu_torch.models import inr as TI
from sin_inn_tpu_torch.models.convert import ctrl_state_from_jax
from torch_port_helpers import one_torch_thread  # noqa: F401

NF = 16      # PFF: 32 encoding channels + 3 coordinate rows = mask length 35


def _specs(net="PFF", domain_dim=3):
    jspec = JI.build_inr(jax.random.PRNGKey(0), net,
                         JaxFlowConfig(num_frequencies=NF, hidden_dim=16,
                                       domain_dim=domain_dim))[0]
    tspec = TI.build_inr(torch.Generator().manual_seed(0), net,
                         FlowConfig(num_frequencies=NF, hidden_dim=16,
                                    domain_dim=domain_dim, device="cpu"))[0]
    assert jspec.encoding_dim == tspec.encoding_dim == 2 * NF + domain_dim
    return jspec, tspec


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _assert_states_equal(tstate, jstate, atol=1e-6):
    """Every field: ints and bools exactly, floats within ``atol`` (the
    accumulators ``log_buffer`` and ``log_counter``: + 1e-5 of their
    size)."""
    assert type(tstate).__name__ == type(jstate).__name__
    for name in jstate._fields:
        ref = np.asarray(getattr(jstate, name))
        got = getattr(tstate, name)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.shape == ref.shape, name
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            rtol = 1e-5 if atol and name in ("log_buffer",
                                             "log_counter") else 0
            np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol,
                                       err_msg=name)


def _assert_configs_equal(tcfg, jcfg):
    for k, v in jcfg.__dict__.items():
        assert getattr(tcfg, k) == v, k


# ---------------------------------------------------------------------------
# Linear controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epsilon,num_blocks", [(0.0, None), (1e-3, None),
                                                (1e-3, 5)])
def test_linear_controller_matches_jax(epsilon, num_blocks):
    jspec, tspec = _specs()
    jcfg = JC.LinearConfig.create(jspec, 16, epsilon, num_blocks)
    tcfg = TC.LinearConfig.create(tspec, 16, epsilon, num_blocks)
    _assert_configs_equal(tcfg, jcfg)
    assert tcfg.block_iterations in (2, 3)
    jstate, tstate = JC.linear_init(jcfg), TC.linear_init(tcfg)
    _assert_states_equal(tstate, jstate)
    # losses fall from 0.5; with the early freeze they dip under epsilon =
    # 1e-3 at step 7 by a factor of two (5e-4), well clear of it
    losses = [0.5, 0.2, 0.1, 0.05, 0.02, 0.01, 5e-4] + [0.03] * 12
    for loss in losses:
        jstate = JC.linear_update(jcfg, jstate, jnp.float32(loss))
        tstate = TC.linear_update(tcfg, tstate, torch.tensor(loss))
        _assert_states_equal(tstate, jstate)
        assert torch.equal(TC.linear_mask(tstate), tstate.mask)
    assert tstate.iteration == len(losses) > tcfg.progress_iterations
    if epsilon:        # frozen at step 7, inside the schedule
        assert float(tstate.mask.sum()) < tcfg.encoding_dim
    else:              # the whole ramp ran
        assert float(tstate.mask.sum()) == tcfg.encoding_dim


# ---------------------------------------------------------------------------
# Spatial controller
# ---------------------------------------------------------------------------

def _spatial(res, block_iterations=3, mask_dim=None, domain_dim=3,
             epsilon=1e-3):
    jspec, tspec = _specs(domain_dim=domain_dim)
    jcfg = JC.SpatialConfig.create(jspec, res, block_iterations, epsilon,
                                   mask_dim)
    tcfg = TC.SpatialConfig.create(tspec, res, block_iterations, epsilon,
                                   mask_dim)
    _assert_configs_equal(tcfg, jcfg)
    return jcfg, tcfg


def _random_cell_state(jcfg, tcfg, seed):
    """Both packages' state with the same seeded cell mask in [0, 1] (not
    the initial one) and some cells out of progress."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(jcfg.cells, jcfg.encoding_dim).astype(np.float32)
    prog = rng.rand(jcfg.cells) > 0.3
    jstate = JC.spatial_init(jcfg)._replace(mask=jnp.asarray(mask),
                                            in_progress=jnp.asarray(prog))
    tstate = TC.spatial_init(tcfg)._replace(mask=_t(mask),
                                            in_progress=torch.from_numpy(prog))
    return jstate, tstate


def _point_losses(rng, b, h, w, step):
    """Per-point losses far from epsilon = 1e-3 on either side: 2e-2 on the
    right 30% of the frame, 1e-5 elsewhere, times one seeded factor in
    [0.5, 1.5] a step (a factor per point would spread the cell losses over
    a continuum, some of it within rounding of epsilon)."""
    del step
    high = np.arange(w)[None, None, :] >= 0.7 * w
    base = np.where(high, 2e-2, 1e-5) * np.ones((b, h, 1))
    return (base * rng.uniform(0.5, 1.5)).astype(np.float32)


def _smoothed_margin(tcfg, tstate):
    """How far the cell losses that the next progress step thresholds lie
    from epsilon, relative to it (the port's own arithmetic)."""
    empty = tstate.log_counter == 0
    cell = tstate.log_buffer / torch.where(empty, 1.0, tstate.log_counter)
    neigh = TC._box_blur_cells(tcfg, torch.where(empty, 0.0, cell))
    cnt = TC._box_blur_cells(tcfg, torch.where(empty, 0.0, 1.0))
    filled = torch.where(empty, neigh / torch.clamp(cnt, min=1e-12), cell)
    smoothed = TC._box_blur_cells(tcfg, filled)
    return ((smoothed - tcfg.epsilon).abs() / tcfg.epsilon).min().item()


@pytest.mark.parametrize("res,h,w", [(5, 6, 40), (34, 5, 64)])
def test_spatial_grid_update_matches_jax_over_block_cycles(res, h, w):
    jcfg, tcfg = _spatial(res)
    jstate, tstate = JC.spatial_init(jcfg), TC.spatial_init(tcfg)
    _assert_states_equal(tstate, jstate)
    rng = np.random.RandomState(res)
    times = np.array([-0.5, 0.75], np.float32)
    advances = 0
    for step in range(3 * tcfg.block_iterations):        # three block cycles
        loss = _point_losses(rng, 2, h, w, step).reshape(-1)
        if (tstate.iteration + 1) % tcfg.block_iterations == 0:
            # the thresholded cell losses clear epsilon by at least 1e-4 of
            # it, a thousand float32 roundings
            probe = TC._stash_ramp(
                tcfg, tstate, *_accumulated(tcfg, tstate, loss, times, h, w))
            assert _smoothed_margin(tcfg, probe) > 1e-4
            advances += 1
        jstate = JC.spatial_grid_update(jcfg, jstate, jnp.asarray(loss),
                                        jnp.asarray(times), h, w)
        tstate = TC.spatial_grid_update(tcfg, tstate, _t(loss), _t(times),
                                        h, w)
        _assert_states_equal(tstate, jstate)
    assert advances == 3 and tstate.cur_block == 4 * tcfg.block_size
    assert not bool(tstate.in_progress.all()) and bool(tstate.in_progress.any())


def _accumulated(tcfg, tstate, loss, times, h, w):
    """(log_buffer, log_counter) after accumulating ``loss``, by the
    scatter form."""
    from sin_inn_tpu_torch.train.flow import pose_grid
    pts = pose_grid(_t(times), h, w).reshape(-1, 3)
    inds, alphas = TC._cell_interp(tcfg, pts)
    wgt = (_t(loss)[:, None] * alphas).reshape(-1)
    return (tstate.log_buffer.index_add(0, inds.reshape(-1), wgt),
            tstate.log_counter.index_add(0, inds.reshape(-1),
                                         alphas.reshape(-1)))


@pytest.mark.parametrize("res", [5, 7])
def test_spatial_grid_update_matches_the_scatter_form(res):
    """``spatial_grid_update`` (three contractions) against
    ``spatial_update`` (the 2^d-corner scatter) on the same pose grid, in the
    port and against JAX's scatter form."""
    from sin_inn_tpu.train.flow import pose_grid as jax_pose_grid
    from sin_inn_tpu_torch.train.flow import pose_grid

    jcfg, tcfg = _spatial(res)
    jstate, tstate = _random_cell_state(jcfg, tcfg, 3)
    grid_state = tstate
    rng = np.random.RandomState(4)
    times = np.array([-1.0, 0.3], np.float32)
    h, w = 6, 40
    for step in range(2 * tcfg.block_iterations):
        loss = _point_losses(rng, 2, h, w, step).reshape(-1)
        pts = pose_grid(_t(times), h, w).reshape(-1, 3)
        _, inds, alphas = TC.spatial_point_mask(tcfg, tstate, pts)
        tstate = TC.spatial_update(tcfg, tstate, _t(loss), inds, alphas)
        grid_state = TC.spatial_grid_update(tcfg, grid_state, _t(loss),
                                            _t(times), h, w)
        jpts = jax_pose_grid(jnp.asarray(times), h, w).reshape(-1, 3)
        _, jinds, jalphas = JC.spatial_point_mask(jcfg, jstate, jpts)
        jstate = JC.spatial_update(jcfg, jstate, jnp.asarray(loss), jinds,
                                   jalphas)
        _assert_states_equal(tstate, jstate, atol=1e-5)
        _assert_states_equal(grid_state, jstate, atol=1e-5)


@pytest.mark.parametrize("res,h,w,tol", [(5, 7, 9, 1e-6), (5, 6, 128, 1e-6),
                                         (34, 4, 64, 5e-6)])
def test_spatial_mask_producers_match_jax_and_each_other(res, h, w, tol):
    """``spatial_grid_mask``, ``_split`` and ``_slabs``: each against JAX
    and against each other. res 34: the cell coordinates reach 33, where a
    float32 ulp (3.8e-6) and the last bit in which ``torch.linspace`` and
    ``jnp.linspace`` differ show in the hat weights: 5e-6 there."""
    jcfg, tcfg = _spatial(res)
    jstate, tstate = _random_cell_state(jcfg, tcfg, 5)
    times = np.array([-1.0, 0.1, 1.0], np.float32)
    jt, tt = jnp.asarray(times), _t(times)
    joint = TC.spatial_grid_mask(tcfg, tstate, tt, h, w)
    assert joint.shape == (3 * h * w, tcfg.encoding_dim)
    np.testing.assert_allclose(
        joint.numpy(), np.asarray(JC.spatial_grid_mask(jcfg, jstate, jt, h, w)),
        atol=tol, rtol=0)
    mc, me = TC.spatial_grid_mask_split(tcfg, tstate, tt, h, w)
    jmc, jme = JC.spatial_grid_mask_split(jcfg, jstate, jt, h, w)
    np.testing.assert_allclose(mc.numpy(), np.asarray(jmc), atol=tol, rtol=0)
    np.testing.assert_allclose(me.numpy(), np.asarray(jme), atol=tol, rtol=0)
    np.testing.assert_allclose(mc.t().numpy(), joint[:, :3].numpy(), atol=1e-6)
    np.testing.assert_allclose(me.numpy(), joint[:, 3:].numpy(), atol=1e-6)
    slabs = TC.spatial_grid_mask_slabs(tcfg, tstate, tt, h, w)
    jslabs = JC.spatial_grid_mask_slabs(jcfg, jstate, jt, h, w)
    for got, ref in zip(slabs, jslabs):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                                   rtol=0)
    # the x contraction a kernel does puts the joint mask together again
    # (its res terms summed in another order than the einsum's)
    np.testing.assert_allclose(TI.dense_mask(tuple(slabs)).numpy(),
                               joint.numpy(), atol=1e-6)
    np.testing.assert_allclose(TI.dense_mask((mc, me)).numpy(),
                               joint.numpy(), atol=1e-6)
    # bf16 emission: the large last contraction (or the slabs) in bf16
    bmask = TC.spatial_grid_mask(tcfg, tstate, tt, h, w, dtype=torch.bfloat16)
    bslabs = TC.spatial_grid_mask_slabs(tcfg, tstate, tt, h, w,
                                        dtype=torch.bfloat16)
    assert bmask.dtype == bslabs.enc.dtype == bslabs.coord.dtype \
        == torch.bfloat16 and bslabs.wx.dtype == torch.float32
    np.testing.assert_allclose(bmask.float().numpy(), joint.numpy(),
                               atol=2e-2)
    with pytest.raises(ValueError, match="cell grid"):
        TC.spatial_grid_mask(TC.SpatialConfig.create(
            _specs()[1], 5, mask_dim=2), tstate, tt, h, w)


def test_grid_axis_weights_match_jax_exactly_on_the_same_coordinates():
    """Same numpy coordinates in, the same weights out, bit for bit; among
    them a coordinate whose cell coordinate is the integer 33: in float32
    33 + 1e-6 == 33, so hi == lo and both hat weights are 0 there, in both
    packages (at a small integer the 1e-6 survives and the weights are 1 and
    0). res = 66 makes xs = 32 (c + 1) + 0.5 exact."""
    jcfg, tcfg = _spatial(66)
    pinned, small = 0.015625, -0.921875          # xs = 33 and xs = 3
    coords = np.concatenate([
        np.random.RandomState(0).uniform(-1, 1, 200).astype(np.float32),
        np.array([-1.0, 1.0, pinned, small], np.float32)])
    ref = np.asarray(JC.grid_axis_weights(jcfg, jnp.asarray(coords)))
    got = TC.grid_axis_weights(tcfg, _t(coords)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[-2].sum() == 0.0 and ref[-2].sum() == 0.0
    assert got[-1].sum() == 1.0 and got[-1, 3] == 1.0
    np.testing.assert_allclose(got[:200].sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(
        TC._blur_axis_matrix(tcfg).numpy(),
        np.asarray(JC._blur_axis_matrix(jcfg)))


@pytest.mark.parametrize("domain_dim,res", [(3, 5), (2, 12)])
def test_spatial_point_mask_and_stash_match_jax(domain_dim, res):
    """The generic point path (the 2-D pair experiment takes it): cell
    indices exactly, weights and masks within 1e-6, one stash."""
    jcfg, tcfg = _spatial(res, domain_dim=domain_dim)
    assert tcfg.mask_dim == domain_dim and tcfg.k == (5 if res ** domain_dim
                                                      > 100 else 3)
    jstate, tstate = _random_cell_state(jcfg, tcfg, 6)
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (300, domain_dim)).astype(np.float32)
    x[:4] = [[-1.0] * domain_dim, [1.0] * domain_dim, [0.0] * domain_dim,
             [1.0] + [-1.0] * (domain_dim - 1)]
    jmask, jinds, jalphas = JC.spatial_point_mask(jcfg, jstate, jnp.asarray(x))
    tmask, tinds, talphas = TC.spatial_point_mask(tcfg, tstate, _t(x))
    np.testing.assert_array_equal(tinds.numpy(), np.asarray(jinds))
    np.testing.assert_allclose(talphas.numpy(), np.asarray(jalphas), atol=1e-6)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), atol=1e-6)
    np.testing.assert_allclose(
        TC._box_blur_cells(tcfg, tstate.mask).numpy(),
        np.asarray(JC._box_blur_cells(jcfg, jstate.mask)), atol=1e-6)
    loss = rng.rand(300).astype(np.float32)
    jnew = JC.spatial_stash(jcfg, jstate, jnp.asarray(loss), jinds, jalphas)
    tnew = TC.spatial_stash(tcfg, tstate, _t(loss), tinds, talphas)
    _assert_states_equal(tnew, jnew, atol=1e-5)
    # the old state is left as it was
    np.testing.assert_array_equal(tstate.mask.numpy(), np.asarray(jstate.mask))


# ---------------------------------------------------------------------------
# Adaptive and fixed spatial controllers
# ---------------------------------------------------------------------------

def test_adaptive_controller_matches_jax():
    jspec, tspec = _specs()
    jcfg = JC.AdaptiveConfig.create(jspec, 40)
    tcfg = TC.AdaptiveConfig.create(tspec, 40)
    _assert_configs_equal(tcfg, jcfg)
    assert tcfg.block_iterations == 7 and (tcfg.WAITING, tcfg.STABILIZING,
                                           tcfg.INCREASING) == (0, 1, 2)
    jstate, tstate = JC.adaptive_init(jcfg), TC.adaptive_init(tcfg)
    _assert_states_equal(tstate, jstate)
    # a loss curve of steep falls (slope of log loss about -0.3 a step, far
    # under -grad_epsilon = -5e-4) and flat stretches rising by 1% a step
    # (slope about +1e-2, far over it); never under epsilon = 1e-5. More
    # steps than max_iteration, so the history's last slot is rewritten and
    # the slope window is clamped to the history's end
    losses, loss = [], 1.0
    for step in range(48):
        loss *= 0.74 if (step // 8) % 2 == 0 else 1.01
        losses.append(loss)
    seen = set()
    for loss in losses:
        jstate = JC.adaptive_update(jcfg, jstate, jnp.float32(loss))
        tstate = TC.adaptive_update(tcfg, tstate, torch.tensor(loss))
        _assert_states_equal(tstate, jstate)
        seen.add(int(tstate.status))
    assert seen == {0, 1, 2} and int(tstate.cur_block) > tcfg.block_size
    for end in (0, 2, 20, 39, 40, 47):
        np.testing.assert_allclose(
            TC._loss_slope(tcfg, tstate.log, end).item(),
            float(JC._loss_slope(jcfg, jstate.log, jnp.int32(end))),
            atol=1e-6)


@pytest.mark.parametrize("domain_dim,num_samples", [(1, 50), (2, 49)])
def test_fixed_spatial_controller_matches_jax(domain_dim, num_samples):
    jspec, tspec = _specs(domain_dim=domain_dim)
    jcfg = JC.FixedSpatialConfig.create(jspec, num_samples, 24)
    tcfg = TC.FixedSpatialConfig.create(tspec, num_samples, 24)
    _assert_configs_equal(tcfg, jcfg)
    jstate = JC.fixed_spatial_init(jcfg)
    tstate = TC.fixed_spatial_init(tcfg)
    _assert_states_equal(tstate, jstate)
    rng = np.random.RandomState(8)
    for step in range(tcfg.progress_iterations + 3):
        # sample losses 2e-2 or 1e-5 by block of ten samples: the 3-tap blur
        # keeps every value a factor of three away from epsilon = 1e-3
        high = ((np.arange(num_samples) // 10 + step // 5) % 2 == 0)
        loss = (np.where(high, 2e-2, 1e-5)
                * rng.uniform(0.8, 1.2, num_samples)).astype(np.float32)
        blurred = TC._blur_1d2d(tcfg, _t(loss))
        assert ((blurred - tcfg.epsilon).abs() / tcfg.epsilon).min() > 0.5
        jstate = JC.fixed_spatial_update(jcfg, jstate, jnp.asarray(loss))
        tstate = TC.fixed_spatial_update(tcfg, tstate, _t(loss))
        _assert_states_equal(tstate, jstate)
        np.testing.assert_allclose(
            TC.fixed_spatial_mask(tcfg, tstate).numpy(),
            np.asarray(JC.fixed_spatial_mask(jcfg, jstate)), atol=1e-6)
    assert tstate.iteration > tcfg.progress_iterations


# ---------------------------------------------------------------------------
# States across the packages and through the checkpoint
# ---------------------------------------------------------------------------

def _jax_states():
    jspec, _ = _specs()
    lin = JC.linear_update(JC.LinearConfig.create(jspec, 16, 1e-3),
                           JC.linear_init(JC.LinearConfig.create(
                               jspec, 16, 1e-3)), jnp.float32(0.3))
    scfg = JC.SpatialConfig.create(jspec, 5, 3)
    spa = JC.spatial_grid_update(
        scfg, JC.spatial_init(scfg), jnp.full((2 * 6 * 40,), 0.02),
        jnp.asarray([0.0, 0.5]), 6, 40)
    ada = JC.adaptive_update(JC.AdaptiveConfig.create(jspec, 40),
                             JC.adaptive_init(JC.AdaptiveConfig.create(
                                 jspec, 40)), jnp.float32(0.3))
    j1 = _specs(domain_dim=1)[0]
    fcfg = JC.FixedSpatialConfig.create(j1, 50, 24)
    fix = JC.fixed_spatial_update(fcfg, JC.fixed_spatial_init(fcfg),
                                  jnp.full((50,), 0.02))
    return {"linear": lin, "spatial": spa, "adaptive": ada,
            "fixed_spatial": fix}


@pytest.mark.parametrize("kind", ["linear", "spatial", "adaptive",
                                  "fixed_spatial"])
def test_ctrl_state_from_jax_and_checkpoint_dict_round_trip(kind, tmp_path):
    jstate = _jax_states()[kind]
    as_np = type(jstate)(*[np.asarray(v) for v in jstate])
    tstate = ctrl_state_from_jax(as_np)
    assert TC.state_kind(tstate) == kind
    _assert_states_equal(tstate, jstate, atol=0)
    for name in tstate._fields:
        v = getattr(tstate, name)
        assert isinstance(v, int if name in TC.HOST_FIELDS[kind]
                          else torch.Tensor), name
        if isinstance(v, torch.Tensor):
            assert v.dtype == {"f": torch.float32, "i": torch.int32,
                               "b": torch.bool}[
                np.asarray(getattr(jstate, name)).dtype.kind], name
    # through the checkpoint store (weights_only loading)
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"ctrl_state": TC.state_to_dict(tstate)})
    back = TC.state_from_dict(store.restore()[0]["ctrl_state"])
    _assert_states_equal(back, jstate, atol=0)
    assert ctrl_state_from_jax(None) is None
    with pytest.raises(ValueError, match="not a controller state"):
        ctrl_state_from_jax(JC.SpatialSlabMask(0, 0, 0))
    with pytest.raises(TypeError, match="not a controller state"):
        TC.state_kind((1, 2))
