"""The port's data and tensor parallelism held against the JAX package.

One world of 8 gloo CPU processes (``tests/torch_port_dist_worker.py``,
``world8``) runs every 8-rank case of ``tests/test_multichip.py`` on the
port, with the params, batches and noise of the JAX side converted: DP 8
(and with remat) against JAX's single-device loss, DP 4 x TP 2 and DP 2 x
TP 4 (the 3x3 couplings column- / row-parallel, the 1x1 couplings' fused
Functions on gathered weights) against JAX's single-device gradients, the
hidden width that TP 4 does not divide (replicated, with the warning), the
flow loss and the spatial controller's step under DP 8, the dry run, and
``resolve_mesh``'s policy. Tolerances are ``test_multichip.py``'s: loss
``rel=1e-4`` (flow ``rel=1e-3``), gradients ``atol=5e-4, rtol=1e-3``. The
JAX side runs on ``tests/conftest.py``'s virtual CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.train import flow as JFT
from sin_inn_tpu.train import sr as JSR
from test_torch_port_train import _jax_draws
from torch_port_dist_worker import spawn

_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _sr_case(hidden, num_coupling, batch=None, key=7, rows=8, **extra):
    kw = dict(architecture="SRF", scale=2, num_coupling=num_coupling,
              lr_window=1, hidden_channels=hidden, **extra)
    jcfg = JaxSRConfig(**kw, donate_state=False)
    spec, state, _ = JSR.create_train_state(jax.random.key(0), jcfg)
    if batch is None:
        rng = np.random.RandomState(0)
        batch = {"hr": rng.randint(0, 255, (rows, 8, 8, 3), dtype=np.uint8),
                 "lr": rng.randint(0, 255, (rows, 2, 2, jcfg.lr_dims),
                                   dtype=np.uint8)}
    k = jax.random.key(key)
    jb = {n: jnp.asarray(v) for n, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: JSR.sr_loss(p, spec, jcfg, jb, None, k), has_aux=True)(
            state.params)
    draws = _jax_draws(k, jcfg, rows, 2, 2)
    case = {"cfg": kw, "params": _np(state.params), "batch": batch,
            "draws": {"z": draws.z.numpy()}}
    ref = {"loss": float(loss),
           "grads": [np.asarray(g) for g in
                     jax.tree_util.tree_leaves(grads)]}
    return case, ref


def _flow_case(batch, step=False, **kw):
    jcfg = JaxFlowConfig(**kw)
    spec, state, consts, ctrl_cfg, tx = JFT.create_flow_state(
        jax.random.key(0), jcfg)
    case = {"cfg": kw, "params": _np(state.params), "consts": _np(consts),
            "ctrl_state": (_np(state.ctrl_state)
                           if state.ctrl_state is not None else None),
            "batch": batch}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if not step:
        loss, _ = JFT.flow_loss(spec, jcfg, state.params, consts, ctrl_cfg,
                                state.ctrl_state, jb)
        return case, {"loss": float(loss)}
    new, m = JFT.make_flow_train_step(spec, jcfg, ctrl_cfg, tx)(
        state, consts, jb)
    return case, {"loss": float(m["loss"]),
                  "log_buffer": np.asarray(new.ctrl_state.log_buffer),
                  "mask": np.asarray(new.ctrl_state.mask)}


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    return {"frame1": rng.rand(n, 8, 8, 3).astype(np.float32),
            "frame2": rng.rand(n, 8, 8, 3).astype(np.float32),
            "times": np.linspace(-1, 1, n, dtype=np.float32),
            "scale": np.float32(1.6)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's single-process runs here on one thread, as the ranks run:
    many small ops on several threads each wait at every op's barrier, which
    beside other busy processes costs minutes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    inp, ref = {}, {}
    inp["sr16"], ref["sr16"] = _sr_case(16, 1)
    inp["sr16_c2"], ref["sr16_c2"] = _sr_case(16, 2, key=3)
    inp["sr18"], ref["sr18"] = _sr_case(18, 2)
    inp["flow"], ref["flow"] = _flow_case(
        _frames(8, 1), net="RBF", num_frequencies=8, hidden_dim=16,
        num_layers=2, epochs=10)
    inp["spatial"], ref["spatial"] = _flow_case(
        _frames(8, 2), step=True, net="PFF", num_frequencies=8,
        hidden_dim=16, num_layers=2, epochs=64, spatially_adaptive=True,
        spatial_res=4)
    zeros = {"hr": np.zeros((2, 8, 8, 3), np.uint8),
             "lr": np.zeros((2, 2, 2, 12), np.uint8)}
    inp["dry_sr"], ref["dry_sr"] = _sr_case(64, 1, batch=zeros, key=1,
                                            rows=2)
    # random frames: zero frames leave the occlusion masks empty, and the
    # mask-normalised losses 0 / 0, in both packages
    inp["dry_flow"], ref["dry_flow"] = _flow_case(
        _frames(8, 3), step=True, net="PFF", num_frequencies=8, hidden_dim=16,
        num_layers=2, epochs=10, spatially_adaptive=True, spatial_res=3)
    work = tmp_path_factory.mktemp("world8")
    torch.save(inp, work / "inputs.pt")
    outs = spawn(8, str(work), "world8")
    return outs, ref, inp


def test_sr_dp_matches_single_device(world8):
    outs, ref, _ = world8
    for o in outs:
        assert o["dp8_loss"] == pytest.approx(ref["sr16"]["loss"], rel=1e-4)


def test_sr_dp_remat_matches_single_device(world8):
    outs, ref, _ = world8
    assert outs[0]["dp8_remat_loss"] == pytest.approx(ref["sr16"]["loss"],
                                                      rel=1e-4)


def test_sr_dp_tp_train_step_runs_and_conv1_is_sharded(world8):
    """DP 4 x TP 2: one Adam step; conv1 of the first GLOW subnet holds half
    the hidden channels on every rank, and the whole params after the step
    equal a single-process step of the port on the same inputs."""
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.models import inn as TI
    from sin_inn_tpu_torch.models.convert import params_from_jax
    from sin_inn_tpu_torch.train import sr as SR

    outs, ref, inp = world8
    case = inp["sr16_c2"]
    for o in outs:
        st = o["tp42_step"]
        assert np.isfinite(st["loss"])
        assert st["loss"] == pytest.approx(ref["sr16_c2"]["loss"], rel=1e-4)
        assert st["conv1_shape"][0] == 8
        assert st["conv1_spec"] == ("model", None, None, None)
    cfg = SRConfig(**case["cfg"], device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    state = SR.train_state(params_from_jax(spec, case["params"]), cfg)
    SR.make_train_step(spec, cfg)(
        state, {k: torch.from_numpy(v) for k, v in case["batch"].items()},
        draws=SR.SRDraws(torch.from_numpy(case["draws"]["z"])))
    for a, b in zip(outs[0]["tp42_step"]["params"],
                    TI.flat_params(state.params)):
        np.testing.assert_allclose(a, b.detach().numpy(), atol=1e-5)


def _grads_match(got, ref_leaves, case):
    """The port's gradients (its flat order) against JAX's leaves."""
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.models import inn as TI
    from sin_inn_tpu_torch.models.convert import params_from_jax

    spec, _ = TI.build_inn_spec(SRConfig(**case["cfg"], device="cpu"))
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(case["params"]), ref_leaves)
    want = TI.flat_params(params_from_jax(spec, jtree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("mesh", ["tp42", "tp24"], ids=["tp2", "tp4"])
def test_sr_tp_grads_match_replicated(world8, mesh):
    outs, ref, inp = world8
    o = outs[0]
    assert o[f"{mesh}_loss"] == pytest.approx(ref["sr16_c2"]["loss"],
                                              rel=1e-4)
    # both couplings' subnets are sharded: conv1 w and b, conv2 w
    assert len(o[f"{mesh}_sharded"]) == 2 * 2 * 3
    _grads_match(o[f"{mesh}_grads"], ref["sr16_c2"]["grads"],
                 inp["sr16_c2"])
    for other in outs[1:]:
        for a, b in zip(other[f"{mesh}_grads"], o[f"{mesh}_grads"]):
            np.testing.assert_array_equal(a, b)


def test_sr_tp_non_dividing_hidden_replicates(world8):
    outs, ref, _ = world8
    o = outs[0]
    assert any("not divisible" in m for m in o["tp18_warnings"])
    for path, shape in o["tp18_shapes"].items():
        if 18 in shape:
            assert o["tp18_specs"][path] == (), path
    assert o["tp18_loss"] == pytest.approx(ref["sr18"]["loss"], rel=1e-4)


def test_flow_sp_matches_single_device(world8):
    outs, ref, _ = world8
    for o in outs:
        assert o["flow_dp8_loss"] == pytest.approx(ref["flow"]["loss"],
                                                   rel=1e-3)


def test_flow_spatial_controller_step_dp_matches_single(world8):
    outs, ref, _ = world8
    for o in outs:
        got = o["spatial_dp8"]
        assert got["metrics"]["loss"] == pytest.approx(
            ref["spatial"]["loss"], rel=1e-3)
        np.testing.assert_allclose(got["log_buffer"],
                                   ref["spatial"]["log_buffer"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["mask"], ref["spatial"]["mask"],
                                   atol=1e-5)


def test_dryrun_multichip(world8):
    """The dry run's two parts: DP 2 x TP 4 at hidden 64 on a zero batch,
    and the spatial controller's flow step (res 3) under DP 8."""
    outs, ref, _ = world8
    o = outs[0]
    assert np.isfinite(o["dry_sr_loss"])
    assert o["dry_sr_loss"] == pytest.approx(ref["dry_sr"]["loss"], rel=1e-4)
    assert np.isfinite(o["dry_flow_loss"])
    assert o["dry_flow_loss"] == pytest.approx(ref["dry_flow"]["loss"],
                                               rel=1e-3)


def test_resolve_mesh_auto_divisor_policy(world8):
    pol = world8[0][0]["policy"]
    # batch 4 on 8 processes: the data axis shrinks to 4
    assert pol["b4"] == 4
    assert pol["b1"] is None and pol["one"] is None
    assert "not divisible" in pol["indivisible"]
    assert "exceeds" in pol["too_wide"]


def test_resolve_mesh_without_a_process_group():
    from sin_inn_tpu_torch.train.loop import resolve_mesh

    assert resolve_mesh(None, 1, batch_size=8) is None
    assert resolve_mesh(1, 1) is None
    with pytest.raises(ValueError, match="exceeds"):
        resolve_mesh(None, 2)


def test_sr_param_spec_and_batch_shardings():
    """The spec rules on the port's OIHW leaves and the batch specs."""
    from sin_inn_tpu_torch.parallel.mesh import Mesh
    from sin_inn_tpu_torch.parallel.sharding import (batch_shardings,
                                                     sr_param_spec)

    w1, b1 = torch.zeros(16, 6, 3, 3), torch.zeros(16)
    w2 = torch.zeros(12, 16, 3, 3)
    assert sr_param_spec((1, "s1", "conv1", "w"), w1, True) == (
        "model", None, None, None)
    assert sr_param_spec((1, "s2", "conv1", "b"), b1, True) == ("model",)
    assert sr_param_spec((1, "s2", "conv2", "w"), w2, True) == (
        None, "model", None, None)
    assert sr_param_spec((1, "s2", "conv2", "b"), torch.zeros(12), True) == ()
    assert sr_param_spec((1, "F", "conv1", "w"), w1, True) == ()
    assert sr_param_spec((1, "s1", "conv1", "w"), w1, False) == ()
    mesh = Mesh(data=4, model=1, rank=0, world=4, data_index=0,
                model_index=0)
    b = {"hr": torch.zeros(6, 2), "scale": 1.5}
    assert batch_shardings(mesh, b, allow_uneven=True) == {"hr": (),
                                                           "scale": ()}
    assert batch_shardings(mesh, {"hr": torch.zeros(8)}) == {"hr": ("data",)}


def test_place_and_shard_batch_on_a_mesh_view():
    """This rank's rows (rank 2 of a data axis of 4), a ragged batch whole,
    and the strict form's refusal; ``pad_to_multiple``."""
    from sin_inn_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
    from sin_inn_tpu_torch.parallel.mesh import shard_batch
    from sin_inn_tpu_torch.parallel.sharding import batch_rows, place_batch

    mesh = Mesh(data=4, model=1, rank=2, world=4, data_index=2,
                model_index=0)
    b = {"hr": torch.arange(8.0), "scale": 1.5}
    got = shard_batch(mesh, b)
    assert got["hr"].tolist() == [4.0, 5.0] and got["scale"] == 1.5
    placed = place_batch(mesh, b)
    assert placed.sharded and batch_rows(placed) == 8
    assert placed["hr"].tolist() == [4.0, 5.0]
    ragged = place_batch(mesh, {"hr": torch.arange(6.0)}, allow_uneven=True)
    assert not ragged.sharded and ragged["hr"].shape[0] == 6
    with pytest.raises(ValueError, match="does not divide"):
        place_batch(mesh, {"hr": torch.arange(6.0)})
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, {"hr": torch.arange(6.0)})
    assert pad_to_multiple(6, 4) == 8 and pad_to_multiple(8, 4) == 8


def test_tp_couplings_come_from_the_shardings_and_route_inn_apply():
    """Which couplings run tensor-parallel is read from the state's
    shardings, never from tensor widths: ``inn_apply`` hands exactly those
    layers to their TP object (the 3x3 subnets, and the 1x1 kernels' whole
    weights), a coupling sharded in part raises, and a mesh with no model
    axis or a layout with no sharded leaf gives no plan."""
    import dataclasses

    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.models import inn as TI
    from sin_inn_tpu_torch.ops import subnet as S
    from sin_inn_tpu_torch.parallel.mesh import Mesh
    from sin_inn_tpu_torch.parallel.sharding import (TPCoupling, _param_paths,
                                                     sr_param_spec,
                                                     tp_couplings)

    cfg = SRConfig(scale=2, num_coupling=2, lr_window=1, hidden_channels=8,
                   device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    params = TI.init_inn(torch.Generator().manual_seed(0), spec)
    glows = [i for i, layer in enumerate(spec) if layer.kind == "glow"]
    assert [spec[i].kernel for i in glows] == [3, 1]
    shardings = {p: sr_param_spec(p, t, True)
                 for p, t in _param_paths(params)}
    mesh = Mesh(data=1, model=2, rank=0, world=2, data_index=0,
                model_index=0, model_group="model-group")
    plan = tp_couplings(mesh, shardings)
    assert sorted(plan) == glows
    assert all(isinstance(v, TPCoupling) and v.group == "model-group"
               for v in plan.values())
    assert tp_couplings(dataclasses.replace(mesh, model=1), shardings) is None
    assert tp_couplings(None, shardings) is None
    assert tp_couplings(mesh, {p: () for p in shardings}) is None
    part = dict(shardings)
    part[(glows[0], "s2", "conv2", "w")] = ()
    with pytest.raises(ValueError, match="in part"):
        tp_couplings(mesh, part)

    class Spy:
        """Whole weights on one process, recording each route taken."""

        def __init__(self):
            self.calls = []

        def subnet(self, p, x, compute=None):
            self.calls.append("subnet")
            return S.conv_subnet_apply(p, x, compute=compute)

        def whole(self, p):
            self.calls.append("whole")
            return p

    x = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    ref = TI.inn_apply(spec, params, x)
    spy = Spy()
    got = TI.inn_apply(spec, params, x, tp={i: spy for i in glows})
    assert spy.calls == ["subnet", "subnet", "whole"]
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    spy = Spy()
    TI.inn_apply(spec, params, ref, rev=True, tp={glows[1]: spy})
    assert spy.calls == ["whole"]
