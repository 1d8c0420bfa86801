"""The port's data parallelism in the production loops and in the losses
with batch-global statistics, on a world of 4 gloo CPU processes.

``tests/torch_port_dist_worker.py`` ``world4`` runs, with the JAX side's
params and noise where a JAX result exists: the MMD terms of ``sr_loss``
under DP 4 against JAX's single-device loss and gradients; the photometric
losses on shards whose masks are uneven against JAX's whole-batch values
and gradients; a flow step on the local windows against this process
alone; ``run_sr_train`` DP 4 on the IRN, the ragged TCR loop and
``run_flow_train`` DP 4 with the validation EPE, and ``run_sr_train``
and the window refit of ``run_flow_train`` on DP 2 in the world of 4 (ranks
2 and 3 idle), each against the port's single-process run of the same
config (the loops draw their own noise, so the counterpart is the port
alone, as ``tests/test_multichip.py`` holds JAX's mesh runs against JAX
alone); and the launcher's scene shard by rank. Also ``initialize_distributed``'s contract, and the config fields
of both pipelines against the JAX package's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.ops import photometric as JP
from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
from sin_inn_tpu_torch.data.flow_media import FlowMedia
from sin_inn_tpu_torch.data.synthetic import (moving_texture_video,
                                              synthetic_sr_video)
from sin_inn_tpu_torch.parallel.mesh import initialize_distributed
from sin_inn_tpu_torch.train import loop as L
from test_torch_port_parallel import _grads_match, _sr_case
from torch_port_dist_worker import _flow_step, spawn

LOOP = dict(scale=2, num_coupling=1, lr_window=1, fps=30,
            architecture="IRN", hidden_channels=8, dense_gc=8,
            batch_size=4, val_batch_size=4, epochs=2, save_iter=100,
            print_iter=1, device="cpu")


def _photo_case():
    rng = np.random.RandomState(5)
    a = rng.rand(8, 12, 14, 3).astype(np.float32)
    b = rng.rand(8, 12, 14, 3).astype(np.float32)
    # each rank's two rows keep another share of their pixels
    frac = np.repeat([0.9, 0.5, 0.2, 0.7], 2)[:, None, None, None]
    mask = (rng.rand(8, 12, 14, 1) < frac).astype(np.float32)
    terms = lambda x: {
        "l1": JP.masked_l1(x, b, mask, 1.0),
        "census": JP.census_loss(x, b, mask, 1.0, 3),
        "ssim": JP.ssim_loss(x, b, mask, 1.0)}
    ref = {k: float(v) for k, v in terms(jnp.asarray(a)).items()}
    grad = np.asarray(jax.grad(lambda x: sum(terms(x).values()))(
        jnp.asarray(a)))
    return {"a": a, "b": b, "mask": mask, "rows": 2}, ref, grad


def _local_case():
    """A flow step on the local windows (global 16 / 16 px pinned, local dy
    'auto' = 8) on 4 pairs of a moving texture."""
    vid = moving_texture_video(5, 24, 40, seed=3)
    kw = dict(net="RBF", num_frequencies=8, hidden_dim=16, num_layers=2,
              epochs=10, splat_max_dy=16, splat_max_dx=16)
    jcfg = JaxFlowConfig(**kw)
    from sin_inn_tpu.train import flow as JFT
    _, state, consts, _, _ = JFT.create_flow_state(jax.random.key(0), jcfg)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    batch = {"frame1": vid[:4], "frame2": vid[1:5],
             "times": np.linspace(-1, 1, 4, dtype=np.float32),
             "scale": np.float32(8.0)}
    return {"cfg": kw, "params": np_(state.params), "consts": np_(consts),
            "ctrl_state": None, "batch": batch}


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
def world4(tmp_path_factory):
    inp, ref = {}, {}
    inp["mmd"], ref["mmd"] = _sr_case(16, 2, key=5, lambda_fwd_mmd=1.0,
                                      lambda_bwd_mmd=1.0)
    inp["photo"], ref["photo"], ref["photo_grad"] = _photo_case()
    inp["local"] = _local_case()
    from test_torch_port_window_refit import _smooth
    inp["refit"] = {"video": moving_texture_video(3, 136, 160, seed=4),
                    "flow": _smooth(2, 136, 160, 2.0, drift_x=3.0,
                                    drift_y=9.0)}
    work = tmp_path_factory.mktemp("world4")
    inp["workdir_loops"] = str(work / "loops")
    torch.save(inp, work / "inputs.pt")
    outs = spawn(4, str(work), "world4")
    return outs, ref, inp, work


def test_mmd_under_dp4_matches_jax_single(world4):
    """Both MMD terms take the N x N kernel over the gathered batch."""
    outs, ref, inp, _ = world4
    for o in outs:
        assert o["mmd_aux"]["loss"] == pytest.approx(ref["mmd"]["loss"],
                                                     rel=1e-4)
    _grads_match(outs[0]["mmd_grads"], ref["mmd"]["grads"], inp["mmd"])


def test_photometric_mask_normalisation_over_uneven_shards(world4):
    """The masked losses normalise by the whole batch's mask (the ranks'
    shards keep 90, 50, 20 and 70% of their pixels): each rank holds JAX's
    whole-batch value, and its share of the gradient is JAX's gradient of
    its rows."""
    outs, ref, _, _ = world4
    for r, o in enumerate(outs):
        for k, v in ref["photo"].items():
            assert o["photo"][k] == pytest.approx(v, rel=1e-5), k
        np.testing.assert_allclose(o["photo_grad"],
                                   ref["photo_grad"][2 * r:2 * r + 2],
                                   atol=1e-7, rtol=1e-4)


def test_flow_step_on_local_windows_dp4_matches_single(world4):
    """The window monitors are maxima over the group, so every rank
    launches the same local windows; the step equals one process's."""
    outs, _, inp, _ = world4
    one = _flow_step(None, inp["local"])
    for o in outs:
        got = o["local_dp4"]
        assert set(got["metrics"]) == set(one["metrics"])
        assert "flow_dev_y" in got["metrics"]
        for k in ("flow_max_x", "flow_max_y", "flow_dev_x", "flow_dev_y"):
            assert got["metrics"][k] == pytest.approx(one["metrics"][k],
                                                      rel=1e-6), k
        assert got["metrics"]["loss"] == pytest.approx(
            one["metrics"]["loss"], rel=1e-4)
        for a, b in zip(got["params"], one["params"]):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_sr_train_loop_dp_matches_single(world4, tmp_path):
    outs, _, _, _ = world4
    cfg1 = SRConfig(**LOOP, working_dir=str(tmp_path / "one"), mesh_data=1)
    out1 = L.run_sr_train(cfg1, video=synthetic_sr_video(cfg1, h=16, w=16))
    assert out1["mesh"] is None and out1["primary"]
    for r, o in enumerate(outs):
        assert o["sr_loop"]["mesh"] == {"data": 4, "model": 1}
        assert o["sr_loop"]["primary"] == (r == 0)
        assert o["sr_loop"]["loss"] == pytest.approx(
            out1["metrics"]["loss"], rel=1e-3)


def test_sr_train_loop_dp2_in_world4_matches_single(world4, tmp_path):
    """DP 2 in a world of 4: ranks 2 and 3 sit the run out, and every
    collective of ranks 0 and 1 after that spans the mesh alone (one over
    the world would wait on the idle ranks for ever)."""
    outs, _, _, _ = world4
    cfg1 = SRConfig(**LOOP, working_dir=str(tmp_path / "one"), mesh_data=1)
    out1 = L.run_sr_train(cfg1, video=synthetic_sr_video(cfg1, h=16, w=16))
    assert [o["sr_dp2"].get("idle", False) for o in outs] == [
        False, False, True, True]
    for r, o in enumerate(outs[:2]):
        assert o["sr_dp2"]["mesh"] == {"data": 2, "model": 1}
        assert o["sr_dp2"]["primary"] == (r == 0)
        assert o["sr_dp2"]["loss"] == pytest.approx(
            out1["metrics"]["loss"], rel=1e-3)


def test_sr_train_loop_dp_writes_on_rank_zero_only(world4):
    _, _, inp, _ = world4
    exp = os.path.join(inp["workdir_loops"], "four", "train")
    (run,) = os.listdir(exp)
    files = os.listdir(os.path.join(exp, run))
    assert sum(f.endswith(".metrics.jsonl") for f in files) == 1
    steps = os.listdir(os.path.join(exp, run, "checkpoints"))
    assert steps == ["step_0000000002"]


def test_sr_train_loop_dp_ragged_tcr(world4, tmp_path):
    """18 supervised windows in batches of 4: the last batch of 2 (and its
    TCR batch) is computed whole on every rank."""
    outs, _, _, _ = world4
    cfg = SRConfig(**dict(LOOP, epochs=1, save_iter=10), lambda_bwd_tcr=0.1,
                   tcr_iters=1, working_dir=str(tmp_path / "r"), mesh_data=1)
    one = L.run_sr_train(cfg, video=synthetic_sr_video(cfg, h=16, w=16))
    for o in outs:
        assert np.isfinite(o["ragged"]["loss"])
        assert o["ragged"]["tcr"] != 0.0
        assert o["ragged"]["loss"] == pytest.approx(one["metrics"]["loss"],
                                                    rel=1e-3)
        assert o["ragged"]["tcr"] == pytest.approx(one["metrics"]["tcr"],
                                                   rel=1e-3)


def test_flow_train_loop_dp_with_val_epe(world4, tmp_path):
    outs, _, _, _ = world4
    cfg = FlowConfig(net="RBF", num_frequencies=8, hidden_dim=16,
                     num_layers=2, epochs=2, batch=4, val_iter=1,
                     test_batch=4, device="cpu", mesh_data=1,
                     checkpoints_dir=str(tmp_path / "ck"),
                     results_dir=str(tmp_path / "res"))
    media = FlowMedia(moving_texture_video(5, 8, 8),
                      flow=np.zeros((4, 8, 8, 2), np.float32))
    one = L.run_flow_train(cfg, media=media, scene="s", val_media=media)
    for o in outs:
        got = o["flow_loop"]
        assert got["mesh"] == {"data": 4, "model": 1}
        assert np.isfinite(got["loss"]) and np.isfinite(got["val_epe"])
        assert got["loss"] == pytest.approx(one["metrics"]["loss"],
                                            rel=1e-3)
        assert got["val_epe"] == pytest.approx(one["metrics"]["val_epe"],
                                               rel=1e-3)
    # every rank holds the same params
    for o in outs[1:]:
        for a, b in zip(o["flow_loop"]["params"],
                        outs[0]["flow_loop"]["params"]):
            np.testing.assert_array_equal(a, b)


def test_flow_train_loop_dp_refits_like_single(world4, tmp_path):
    """DP 2 in a world of 4: the probe and the refit decide from the whole
    batch's monitors, so both ranks of the mesh end on the windows of one
    process's run, with its params (the step rebuilt on the refitted
    windows keeps the mesh); ranks 2 and 3, outside the mesh, sit out."""
    from sin_inn_tpu_torch.core.config import FlowConfig
    from torch_port_dist_worker import refit_loop

    outs, _, inp, _ = world4
    one = refit_loop(inp["refit"], str(tmp_path / "one"), 1)
    probed = L._resolve_and_probe_splat_bounds(
        FlowConfig(size=136, test_size=136), FlowMedia(
            inp["refit"]["video"], inp["refit"]["flow"]), 136, 160)
    assert one["bounds"] != [getattr(probed, k)
                             for k in FlowConfig.WINDOW_BOUND_KEYS]
    assert [o["refit"].get("idle", False) for o in outs] == [
        False, False, True, True]
    for o in outs[:2]:
        got = o["refit"]
        assert got["bounds"] == one["bounds"]
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-4)
        for a, b in zip(got["params"], one["params"]):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_launcher_shards_scenes_by_rank(world4):
    outs, _, _, _ = world4
    scenes = [f"s{i}" for i in range(7)]
    for r, o in enumerate(outs):
        assert o["shard"] == scenes[r::4]


def test_initialize_distributed_contract(monkeypatch):
    """No arguments and no torchrun environment: a single process, False.
    Explicit arguments that cannot work raise (never a silent single-process
    run)."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        initialize_distributed("127.0.0.1:1234", 2, device="cpu")
    with pytest.raises(Exception):
        initialize_distributed("127.0.0.1:not-a-port", 2, 1, timeout_s=5,
                               device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        initialize_distributed("127.0.0.1:1234", 1, 0, device="cuda")
    assert not dist.is_initialized()


def test_config_multi_gpu_fields_match_jax():
    """The multi-GPU fields of both configs keep the JAX package's names
    and defaults."""
    for ours, theirs, names in (
            (SRConfig(), JaxSRConfig(),
             ("data_axis", "mesh_data", "mesh_model", "distributed",
              "dist_coordinator", "dist_num_processes", "dist_process_id")),
            (FlowConfig(), JaxFlowConfig(),
             ("data_axis", "mesh_data", "distributed", "dist_coordinator",
              "dist_num_processes", "dist_process_id", "power"))):
        for f in names:
            assert getattr(ours, f) == getattr(theirs, f), f
    assert {f.name for f in dataclasses.fields(SRConfig)} >= {
        "mesh_data", "mesh_model"}


def test_config_data_axis_names_the_one_batch_axis():
    """The port's mesh has one batch axis, "data": another name raises
    rather than being ignored."""
    for make in (SRConfig, FlowConfig):
        assert make(data_axis="data").data_axis == "data"
        with pytest.raises(ValueError, match="data_axis"):
            make(data_axis="batch")


def test_cli_multi_gpu_flags():
    import argparse

    from sin_inn_tpu_torch import cli

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command")
    cli._sr_parser(sub)
    cli._flow_parser(sub)
    a = ap.parse_args(["sr", "train", "--mesh_data", "4", "--mesh_model", "2",
                       "--distributed", "--dist_coordinator", "h:1",
                       "--dist_num_processes", "8", "--dist_process_id", "3"])
    cfg = cli.sr_config_from_args(a)
    assert (cfg.mesh_data, cfg.mesh_model, cfg.distributed,
            cfg.dist_coordinator, cfg.dist_num_processes,
            cfg.dist_process_id) == (4, 2, True, "h:1", 8, 3)
    a = ap.parse_args(["flow", "train", "--mesh-data", "2", "--distributed",
                       "--dist-coordinator", "h:2", "--dist-num-processes",
                       "2", "--dist-process-id", "1"])
    cfg = cli.flow_config_from_args(a)
    assert (cfg.mesh_data, cfg.distributed, cfg.dist_coordinator,
            cfg.dist_num_processes, cfg.dist_process_id) == (
        2, True, "h:2", 2, 1)
