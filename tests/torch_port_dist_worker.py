"""The ranks of the gloo worlds of ``tests/test_torch_port_parallel*.py``.

A test writes its inputs (numpy arrays, config kwargs) to ``inputs.pt`` in
a work directory, then :func:`spawn` starts ``world`` CPU processes with
``torch.multiprocessing`` that join one gloo process group through the
port's ``initialize_distributed`` and run one scenario of this module; each
rank writes ``out_<rank>.pt``. This module imports the port only (never
JAX), so the spawned ranks stay small.
"""

from __future__ import annotations

import logging
import os
import socket
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, workdir: str, scenario: str) -> List[Dict]:
    """Run ``scenario`` on ``world`` gloo ranks; returns every rank's
    output dict, rank order."""
    import torch.multiprocessing as mp

    mp.start_processes(_entry, args=(world, free_port(), workdir, scenario),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, port: int, workdir: str, scenario: str):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from sin_inn_tpu_torch.parallel.mesh import initialize_distributed

    assert initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                  timeout_s=300, device="cpu") == (world > 1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = SCENARIOS[scenario](rank, inp, workdir)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# SR
# ---------------------------------------------------------------------------

def _sr_case(case):
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.models import inn as TI
    from sin_inn_tpu_torch.models.convert import params_from_jax
    from sin_inn_tpu_torch.train import sr as SR

    cfg = SRConfig(**case["cfg"], device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    state = SR.train_state(params_from_jax(spec, case["params"]), cfg)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    d = case["draws"]
    draws = SR.SRDraws(*[None if d.get(k) is None else torch.from_numpy(d[k])
                         for k in ("z", "tcr_rand", "tcr_z")])
    unsup = ({k: torch.from_numpy(v) for k, v in case["unsup"].items()}
             if case.get("unsup") is not None else None)
    return cfg, spec, state, batch, unsup, draws


def _full_grads(mesh, state) -> List[np.ndarray]:
    """Every param's gradient in the optimizer's order, TP shards gathered
    whole over the model group."""
    import torch.distributed as dist

    from sin_inn_tpu_torch.parallel.sharding import _flat_with_opt_index
    specs = state.shardings or {}
    out = [None] * len(state.optimizer.param_groups[0]["params"])
    for path, t, i in _flat_with_opt_index(state):
        g = t.grad
        spec = specs.get(path, ())
        if "model" in spec:
            parts = [torch.empty_like(g) for _ in range(mesh.model)]
            dist.all_gather(parts, g.contiguous(), group=mesh.model_group)
            g = torch.cat(parts, dim=spec.index("model"))
        out[i] = g.detach().numpy().copy()
    return out


def _sr_loss_and_grads(mesh, case, model_parallel=False, **cfg_over):
    """The whole batch's loss, aux and full gradients of one sharded
    ``sr_loss`` (no optimizer step)."""
    from sin_inn_tpu_torch.parallel.sharding import (place_batch, place_state,
                                                     reduce_metrics,
                                                     sync_grads, tp_couplings)
    from sin_inn_tpu_torch.train import sr as SR

    cfg, spec, state, batch, unsup, draws = _sr_case(case)
    cfg = cfg.replace(**cfg_over)
    state = place_state(mesh, state, model_parallel=model_parallel)
    sup = place_batch(mesh, batch, allow_uneven=True)
    uns = (place_batch(mesh, unsup, allow_uneven=True)
           if unsup is not None else None)
    loss, aux = SR.sr_loss(state.params, spec, cfg, sup, uns,
                           SR.shard_draws(draws, mesh, sup, uns), mesh,
                           tp_couplings(mesh, state.shardings))
    loss.backward()
    sync_grads(mesh, state.optimizer.param_groups[0]["params"])
    aux = reduce_metrics(mesh, aux)
    return ({k: float(v) for k, v in aux.items()}, _full_grads(mesh, state),
            state)


def _tp_step(mesh, case):
    """One DP x TP train step: the whole batch's loss, conv1's shard shape
    and the whole params after the Adam step."""
    from sin_inn_tpu_torch.parallel.sharding import (full_state_dict,
                                                     place_batch, place_state)
    from sin_inn_tpu_torch.train import sr as SR

    cfg, spec, state, batch, _, draws = _sr_case(case)
    state = place_state(mesh, state, model_parallel=True)
    step = SR.make_train_step(spec, cfg, mesh)
    aux = step(state, place_batch(mesh, batch), None, draws=draws)
    glow = [p for p in state.params if p is not None][0]
    sd = full_state_dict(mesh, state)
    from sin_inn_tpu_torch.models.inn import flat_params
    return {"loss": float(aux["loss"]),
            "conv1_shape": tuple(glow["s1"]["conv1"]["w"].shape),
            "conv1_spec": state.shardings[(_first_glow(state.params), "s1",
                                           "conv1", "w")],
            "params": [t.detach().numpy().copy()
                       for t in flat_params(sd["params"])]}


def _first_glow(params) -> int:
    return next(i for i, p in enumerate(params) if p is not None)


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# ---------------------------------------------------------------------------
# Flow
# ---------------------------------------------------------------------------

def _flow_case(case):
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.models.convert import (ctrl_state_from_jax,
                                                  inr_params_from_jax)
    from sin_inn_tpu_torch.train import flow as FT

    cfg = FlowConfig(**case["cfg"], device="cpu")
    tp, tc = inr_params_from_jax(case["params"], case["consts"])
    spec, _, _, ctrl_cfg, _ = FT.build_flow_model(
        torch.Generator().manual_seed(0), cfg)
    ctrl_state = (ctrl_state_from_jax(case["ctrl_state"])
                  if case.get("ctrl_state") is not None else None)
    state = FT.train_state(tp, cfg, ctrl_cfg=ctrl_cfg, ctrl_state=ctrl_state)
    batch = {k: (float(v) if k == "scale" else torch.from_numpy(v))
             for k, v in case["batch"].items()}
    return cfg, spec, state, tc, batch


def _flow_step(mesh, case):
    """One sharded flow train step: the whole batch's metrics and the
    controller state after it."""
    from sin_inn_tpu_torch.parallel.sharding import place_batch, place_state
    from sin_inn_tpu_torch.train import flow as FT

    cfg, spec, state, consts, batch = _flow_case(case)
    if mesh is not None:
        state = place_state(mesh, state)
        batch = place_batch(mesh, batch, allow_uneven=True)
    m = FT.make_flow_train_step(spec, cfg, mesh)(state, consts, batch)
    out = {"metrics": {k: float(v) for k, v in m.items()}}
    if state.ctrl_state is not None:
        out["log_buffer"] = state.ctrl_state.log_buffer.numpy().copy()
        out["mask"] = state.ctrl_state.mask.numpy().copy()
    from sin_inn_tpu_torch.models.inr import flat_leaves
    out["params"] = [t.detach().numpy().copy()
                     for _, t in flat_leaves(state.params)]
    return out


def _flow_loss(mesh, case):
    from sin_inn_tpu_torch.parallel.sharding import (data_group, place_batch,
                                                     reduce_metrics)
    from sin_inn_tpu_torch.train import flow as FT

    cfg, spec, state, consts, batch = _flow_case(case)
    pb = place_batch(mesh, batch)
    with torch.no_grad():
        loss, aux = FT.flow_loss(spec, cfg, state.params, consts, pb,
                                 state.ctrl_cfg, state.ctrl_state,
                                 data_group(mesh, pb))
    return float(reduce_metrics(mesh, {"loss": loss})["loss"])


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def world8(rank: int, inp: Dict, workdir: str) -> Dict:
    """The 8-rank cases: DP 8 (and with remat), DP 4 x TP 2, DP 2 x TP 4,
    the hidden width TP 4 does not divide, the flow loss and the spatial
    controller step under DP 8, the dry run, and resolve_mesh's policy."""
    from sin_inn_tpu_torch.parallel.mesh import make_mesh
    from sin_inn_tpu_torch.train import loop as L

    out: Dict = {}
    m8 = make_mesh(8, 1)
    m42 = make_mesh(4, 2)
    m24 = make_mesh(2, 4)
    aux, _, _ = _sr_loss_and_grads(m8, inp["sr16"])
    out["dp8_loss"] = aux["loss"]
    aux, _, _ = _sr_loss_and_grads(m8, inp["sr16"], remat=True)
    out["dp8_remat_loss"] = aux["loss"]
    out["tp42_step"] = _tp_step(m42, inp["sr16_c2"])
    for name, mesh in (("tp42", m42), ("tp24", m24)):
        aux, grads, state = _sr_loss_and_grads(mesh, inp["sr16_c2"],
                                               model_parallel=True)
        out[f"{name}_loss"] = aux["loss"]
        out[f"{name}_grads"] = grads
        out[f"{name}_sharded"] = sorted(
            "/".join(map(str, p)) for p, s in state.shardings.items()
            if "model" in s)
    cap = _Capture()
    logging.getLogger("sin_inn_tpu_torch.parallel.sharding").addHandler(cap)
    aux, _, state = _sr_loss_and_grads(m24, inp["sr18"], model_parallel=True)
    out["tp18_loss"] = aux["loss"]
    out["tp18_warnings"] = cap.messages
    out["tp18_specs"] = {"/".join(map(str, p)): s
                         for p, s in state.shardings.items()}
    out["tp18_shapes"] = {"/".join(map(str, p)): tuple(t.shape)
                          for p, t in _paths(state.params)}
    out["flow_dp8_loss"] = _flow_loss(m8, inp["flow"])
    out["spatial_dp8"] = _flow_step(m8, inp["spatial"])
    # the dry run: DP 2 x TP 4 at hidden 64 on a zero batch, the spatial
    # controller's step under DP 8
    dry = _tp_step(m24, inp["dry_sr"])
    out["dry_sr_loss"] = dry["loss"]
    out["dry_flow_loss"] = _flow_step(m8, inp["dry_flow"])["metrics"]["loss"]
    # resolve_mesh's policy
    pol = {"b4": L.resolve_mesh(None, 1, batch_size=4).shape["data"],
           "b1": L.resolve_mesh(None, 1, batch_size=1),
           "one": L.resolve_mesh(1, 1, batch_size=4)}
    try:
        L.resolve_mesh(8, 1, batch_size=4)
        pol["indivisible"] = "no error"
    except ValueError as e:
        pol["indivisible"] = str(e)
    try:
        L.resolve_mesh(None, 16, batch_size=4)
        pol["too_wide"] = "no error"
    except ValueError as e:
        pol["too_wide"] = str(e)
    out["policy"] = pol
    return out


def _paths(params):
    from sin_inn_tpu_torch.parallel.sharding import _param_paths
    return _param_paths(params)


def world4(rank: int, inp: Dict, workdir: str) -> Dict:
    """The 4-rank cases: the MMD terms and the photometric mask
    normalisation under DP 4, a flow step on the local windows, the
    production loops (``run_sr_train`` on the IRN, with TCR on a ragged
    batch, ``run_flow_train`` with the validation EPE, the refit and
    ``run_sr_train`` on meshes of 2 in the world of 4) and the launcher's
    scene shard."""
    from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import (moving_texture_video,
                                                  synthetic_sr_video)
    from sin_inn_tpu_torch.ops import photometric as P
    from sin_inn_tpu_torch.parallel.launcher import shard_for_process
    from sin_inn_tpu_torch.parallel.mesh import make_mesh
    from sin_inn_tpu_torch.train import loop as L

    out: Dict = {}
    m4 = make_mesh(4, 1)
    aux, grads, _ = _sr_loss_and_grads(m4, inp["mmd"])
    out["mmd_aux"], out["mmd_grads"] = aux, grads

    # the photometric losses on this rank's shard of uneven masks, and the
    # gradient of their sum with respect to the shard
    ph = inp["photo"]
    sl = slice(rank * ph["rows"], (rank + 1) * ph["rows"])
    a = torch.from_numpy(ph["a"][sl]).requires_grad_(True)
    b = torch.from_numpy(ph["b"][sl])
    m = torch.from_numpy(ph["mask"][sl])
    g = m4.data_group
    terms = {"l1": P.masked_l1(a, b, m, 1.0, g),
             "census": P.census_loss(a, b, m, 1.0, 3, g),
             "ssim": P.ssim_loss(a, b, m, 1.0, group=g)}
    sum(terms.values()).backward()
    # every rank's backward sums the upstream gradient over the group, so
    # a quarter of it is this shard's gradient of the whole batch's loss
    # (what averaging over the data group gives the params)
    out["photo"] = {k: float(v) for k, v in terms.items()}
    out["photo_grad"] = (a.grad / 4.0).numpy().copy()

    # a flow step on the local windows, DP 4 against this process alone
    out["local_dp4"] = _flow_step(m4, inp["local"])

    # the production loops
    work = inp["workdir_loops"]
    base = dict(scale=2, num_coupling=1, lr_window=1, fps=30,
                architecture="IRN", hidden_channels=8, dense_gc=8,
                batch_size=4, val_batch_size=4, epochs=2, save_iter=100,
                print_iter=1, device="cpu")
    cfg4 = SRConfig(**base, working_dir=os.path.join(work, "four"),
                    mesh_data=4)
    srv = synthetic_sr_video(cfg4, h=16, w=16)
    o = L.run_sr_train(cfg4, video=srv)
    out["sr_loop"] = {"loss": o["metrics"]["loss"],
                      "mesh": o["mesh"].shape, "primary": o["primary"]}
    cfgr = SRConfig(**dict(base, epochs=1, save_iter=10),
                    lambda_bwd_tcr=0.1, tcr_iters=1,
                    working_dir=os.path.join(work, "ragged"), mesh_data=4)
    o = L.run_sr_train(cfgr, video=synthetic_sr_video(cfgr, h=16, w=16))
    out["ragged"] = {k: o["metrics"][k] for k in ("loss", "tcr")}
    fcfg = FlowConfig(net="RBF", num_frequencies=8, hidden_dim=16,
                      num_layers=2, epochs=2, batch=4, val_iter=1,
                      test_batch=4, device="cpu",
                      checkpoints_dir=os.path.join(work, "ck"),
                      results_dir=os.path.join(work, "res"), mesh_data=4)
    frames = moving_texture_video(5, 8, 8)
    media = FlowMedia(frames, flow=np.zeros((4, 8, 8, 2), np.float32))
    o = L.run_flow_train(fcfg, media=media, scene="s", val_media=media)
    from sin_inn_tpu_torch.models.inr import flat_leaves
    out["flow_loop"] = {"loss": o["metrics"]["loss"],
                        "val_epe": o["metrics"]["val_epe"],
                        "mesh": o["mesh"].shape,
                        "params": [t.detach().numpy().copy() for _, t in
                                   flat_leaves(o["state"].params)]}
    out["shard"] = shard_for_process([f"s{i}" for i in range(7)])
    out["refit"] = refit_loop(inp["refit"], os.path.join(work, "refit"), 2)
    # a mesh smaller than the world: ranks 2 and 3 sit the run out, and
    # ranks 0 and 1 must meet only each other in every collective
    cfg2 = SRConfig(**base, working_dir=os.path.join(work, "two"),
                    mesh_data=2)
    o = L.run_sr_train(cfg2, video=synthetic_sr_video(cfg2, h=16, w=16))
    out["sr_dp2"] = ({"idle": True} if o["state"] is None else
                     {"loss": o["metrics"]["loss"], "mesh": o["mesh"].shape,
                      "primary": o["primary"]})
    return out


def refit_loop(case: Dict, ckpt: str, mesh_data: int) -> Dict:
    """``run_flow_train`` on GT flow at 136 x 160, batch 2, the windows
    probed and refitted at the saves (the step rebuilt on the new windows):
    the bounds it ends on, its metrics and params. With ``mesh_data`` 2 in
    a world of 4, ranks 2 and 3 sit the run out."""
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.models.inr import flat_leaves
    from sin_inn_tpu_torch.train import loop as L

    h = case["video"].shape[1]
    cfg = FlowConfig(device="cpu", num_frequencies=16, hidden_dim=16,
                     num_layers=2, size=h, test_size=h, lr=1e-3, epochs=2,
                     batch=2, checkpoints_dir=ckpt, mesh_data=mesh_data,
                     results_dir=ckpt + "_results")
    o = L.run_flow_train(cfg, media=FlowMedia(case["video"], case["flow"]),
                         scene="clip")
    if o["state"] is None:
        return {"idle": True, "primary": o["primary"]}
    return {"bounds": [getattr(o["cfg"], k)
                       for k in FlowConfig.WINDOW_BOUND_KEYS],
            "loss": o["metrics"]["loss"],
            "params": [t.detach().numpy().copy()
                       for _, t in flat_leaves(o["state"].params)]}


SCENARIOS = {"world8": world8, "world4": world4}
