"""Training trajectories of the port held against the JAX package on the
CPU, and ``tools/validate_torch.py`` at tiny sizes.

Flow: the progressive PFF net (8 frequencies, hidden 16, 2 layers, the
linear controller over a 400-step schedule; lr 3e-3, census 0.1, smooth
0.1, wang) on ``synthetic_flow_sequence("rotation", 5, 32, 40, magnitude=3)``
at flow scale W/5, JAX's params, consts and controller state carried
across, both plain routes (``use_pallas="off"`` / ``use_kernel="off"``),
200 steps. Two fp32 stacks sum in other orders, and the difference grows
along the trajectory: the EPE agrees within 1e-4 px at every step through
step 60 (measured: at most 8.4e-5, about steps 45-54) and within 1e-2 px
at every 20th step after (measured: at most 5.4e-3, at step 160) while the
EPE falls 2.58 -> 0.59.

SR: the configuration of ``tests/test_convergence.py``'s SR band (IRN,
scale 2, one coupling, hidden 16, natural texture 24 x 24, batch 4, lr
1e-3) for 10 epochs, JAX's init and JAX's per-step z passed to the port's
step; loss within a relative 1e-5 (measured: at most 1.1e-6) and the val
HR-PSNR under one shared z within 1e-4 dB (measured: at most 5.3e-6) at
every epoch.
"""

import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core import rng as JR
from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.data.sr_video import make_datasets
from sin_inn_tpu.data.synthetic import (synthetic_flow_sequence,
                                        synthetic_sr_video)
from sin_inn_tpu.train import flow as JF
from sin_inn_tpu.train import sr as JSR
from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import (ctrl_state_from_jax,
                                              inr_params_from_jax,
                                              params_from_jax)
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import sr as TSR

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import validate_torch as V  # noqa: E402

FLOW = dict(net="PFF", num_frequencies=8, hidden_dim=16, num_layers=2,
            epochs=400, lr=3e-3, loss_census=0.1, loss_smooth1=0.1,
            occl="wang")
SR = dict(architecture="IRN", scale=2, num_coupling=1, lr_window=1, fps=30,
          hidden_channels=16, dense_gc=8, batch_size=4, val_batch_size=4,
          epochs=10, learning_rate=1e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def test_flow_trajectory_matches_jax_over_200_steps():
    h, w, steps = 32, 40, 200
    frames, flows = synthetic_flow_sequence("rotation", 5, h, w,
                                            magnitude=3.0)
    b = frames.shape[0] - 1
    scale = np.float32(w / 5)
    jb = {"frame1": jnp.asarray(frames[:-1]),
          "frame2": jnp.asarray(frames[1:]),
          "times": jnp.linspace(-1, 1, b), "scale": jnp.asarray(scale),
          "gt_flow": jnp.asarray(flows)}
    tb = {"frame1": torch.from_numpy(frames[:-1]),
          "frame2": torch.from_numpy(frames[1:]),
          "times": torch.linspace(-1, 1, b), "scale": float(scale),
          "gt_flow": torch.from_numpy(flows)}
    jcfg = JaxFlowConfig(**FLOW, use_pallas="off")
    tcfg = FlowConfig(**FLOW, use_kernel="off", device="cpu")
    spec, jstate, consts, ctrl_cfg, tx = JF.create_flow_state(
        jax.random.key(0), jcfg)
    assert ctrl_cfg is not None            # the linear ramp
    jstep = JF.make_flow_train_step(spec, jcfg, ctrl_cfg, tx)
    tp, tc = inr_params_from_jax(_np(jstate.params), _np(consts))
    tspec, _, _, tctrl, _ = TF.build_flow_model(
        torch.Generator().manual_seed(0), tcfg)
    tstate = TF.train_state(tp, tcfg, ctrl_cfg=tctrl,
                            ctrl_state=ctrl_state_from_jax(
                                _np(jstate.ctrl_state)))
    tstep = TF.make_flow_train_step(tspec, tcfg)
    epes = []
    for i in range(steps):
        jstate, jm = jstep(jstate, consts, jb)
        tm = tstep(tstate, tc, tb)
        je, te = float(jm["epe"]), float(tm["epe"])
        epes.append(te)
        limit = 1e-4 if i < 60 else 1e-2
        if i < 60 or (i + 1) % 20 == 0:
            assert abs(je - te) <= limit, (i + 1, je, te)
    assert epes[0] > 2.0
    assert epes[-1] < 0.65 and epes[-1] < 0.3 * epes[0], (epes[0], epes[-1])


def test_sr_trajectory_matches_jax_over_10_epochs():
    jcfg = JaxSRConfig(**SR, donate_state=False)
    tcfg = SRConfig(**SR, device="cpu")
    video = synthetic_sr_video(jcfg, h=24, w=24, texture="natural")
    spec, jstate, tx = JSR.create_train_state(jax.random.key(0), jcfg)
    jstep = JSR.make_train_step(spec, jcfg, tx)
    jeval = JSR.make_eval_step(spec, jcfg)
    sup, _, val = make_datasets(video, jcfg)
    cached = sup.device_cache(jcfg.batch_size)
    vb = next(iter(val.batches(4)))
    key = JR.named_fold(JR.root_key(0), "t")
    tspec, _ = TI.build_inn_spec(tcfg)
    tstate = TSR.train_state(params_from_jax(tspec, _np(jstate.params)),
                             tcfg)
    tstep = TSR.make_train_step(tspec, tcfg)
    teval = TSR.make_eval_step(tspec, tcfg)
    tbatches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                for b in cached]
    tvb = {k: torch.from_numpy(np.array(v)) for k, v in vb.items()}
    n, vh, vw = tvb["lr"].shape[:3]
    z_eval = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(1), (n, vh, vw, jcfg.z_dims), jnp.float32)))
    step = 0
    for _ in range(jcfg.epochs):
        for jb, tb in zip(cached, tbatches):
            jstate, jaux = jstep(jstate, jb, None, key)
            # the z JAX's sr_loss draws from fold_in(key, step)
            k_z, _ = jax.random.split(jax.random.fold_in(key, step))
            b, h, w = tb["lr"].shape[:3]
            z = np.array(jax.random.normal(k_z, (b, h, w, jcfg.z_dims),
                                           jnp.float32))
            taux = tstep(tstate, tb, draws=TSR.SRDraws(torch.from_numpy(z)))
            step += 1
        jl, tl = float(jaux["loss"]), float(taux["loss"])
        assert abs(jl - tl) <= 1e-5 * abs(jl), (step, jl, tl)
        jp = float(jeval(jstate.params, vb, jax.random.key(1))["hr_psnr"])
        tp = float(teval(tstate.params, tvb, z=z_eval)["hr_psnr"])
        assert abs(jp - tp) <= 1e-4, (step, jp, tp)
    assert tstate.step == step == int(jstate.step)


# ---------------------------------------------------------------------------
# tools/validate_torch.py at tiny sizes on the CPU
# ---------------------------------------------------------------------------

JAX_SR_KEYS = {"check", "arch", "dtype", "texture", "epochs", "loss_traj",
               "hr_psnr", "psnr_traj", "monotone", "wall_s"}
JAX_FLOW_KEYS = {"check", "net", "iters", "fixture", "magnitude", "scale",
                 "spatial", "splat_local_dy", "epe0", "epe", "psnr",
                 "epe_traj", "psnr_traj", "milestone_stride",
                 "frames_per_sec", "wall_s"}
JAX_LOOP_KEYS = {"check", "epochs", "size", "gt", "wall_s", "frames_per_sec",
                 "final_loss", "epe", "bounds", "sidecar"}
PORT_KEYS = {"device", "card", "launches", "band", "within_band", "seed"}


def _milestones(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_tool_sr_prints_the_jax_keys():
    buf = io.StringIO()
    r = V.validate_sr(6, device="cpu", h=16, w=16, out=buf)
    assert JAX_SR_KEYS | PORT_KEYS | {"use_kernel"} <= set(r)
    assert r["device"] == "cpu" and r["card"] is None
    assert r["launches"] == {}            # the plain versions launch nothing
    rows = _milestones(buf)
    assert [m["epoch"] for m in rows] == [1, 2, 3, 4, 5, 6]
    assert [m["loss"] for m in rows] == r["loss_traj"]
    assert r["band"] is None and r["within_band"] is None   # off the table
    assert all(np.isfinite(r["loss_traj"] + r["psnr_traj"]))


def test_tool_flow_rotation_prints_the_jax_keys():
    buf = io.StringIO()
    r = V.validate_flow(20, fixture="rotation", magnitude=3.0, device="cpu",
                        h=24, w=40, out=buf, num_frequencies=8,
                        hidden_dim=16, num_layers=2)
    assert JAX_FLOW_KEYS | PORT_KEYS | {"use_kernel"} <= set(r)
    assert r["milestone_stride"] == 2 and len(r["epe_traj"]) == 10
    assert [m["iter"] for m in _milestones(buf)] == r["milestone_iters"]
    assert r["bounds"]["splat_max_dy"] == 64 and r["launches"] == {}
    assert np.isfinite(r["epe0"]) and np.isfinite(r["epe"])
    # the band is read only at the table's size
    assert V.flow_band(dict(r, size=list(V.SINTEL)))[0] == "last <= 0.66"
    assert r["within_band"] is None


def test_flow_bands_follow_the_table():
    r = {"size": list(V.SINTEL), "scale": 1.0, "fixture": "shift",
         "magnitude": 2.0, "net": "RBF", "spatial": False,
         "splat_local_dy": "off", "milestone_iters": [150, 300, 450],
         "epe_traj": [0.2, 0.04, 0.045], "epe": 0.045}
    text, ok = V.flow_band(r)
    assert "median" in text and ok
    assert not V.flow_band(dict(r, epe_traj=[0.2, 0.06, 0.045]))[1]
    assert V.flow_band(dict(r, splat_local_dy="auto"))[1]
    assert V.flow_band(dict(r, net="PFF", spatial=True)) == (
        "last <= 0.06", True)
    assert not V.flow_band(dict(r, fixture="occlusion", magnitude=3.0))[1]
    assert V.flow_band(dict(r, fixture="zoom", magnitude=2.0)) == (None,
                                                                   None)


def test_tool_loop_prints_the_jax_keys(tmp_path):
    buf = io.StringIO()
    r = V.loop_check(2, size=24, device="cpu", directory=str(tmp_path),
                     out=buf, num_frequencies=8, hidden_dim=16, num_layers=2)
    assert JAX_LOOP_KEYS | PORT_KEYS <= set(r)
    assert r["size"] == [24, 128] and r["gt"] and r["sidecar"]
    assert r["within_band"] is True
    assert set(r["bounds"]) == set(FlowConfig.WINDOW_BOUND_KEYS)
    assert _milestones(buf)[-1]["step"] == 1     # the metrics row's epoch


def test_flow_media_batches_are_contiguous_for_any_layout():
    """The loop's shift media come out of ``np.apply_along_axis`` in a
    channels-first layout; ``FlowMedia`` stores C-contiguous copies, so
    the device batches are the NHWC tensors the kernels take (the gather
    kernel refused the strided frames on the card)."""
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.train.loop import _to_device_batch

    frames, flow = V.synthetic_media(h=16, w=32)
    assert not frames.flags.c_contiguous
    media = FlowMedia(frames, flow)
    assert np.array_equal(media.video, frames)
    batch = _to_device_batch(next(iter(media.batches(3))), "cpu")
    assert all(v.is_contiguous() for k, v in batch.items() if k != "scale")


def test_tool_cli_loop_on_the_cpu(tmp_path, capsys):
    assert V.main(["loop", "--device", "cpu", "--size", "24", "--epochs",
                   "1", "--no-gt", "--dir", str(tmp_path)]) == 0
    r = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert r["check"] == "flow_loop_e2e" and r["gt"] is False
    assert r["within_band"] is True and r["device"] == "cpu"


@pytest.mark.parametrize("argv", [["sr", "--epochs", "1"],
                                  ["flow", "--iters", "1"],
                                  ["loop", "--epochs", "1"]])
def test_tool_raises_without_a_card(argv, monkeypatch):
    """The default device is the card; without one the tool raises before
    any work, and never runs on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main(argv)
