"""Convergence bands of the port on the CPU: the counterparts of
``tests/test_convergence.py``, slow-marked as those are.

- The hard-fixture flow bands (rotation, zoom, the occluder under wang and
  brox), from the JAX tests' init carried across (rotation also from the
  port's own), and the SR band on the natural texture from the port's own
  init: the port's steps alone, at the JAX tests' sizes, steps and bands.
- Converged parity with the port in the torch replica's place
  (``tools/convergence_parity.py``): the JAX package and the port train to
  a plateau from the same init, batch schedule and z draws, and the
  converged metric must agree: SR |val PSNR gap| < 0.1 dB after 400 steps
  (with the last checkpoint's move < 0.5 dB), flow |EPE gap| < 0.1 px with
  both EPEs < 0.2 px after 600 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.data.sr_video import SRDataset, train_indices, val_indices
from sin_inn_tpu.data.synthetic import (moving_texture_video,
                                        synthetic_sr_video)
from sin_inn_tpu.models.inn import inn_apply as jax_inn_apply
from sin_inn_tpu.ops import losses as JL
from sin_inn_tpu.train import flow as JF
from sin_inn_tpu.train import sr as JSR
from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
from sin_inn_tpu_torch.data import sr_video as TV
from sin_inn_tpu_torch.data.synthetic import synthetic_flow_sequence
from sin_inn_tpu_torch.data.synthetic import \
    synthetic_sr_video as port_sr_video
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import (ctrl_state_from_jax,
                                              inr_params_from_jax,
                                              params_from_jax)
from sin_inn_tpu_torch.ops import losses as TL
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import sr as TSR
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _port_flow(kind, magnitude, occl, init, steps=400, h=32, w=40):
    """(initial EPE, EPE after ``steps``) of the port's train step on the
    fixture; ``init`` "jax": the JAX test's init (``jax.random.key(0)``)
    carried across, "port": the port's own seed-0 init."""
    frames, flows = synthetic_flow_sequence(kind, 5, h, w, seed=0,
                                            magnitude=magnitude)
    b = frames.shape[0] - 1
    batch = {"frame1": torch.from_numpy(frames[:-1]),
             "frame2": torch.from_numpy(frames[1:]),
             "times": torch.linspace(-1, 1, b), "scale": float(w / 5),
             "gt_flow": torch.from_numpy(flows)}
    kw = dict(net="PFF", num_frequencies=8, hidden_dim=16, num_layers=2,
              epochs=steps, lr=3e-3, loss_census=0.1, loss_smooth1=0.1,
              occl=occl)
    cfg = FlowConfig(**kw, device="cpu")
    spec, state, consts = TF.create_flow_state(
        R.named_fold(R.root_generator(0), "init"), cfg)
    if init == "jax":
        _, jstate, jconsts, _, _ = JF.create_flow_state(
            jax.random.key(0), JaxFlowConfig(**kw))
        params, consts = inr_params_from_jax(_np(jstate.params),
                                             _np(jconsts))
        state = TF.train_state(params, cfg, ctrl_cfg=state.ctrl_cfg,
                               ctrl_state=ctrl_state_from_jax(
                                   _np(jstate.ctrl_state)))
    step = TF.make_flow_train_step(spec, cfg)
    m0 = step(state, consts, batch)
    for _ in range(steps):
        m = step(state, consts, batch)
    return float(m0["epe"]), float(m["epe"])


# The JAX test's init for the four bands. From the port's own seed-0 init
# the brox run turns non-finite at step 133, as the JAX package does from
# that same init (PERF.md section 6); rotation is also run from it.
@pytest.mark.parametrize("kind,magnitude,occl,band,init", [
    ("rotation", 3.0, "wang", 0.30, "jax"),
    ("zoom", 4.0, "wang", 0.33, "jax"),
    ("occlusion", 2.0, "wang", 0.50, "jax"),
    ("occlusion", 2.0, "brox", 0.80, "jax"),
    ("rotation", 3.0, "wang", 0.30, "port"),
])
def test_port_flow_converges_on_hard_fixture(kind, magnitude, occl, band,
                                             init):
    epe0, epe = _port_flow(kind, magnitude, occl, init)
    assert epe0 > 1.5, f"fixture degenerate: initial EPE {epe0}"
    assert epe < band, f"{kind} (occl={occl}): EPE {epe:.4f} > band {band}"


def test_port_sr_converges_on_natural_texture():
    cfg = SRConfig(architecture="IRN", scale=2, num_coupling=1, lr_window=1,
                   fps=30, hidden_channels=16, dense_gc=8, batch_size=4,
                   val_batch_size=4, epochs=60, learning_rate=1e-3,
                   device="cpu")
    video = port_sr_video(cfg, h=24, w=24, texture="natural")
    spec, state = TSR.create_train_state(
        R.named_fold(R.root_generator(0), "init"), cfg)
    step = TSR.make_train_step(spec, cfg)
    ev = TSR.make_eval_step(spec, cfg)
    sup, _, val = TV.make_datasets(video, cfg)
    cached = sup.device_cache(cfg.batch_size, "cpu")
    vb = TV.to_device(next(iter(val.batches(4))), "cpu")
    gen = R.named_fold(R.root_generator(0), "t")
    val_gen = lambda: R.named_fold(R.root_generator(1), "val")
    psnr0 = float(ev(state.params, vb, val_gen())["hr_psnr"])
    for _ in range(cfg.epochs):
        for b in cached:
            aux = step(state, b, None, gen)
    psnr = float(ev(state.params, vb, val_gen())["hr_psnr"])
    assert float(aux["loss"]) < 3.0, float(aux["loss"])
    assert psnr - psnr0 > 0.4, (psnr0, psnr)


# ---------------------------------------------------------------------------
# converged parity: the JAX package against the port, from one init
# ---------------------------------------------------------------------------

def test_sr_converged_parity_vs_port():
    h, w, steps, bs = 48, 80, 400, 2
    kw = dict(architecture="SRF", scale=2, num_coupling=2, lr_window=1,
              hidden_channels=32, dense_gc=8, fps=30, batch_size=bs,
              learning_rate=1e-3, weight_decay=1e-5)
    jcfg = JaxSRConfig(**kw, donate_state=False, use_pallas="off")
    tcfg = SRConfig(**kw, device="cpu")
    video = synthetic_sr_video(jcfg, h=h, w=w, texture="natural")
    tr = SRDataset(video, jcfg, train_indices(jcfg, video.num_lr))
    va = SRDataset(video, jcfg, val_indices(jcfg, video.num_lr, k=2))
    batches = [tr.gather(np.arange(s, min(s + bs, len(tr))))
               for s in range(0, len(tr), bs)]
    val_batch = va.gather(np.arange(len(va)))
    spec, jstate, tx = JSR.create_train_state(jax.random.key(0), jcfg)
    jstep = JSR.make_train_step(spec, jcfg, tx)
    tspec, _ = TI.build_inn_spec(tcfg)
    tstate = TSR.train_state(params_from_jax(tspec, _np(jstate.params)),
                             tcfg)
    tstep = TSR.make_train_step(tspec, tcfg)
    base_key = jax.random.key(42)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tb = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
          for b in batches]
    vb, vh, vw = val_batch["lr"].shape[:3]
    z_eval = np.array(jax.random.normal(jax.random.key(77),
                                        (vb, vh, vw, jcfg.z_dims)))
    lr_val = val_batch["lr"].astype(np.float32) / 255.0
    hr_val = val_batch["hr"].astype(np.float32) / 255.0
    lrz = np.concatenate([lr_val, z_eval], -1)

    def psnr_jax(params):
        hr_hat = jax_inn_apply(spec, params, jnp.asarray(lrz), rev=True)
        return float(JL.psnr(jnp.clip(hr_hat, 0, 1), jnp.asarray(hr_val)))

    def psnr_port():
        with torch.no_grad():
            hr_hat = TI.inn_apply(tspec, tstate.params,
                                  torch.from_numpy(lrz), rev=True)
            return float(TL.psnr(torch.clamp(hr_hat, 0, 1),
                                 torch.from_numpy(hr_val)))

    gaps, psnrs = [], []
    for i in range(steps):
        bi = i % len(jb)
        jstate, _ = jstep(jstate, jb[bi], None, base_key)
        k_z, _ = jax.random.split(jax.random.fold_in(base_key, i))
        b, lh, lw = tb[bi]["lr"].shape[:3]
        z = np.array(jax.random.normal(k_z, (b, lh, lw, jcfg.z_dims)))
        tstep(tstate, tb[bi], draws=TSR.SRDraws(torch.from_numpy(z)))
        if (i + 1) % (steps // 8) == 0:
            pj, pt = psnr_jax(jstate.params), psnr_port()
            psnrs.append(pj)
            gaps.append(pj - pt)
    assert abs(gaps[-1]) < 0.1, gaps
    assert abs(psnrs[-1] - psnrs[-2]) < 0.5, psnrs


def test_flow_converged_parity_vs_port():
    h, w, steps, nf = 32, 48, 600, 3
    kw = dict(net="RBF", num_frequencies=64, hidden_dim=64, num_layers=3,
              epochs=steps, lr=3e-3, splat_max_dy=None,
              compute_dtype="float32")
    jcfg = JaxFlowConfig(**kw, use_pallas="off")
    tcfg = FlowConfig(**kw, device="cpu")
    base = moving_texture_video(1, h, w + 2 * nf + 2, seed=3)[0]
    frames = np.stack([base[:, 2 * i:2 * i + w] for i in range(nf)])
    b = nf - 1
    scale = np.float32(w / 5.0)
    gt = np.zeros((b, h, w, 2), np.float32)
    gt[..., 0] = -2.0
    jb = {"frame1": jnp.asarray(frames[:-1]),
          "frame2": jnp.asarray(frames[1:]),
          "times": jnp.linspace(-1, 1, b, dtype=jnp.float32),
          "scale": jnp.asarray(scale)}
    tb = {"frame1": torch.from_numpy(frames[:-1]),
          "frame2": torch.from_numpy(frames[1:]),
          "times": torch.linspace(-1, 1, b), "scale": float(scale)}
    spec, jstate, consts, ctrl_cfg, tx = JF.create_flow_state(
        jax.random.key(0), jcfg)
    assert ctrl_cfg is None
    jstep = JF.make_flow_train_step(spec, jcfg, ctrl_cfg, tx)
    tp, tc = inr_params_from_jax(_np(jstate.params), _np(consts))
    tspec = TF.build_flow_model(torch.Generator().manual_seed(0), tcfg)[0]
    tstate = TF.train_state(tp, tcfg)
    tstep = TF.make_flow_train_step(tspec, tcfg)
    for _ in range(steps):
        jstate, _ = jstep(jstate, consts, jb)
        tstep(tstate, tc, tb)
    fj, _, _ = JF.flow_forward(spec, jstate.params, consts, ctrl_cfg, None,
                               jb["times"], h, w, jb["scale"])
    epe_jax = float(JF.epe(fj, jnp.asarray(gt)))
    ft, _ = TF.flow_infer(tspec, tstate.params, tc, tb["times"], tb["scale"],
                          h, w)
    epe_port = float(TF.epe(ft, torch.from_numpy(gt)))
    assert epe_jax < 0.2 and epe_port < 0.2, (epe_jax, epe_port)
    assert abs(epe_jax - epe_port) < 0.1, (epe_jax, epe_port)
