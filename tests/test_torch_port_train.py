"""The port's training path held against the JAX package on the CPU.

MMD, the affine warp and TCR (atol 1e-5); Adam with coupled L2 against
optax (atol 1e-7 over 3 steps); ``sr_loss`` and its per-leaf gradients with
the same params, batches and noise (drawn in JAX exactly as its ``sr_loss``
draws them): loss rtol 1e-5 and each gradient leaf within a normwise
relative error of 1e-4 (fp32 sums in another order, amplified by up to
e^1.2 per coupling); one train step (params atol 1e-6); ``remat``;
``run_sr_train`` with resume; and the ``sr train`` CLI end to end.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.models import inn as JI
from sin_inn_tpu.ops import losses as JL
from sin_inn_tpu.ops import tcr as JT
from sin_inn_tpu.ops import warp as JW
from sin_inn_tpu.train import optim as JO
from sin_inn_tpu.train import sr as JSR
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import params_from_jax
from sin_inn_tpu_torch.ops import losses as TL
from sin_inn_tpu_torch.ops import tcr as TT
from sin_inn_tpu_torch.ops import warp as TW
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.train import loop as LP
from sin_inn_tpu_torch.train import optim as TO
from sin_inn_tpu_torch.train import sr as TSR
from test_torch_port_sr_test import _write_dataset
from torch_port_helpers import np_params
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(lr_window=1, num_coupling=2, hidden_channels=16, fps=30)
TCR_MMD = dict(lambda_bwd_tcr=1.0, tcr_iters=2, lambda_fwd_mmd=1.0,
               lambda_bwd_mmd=1.0)
HR = 16
B = 2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("rev", [False, True])
def test_mmd_matches_jax(rng, rev):
    x = rng.randn(3, 4, 4, 5).astype(np.float32)
    y = rng.randn(3, 4, 4, 5).astype(np.float32)
    ref, jgrad = jax.value_and_grad(
        lambda a: JL.mmd(a, jnp.asarray(y), rev=rev))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = TL.mmd(xt, _t(y), rev=rev)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=1e-5)
    # the zero self-distances take half the gradient, as in JAX's clip
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), atol=1e-5)
    assert TL.MMD_KERNELS_FWD == JL.MMD_KERNELS_FWD
    assert TL.MMD_KERNELS_REV == JL.MMD_KERNELS_REV


def test_rotation_matrix_and_warp_affine_match_jax(rng):
    img = rng.rand(3, 9, 11, 4).astype(np.float32)
    center = rng.rand(3, 2).astype(np.float32) * 8
    angle = (rng.rand(3).astype(np.float32) - 0.5) * 20
    scale = 1 + 0.1 * rng.rand(3).astype(np.float32)
    jm = JW.rotation_matrix_2d(jnp.asarray(center), jnp.asarray(angle),
                               jnp.asarray(scale))
    tm = TW.rotation_matrix_2d(_t(center), _t(angle), _t(scale))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    jm = jm.at[:, :, 2].add(1.5)          # shifts that leave the image
    np.testing.assert_allclose(
        TW.warp_affine(_t(img), _t(jm)).numpy(),
        np.asarray(JW.warp_affine(jnp.asarray(img), jm)), atol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_sample_bilinear_matches_jax(rng, padding):
    img = rng.rand(2, 6, 7, 3).astype(np.float32)
    x = (rng.rand(2, 5, 4) * 10 - 2).astype(np.float32)
    y = (rng.rand(2, 5, 4) * 9 - 2).astype(np.float32)
    ref = JW.sample_bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                             padding=padding)
    got = TW.sample_bilinear(_t(img), _t(x), _t(y), padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("scale,stop_grad", [(1.0, False), (0.25, True)])
def test_tcr_transform_matches_jax(rng, scale, stop_grad):
    img = rng.rand(2, 8, 10, 5).astype(np.float32)
    rand = rng.rand(2, 3).astype(np.float32)
    ref = JT.tcr_transform(jnp.asarray(img), jnp.asarray(rand), 5.0, 5.0,
                           scale=scale, stop_grad=stop_grad)
    src = _t(img).requires_grad_(True)
    got = TT.tcr_transform(src, _t(rand), 5.0, 5.0, scale=scale,
                           stop_grad=stop_grad)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    assert got.requires_grad is not stop_grad


def test_adam_l2_matches_optax(rng):
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in p0]
             for _ in range(3)]
    tx = JO.adam_l2(1e-2, (0.9, 0.99), weight_decay=1e-2)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [_t(p).requires_grad_(True) for p in p0]
    opt = TO.adam_l2(tp, 1e-2, (0.9, 0.99), weight_decay=1e-2)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = _t(x)
        opt.step()
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-7)


# -- sr_loss, its gradients, and the train step --------------------------------

def _jax_draws(key, jcfg, b, h, w):
    """The noise JAX's sr_loss draws from ``key`` (train/sr.py:72-78,
    110-113, 129), as numpy arrays for the port."""
    k_z, k_tcr = jax.random.split(key)
    z = np.array(jax.random.normal(k_z, (b, h, w, jcfg.z_dims),
                                     jnp.float32))
    if jcfg.lambda_bwd_tcr <= 0:
        return TSR.SRDraws(torch.from_numpy(z))
    rands, zs = [], []
    for k in jax.random.split(k_tcr, jcfg.tcr_iters):
        k_rand, k_zi = jax.random.split(k)
        rands.append(np.array(jax.random.uniform(k_rand, (b, 3),
                                                   jnp.float32)))
        zs.append(np.array(jax.random.normal(
            k_zi, (b, h, w, jcfg.z_dims), jnp.float32)))
    return TSR.SRDraws(torch.from_numpy(z), torch.from_numpy(np.stack(rands)),
                       torch.from_numpy(np.stack(zs)))


def _setup(scale, extra, seed=0):
    jcfg = JaxSRConfig(scale=scale, **TINY, **extra)
    tcfg = SRConfig(scale=scale, **TINY, **extra, device="cpu")
    jspec, _ = JI.build_inn_spec(jcfg)
    tspec, _ = TI.build_inn_spec(tcfg)
    params = np_params(jspec, seed=seed)
    rng = np.random.RandomState(seed + 1)
    lo = HR // (2 * scale)
    sup = {"hr": rng.randint(0, 256, (B, HR, HR, 3)).astype(np.uint8),
           "lr": rng.randint(0, 256, (B, lo, lo, tcfg.lr_dims)).astype(
               np.uint8)}
    unsup = {"lr": rng.randint(0, 256, (B, lo, lo, tcfg.lr_dims)).astype(
        np.uint8)}
    return jcfg, tcfg, jspec, tspec, params, sup, unsup


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("scale,extra", [
    (2, {}), (4, {}), (2, TCR_MMD), (4, TCR_MMD)],
    ids=["x2", "x4", "x2-tcr-mmd", "x4-tcr-mmd"])
def test_sr_loss_and_grads_match_jax(scale, extra):
    jcfg, tcfg, jspec, tspec, params, sup, unsup = _setup(scale, extra)
    key = jax.random.key(7)
    lo = HR // (2 * scale)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jsup = {k: jnp.asarray(v) for k, v in sup.items()}
    junsup = {k: jnp.asarray(v) for k, v in unsup.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: JSR.sr_loss(p, jspec, jcfg, jsup, junsup, key),
        has_aux=True)(jp)

    tparams = params_from_jax(tspec, params)
    leaves = TI.flat_params(tparams)
    for t in leaves:
        t.requires_grad_(True)
    draws = _jax_draws(key, jcfg, B, lo, lo)
    loss, aux = TSR.sr_loss(tparams, tspec, tcfg, _torch_batch(sup),
                            _torch_batch(unsup), draws)
    loss.backward()
    for k in ("loss", "fwd", "bwd", "tcr"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref = TI.flat_params(params_from_jax(
        tspec, jax.tree_util.tree_map(np.asarray, jgrads)))
    worst = max(_normwise(t.grad.numpy(), r.numpy())
                for t, r in zip(leaves, ref))
    print(f"worst leaf normwise relative error: {worst:.3e}")
    assert worst <= 1e-4


def test_train_step_matches_jax():
    jcfg, tcfg, jspec, tspec, params, sup, unsup = _setup(2, {})
    key = jax.random.key(3)
    tx = JO.adam_l2(jcfg.learning_rate, jcfg.adam_betas,
                    weight_decay=jcfg.weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JSR.SRTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    jstep = JSR.make_train_step(jspec, jcfg.replace(donate_state=False), tx)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in sup.items()},
                      None, key)

    state = TSR.train_state(params_from_jax(tspec, params), tcfg)
    draws = _jax_draws(jax.random.fold_in(key, 0), jcfg, B, HR // 4, HR // 4)
    aux = TSR.make_train_step(tspec, tcfg)(state, _torch_batch(sup),
                                           draws=draws)
    assert state.step == 1 and aux["loss"].requires_grad is False
    ref = TI.flat_params(params_from_jax(
        tspec, jax.tree_util.tree_map(np.asarray, jstate.params)))
    for t, r in zip(TI.flat_params(state.params), ref):
        np.testing.assert_allclose(t.detach().numpy(), r.numpy(), atol=1e-6)


def test_remat_gives_the_same_grads():
    _, tcfg, _, tspec, params, sup, unsup = _setup(2, TCR_MMD)
    grads = []
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        tparams = params_from_jax(tspec, params)
        leaves = TI.flat_params(tparams)
        for t in leaves:
            t.requires_grad_(True)
        draws = TSR.draw_sr_noise(torch.Generator().manual_seed(0), cfg, B,
                                  HR // 4, HR // 4)
        loss, _ = TSR.sr_loss(tparams, tspec, cfg, _torch_batch(sup),
                              _torch_batch(unsup), draws)
        loss.backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_kernel_route_matches_conv_route():
    """The fused Functions (kernel route, plain versions here) and the
    convolution route give the same loss and gradients."""
    _, tcfg, _, _, params, sup, unsup = _setup(2, {})
    out = []
    for use_kernel in ("auto", "off"):
        cfg = tcfg.replace(use_kernel=use_kernel)
        spec, _ = TI.build_inn_spec(cfg)
        assert any(l.use_kernel for l in spec) == (use_kernel == "auto")
        state = TSR.train_state(params_from_jax(spec, params), cfg)
        draws = TSR.draw_sr_noise(torch.Generator().manual_seed(1), cfg, B,
                                  HR // 4, HR // 4)
        loss, _ = TSR.sr_loss(state.params, spec, cfg, _torch_batch(sup),
                              None, draws)
        loss.backward()
        out.append((loss.detach(), [t.grad for t in
                                    TI.flat_params(state.params)]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        assert _normwise(a.numpy(), b.numpy()) <= 1e-4


def test_draw_sr_noise_shapes_and_tcr():
    cfg = SRConfig(scale=2, **TINY, **TCR_MMD, device="cpu")
    d = TSR.draw_sr_noise(torch.Generator().manual_seed(0), cfg, 3, 4, 5)
    assert d.z.shape == (3, 4, 5, cfg.z_dims)
    assert d.tcr_rand.shape == (2, 3, 3) and d.tcr_z.shape == (2, 3, 4, 5,
                                                              cfg.z_dims)
    assert float(d.tcr_rand.min()) >= 0 and float(d.tcr_rand.max()) < 1
    plain = TSR.draw_sr_noise(torch.Generator().manual_seed(0),
                              cfg.replace(lambda_bwd_tcr=0.0), 3, 4, 5)
    assert plain.tcr_rand is None and plain.tcr_z is None
    assert torch.equal(plain.z, d.z)


# -- the training loop and the CLI ------------------------------------------

@pytest.fixture(scope="module")
def video():
    return synthetic_sr_video(SRConfig(scale=2, **TINY, device="cpu"),
                              h=16, w=16)


def test_run_sr_train_and_resume(tmp_path, video):
    cfg = SRConfig(scale=2, **TINY, **TCR_MMD, device="cpu", batch_size=2,
                   epochs=2, print_iter=1, save_iter=1,
                   working_dir=str(tmp_path))
    K.reset_launch_counts()
    out = LP.run_sr_train(cfg, video=video)
    m = out["metrics"]
    assert out["start_epoch"] == 0 and out["state"].step > 0
    for k in ("loss", "fwd", "bwd", "tcr", "lr_acc", "hr_acc", "z_nll",
              "hr_psnr", "frames_per_sec"):
        assert np.isfinite(m[k]), k
    steps = out["state"].step
    with open(os.path.join(out["exp_dir"], f"{cfg.exp_name}.metrics.jsonl")) \
            as f:
        assert [json.loads(l)["step"] for l in f] == [0, 1]
    again = LP.run_sr_train(cfg.replace(epochs=3), video=video)
    st = again["state"]
    assert again["start_epoch"] == 2 and st.step == steps * 3 // 2
    opt_steps = {float(s["step"]) for s in
                 st.optimizer.state_dict()["state"].values()}
    assert opt_steps == {float(st.step)}
    assert np.isfinite(again["metrics"]["loss"])
    assert set(K.launch_counts().values()) == {0}    # CPU: plain versions


def test_sr_train_cli_then_sr_test(tmp_path, video):
    scene, work = "clip", str(tmp_path / "exp")
    _write_dataset(str(tmp_path / "data"), video, scene)
    common = ["--dataset", str(tmp_path / "data"), "-s", scene,
              "--scale", "2", "--lr_window", "1", "-c", "2",
              "--hidden_channels", "16", "-f", "30", "-w", work,
              "--val_batch_size", "4", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "sin_inn_tpu_torch.cli", "sr", *args,
         *common], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=120)
    res = run("train", "-e", "2", "-b", "2", "--save_iter", "1", "-p", "1")
    assert res.returncode == 0, res.stderr
    exp_dir = res.stdout.strip().splitlines()[-1]
    ckpts = sorted(os.listdir(os.path.join(exp_dir, "checkpoints")))
    assert ckpts == ["step_0000000001", "step_0000000002"]
    res = run("test", "--save_images")
    assert res.returncode == 0, res.stderr
    out = res.stdout.strip().splitlines()[-1]
    assert any(f.endswith(".png") for f in os.listdir(out))
