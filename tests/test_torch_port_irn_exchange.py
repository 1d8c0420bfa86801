"""IRN and the SR checkpoint exchange in the port, held against the JAX
package and the committed goldens on the CPU.

IRN: the Haar squeeze (1e-6: +-1 arithmetic, exact up to rounding), the
dense block (1e-5: fp32 convolutions summed in another order), InvBlockExp
forward, inverse and log-det (1e-5), a small IRN INN both ways (1e-4: the
same, through four couplings) and ``sr_loss`` with its per-leaf gradients at
scale 2 (loss rtol 1e-5, worst leaf normwise 1e-4, as the SRF's). Params are
drawn with numpy in the JAX layout and carried over with ``params_from_jax``.

The exchange: the committed goldens (``tests/goldens/inn_srf.npz``,
``inn_irn.npz``, torch-replica outputs of reference-schema state dicts)
imported and run through ``inn_apply`` within 2e-4 of the stored outputs,
as the JAX package's golden test holds its own import; the export
reproducing the stored state dict key for key and bit for bit and equal to
the JAX package's ``export_state_dict`` of the same params; a Lightning
checkpoint file; schema mismatches; an on-disk checkpoint winning over
``--import-torch``; and ``sr train --import-torch`` then ``sr export`` on
the CLI.
"""

import argparse
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.models import inn as JI
from sin_inn_tpu.models import torch_import as JTI
from sin_inn_tpu.ops import coupling as JC
from sin_inn_tpu.ops import haar as JH
from sin_inn_tpu.ops import subnet as JS
from sin_inn_tpu.train import sr as JSR
from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models import torch_import as TTI
from sin_inn_tpu_torch.models.convert import params_from_jax
from sin_inn_tpu_torch.ops import coupling as TC
from sin_inn_tpu_torch.ops import haar as TH
from sin_inn_tpu_torch.ops import subnet as TS
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
from sin_inn_tpu_torch.train import loop as LP
from sin_inn_tpu_torch.train import sr as TSR
from test_torch_port_sr_test import _write_dataset
from test_torch_port_train import _jax_draws, _normwise, _torch_batch
from torch_port_helpers import np_params
from torch_port_helpers import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import goldens as G  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(scale=2, lr_window=1, num_coupling=2, hidden_channels=16,
            dense_gc=8)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


# -- IRN ops ----------------------------------------------------------------

def test_haar_matches_jax(rng):
    x = rng.randn(2, 6, 10, 5).astype(np.float32)
    y = TH.haar_squeeze(_t(x))
    _close(y, JH.haar_squeeze(jnp.asarray(x)), 1e-6)
    _close(TH.haar_unsqueeze(y), JH.haar_unsqueeze(JH.haar_squeeze(
        jnp.asarray(x))), 1e-6)
    _close(TH.haar_unsqueeze(y), x, 1e-6)
    assert TH.haar_log_det(6, 10, 5) == JH.haar_log_det(6, 10, 5)
    with pytest.raises(ValueError, match="even"):
        TH.haar_squeeze(_t(x[:, :5]))


def _dense_np(rng, cin, cout, gc):
    conv = lambda ci, co: {
        "w": (rng.randn(3, 3, ci, co) * 0.2).astype(np.float32),
        "b": (rng.randn(co) * 0.1).astype(np.float32)}
    p = {f"conv{i + 1}": conv(cin + i * gc, gc) for i in range(4)}
    p["conv5"] = conv(cin + 4 * gc, cout)
    return p


def _dense_port(p):
    return {k: {"w": _t(v["w"].transpose(3, 2, 0, 1)), "b": _t(v["b"])}
            for k, v in p.items()}


def test_dense_block_matches_jax(rng):
    p = _dense_np(rng, 6, 5, 4)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    ref = JS.dense_block_apply(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x))
    _close(TS.dense_block_apply(_dense_port(p), _t(x)), ref, 1e-5)


def test_dense_block_init_shapes_and_identity_start():
    gen = torch.Generator().manual_seed(0)
    p = TS.dense_block_init(gen, 6, 5, gc=4)
    jp = JS.dense_block_init(jax.random.key(0), 6, 5, gc=4)
    for k in jp:
        assert tuple(p[k]["w"].permute(2, 3, 1, 0).shape) == jp[k]["w"].shape
        assert not p[k]["b"].any()
    assert not p["conv5"]["w"].any()
    # xavier-normal x 0.1: std sqrt(2 / (fan_in + fan_out)) * 0.1
    w = TS.dense_block_init(gen, 64, 5, gc=64)["conv1"]["w"]
    want = np.sqrt(2.0 / (64 * 9 + 64 * 9)) * 0.1
    assert abs(w.std().item() / want - 1) < 0.05


@pytest.mark.parametrize("rev", [False, True])
def test_inv_block_matches_jax(rng, rev):
    len1, c = 4, 10
    jp = {"F": _dense_np(rng, c - len1, len1, 4),
          "G": _dense_np(rng, len1, c - len1, 4),
          "H": _dense_np(rng, len1, c - len1, 4)}
    tp = {k: _dense_port(v) for k, v in jp.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    x = rng.randn(2, 4, 6, c).astype(np.float32)
    if rev:
        jy, jld = JC.inv_block_inverse_ld(jp, jnp.asarray(x),
                                          JS.dense_block_apply, 1.0, len1)
        ty, tld = TC.inv_block_inverse_ld(tp, _t(x), TS.dense_block_apply,
                                          1.0, len1)
        _close(TC.inv_block_inverse(tp, _t(x), TS.dense_block_apply, 1.0,
                                    len1), jy, 1e-5)
    else:
        jy, jld = JC.inv_block_forward(jp, jnp.asarray(x),
                                       JS.dense_block_apply, 1.0, len1)
        ty, tld = TC.inv_block_forward(tp, _t(x), TS.dense_block_apply, 1.0,
                                       len1)
        back = TC.inv_block_inverse(tp, ty, TS.dense_block_apply, 1.0, len1)
        _close(back, x, 1e-5)
    _close(ty, jy, 1e-5)
    _close(tld, jld, 1e-5)


def _irn(kw, compute="float32"):
    jcfg = JaxSRConfig(architecture="IRN", **kw, compute_dtype=compute)
    tcfg = SRConfig(architecture="IRN", **kw, compute_dtype=compute,
                    device="cpu")
    jspec, jc = JI.build_inn_spec(jcfg)
    tspec, tc = TI.build_inn_spec(tcfg)
    assert tc == jc and len(tspec) == len(jspec)
    for t, j in zip(tspec, jspec):
        assert (t.kind, t.clamp, t.split_len1, t.gc, t.compute) == (
            j.kind, j.clamp, j.split_len1, j.gc, j.compute)
    params = np_params(jspec, seed=3)
    return tcfg, jspec, tspec, params


@pytest.mark.parametrize("scale", [2, 4])
def test_irn_inn_matches_jax(rng, scale):
    _, jspec, tspec, params = _irn(dict(TINY, scale=scale))
    tparams = params_from_jax(tspec, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    side = 2 ** (1 + (scale - 1).bit_length()) * 2
    x = rng.rand(2, side, side, 3).astype(np.float32)
    jy, jld = JI.inn_apply(jspec, jparams, jnp.asarray(x), with_log_det=True)
    ty, tld = TI.inn_apply(tspec, tparams, _t(x), with_log_det=True)
    _close(ty, jy, 1e-4)
    _close(tld, jld, 1e-4)
    jb, jbld = JI.inn_apply(jspec, jparams, jy, rev=True, with_log_det=True)
    tb, tbld = TI.inn_apply(tspec, tparams, ty, rev=True, with_log_det=True)
    _close(tb, jb, 1e-4)
    _close(tbld, jbld, 1e-4)
    _close(tb, x, 1e-4)
    # remat recomputes the couplings: the same values
    _close(TI.inn_apply(tspec, tparams, _t(x), remat=True), jy, 1e-4)


def test_irn_init_matches_jax_structure():
    tcfg, jspec, tspec, _ = _irn(TINY)
    jp = JI.init_inn(jax.random.key(0), jspec)
    tp = TI.init_inn(torch.Generator().manual_seed(0), tspec)
    for j, t in zip(jp, tp):
        assert (j is None) == (t is None)
        if j is None:
            continue
        assert set(j) == set(t) == {"F", "G", "H"}
        for s in j:
            for c in j[s]:
                assert tuple(t[s][c]["w"].permute(2, 3, 1, 0).shape) == \
                    j[s][c]["w"].shape
    assert len(TI.flat_params(tp)) == 2 * 2 * 3 * 5
    moved = TI.params_to(tp, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(TI.flat_params(moved), TI.flat_params(tp)))


def test_irn_sr_loss_and_grads_match_jax():
    extra = dict(TINY, fps=30)
    tcfg, jspec, tspec, params = _irn(extra)
    jcfg = JaxSRConfig(architecture="IRN", **extra)
    b, hr = 2, 16
    lo = hr // 4
    rng = np.random.RandomState(4)
    sup = {"hr": rng.randint(0, 256, (b, hr, hr, 3)).astype(np.uint8),
           "lr": rng.randint(0, 256, (b, lo, lo, tcfg.lr_dims)).astype(
               np.uint8)}
    key = jax.random.key(5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: JSR.sr_loss(p, jspec, jcfg, {k: jnp.asarray(v) for k, v
                                               in sup.items()}, None, key),
        has_aux=True)(jp)
    tparams = params_from_jax(tspec, params)
    leaves = TI.flat_params(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = TSR.sr_loss(tparams, tspec, tcfg, _torch_batch(sup), None,
                            _jax_draws(key, jcfg, b, lo, lo))
    loss.backward()
    for k in ("loss", "fwd", "bwd"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref = TI.flat_params(params_from_jax(
        tspec, jax.tree_util.tree_map(np.asarray, jgrads)))
    worst = max(_normwise(t.grad.numpy(), r.numpy())
                for t, r in zip(leaves, ref))
    assert worst <= 1e-4, worst


@pytest.fixture(scope="module")
def video():
    return synthetic_sr_video(SRConfig(**TINY, fps=30, device="cpu"),
                              h=16, w=16)


def test_irn_run_sr_train_resume_and_test(tmp_path, video):
    cfg = SRConfig(architecture="IRN", **TINY, fps=30, device="cpu",
                   batch_size=2, epochs=2, print_iter=1, save_iter=1,
                   working_dir=str(tmp_path), val_batch_size=4)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    out = LP.run_sr_train(cfg, video=video)
    assert out["start_epoch"] == 0 and out["state"].step > 0
    assert all(np.isfinite(v) for v in out["metrics"].values())
    again = LP.run_sr_train(cfg.replace(epochs=3), video=video)
    assert again["start_epoch"] == 2
    frames = list(LP.sr_test_frames(cfg, video, again["state"],
                                    again["spec"]))
    assert frames and frames[0].dtype == np.uint8
    assert set(K.launch_counts().values()) == {0}
    assert set(K8.launch_counts().values()) == {0}


# -- the checkpoint exchange ------------------------------------------------

def _golden(arch):
    sd, x, y, fields = G.load_inn_golden(
        os.path.join(G.GOLDEN_DIR, f"inn_{arch.lower()}.npz"))
    return sd, x, y, fields


@pytest.mark.parametrize("arch", ["SRF", "IRN"])
def test_golden_import_export_matches_replica_and_jax(arch):
    sd, x, y, fields = _golden(arch)
    cfg = SRConfig(**fields, device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    imported = TTI.import_state_dict(spec, dict(sd))
    ours = TI.inn_apply(spec, imported, _t(x.transpose(0, 2, 3, 1)))
    _close(ours, y.transpose(0, 2, 3, 1), 2e-4)
    exported = TTI.export_state_dict(spec, imported)
    assert set(exported) == {f"inn.{k}" for k in sd}
    for k, v in sd.items():
        np.testing.assert_array_equal(exported[f"inn.{k}"].numpy(), v,
                                      err_msg=k)
    jspec, _ = JI.build_inn_spec(JaxSRConfig(**fields))
    jexp = JTI.export_state_dict(jspec, JTI.import_state_dict(jspec, dict(sd)))
    assert set(jexp) == set(exported)
    for k, v in jexp.items():
        np.testing.assert_array_equal(exported[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("arch", ["SRF", "IRN"])
def test_export_matches_jax_export_and_round_trips(arch, tmp_path):
    kw = dict(TINY, architecture=arch)
    jspec, _ = JI.build_inn_spec(JaxSRConfig(**kw))
    cfg = SRConfig(**kw, device="cpu")
    tspec, _ = TI.build_inn_spec(cfg)
    params = np_params(jspec, seed=8)
    tparams = params_from_jax(tspec, params)
    ours = TTI.export_state_dict(tspec, tparams)
    theirs = JTI.export_state_dict(jspec, params)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    path = TTI.save_reference_checkpoint(str(tmp_path / "e.ckpt"), ours)
    spec2, back = TTI.load_reference_checkpoint(path, cfg)
    assert [l.kind for l in spec2] == [l.kind for l in tspec]
    for a, b in zip(TI.flat_params(back), TI.flat_params(tparams)):
        assert torch.equal(a, b)
    # and the JAX package imports the port's file to the same params
    _, jback = JTI.load_reference_checkpoint(path, JaxSRConfig(**kw))
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_lightning_checkpoint_file(tmp_path):
    cfg = SRConfig(architecture="IRN", **TINY, device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    params = TI.init_inn(torch.Generator().manual_seed(5), spec)
    sd = TTI.export_state_dict(spec, params)
    opt = argparse.Namespace(architecture="IRN", scale=cfg.scale,
                             num_coupling=cfg.num_coupling)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": {"opt": opt},
                "epoch": 7}, path)
    _, imported = TTI.load_reference_checkpoint(str(path), cfg)
    for a, b in zip(TI.flat_params(imported), TI.flat_params(params)):
        assert torch.equal(a, b)
    with pytest.raises(TTI.TorchImportError, match="num_coupling"):
        TTI.load_reference_checkpoint(str(path),
                                      cfg.replace(num_coupling=1))
    # a raw state_dict without the inn. prefix imports the same
    raw = {k[len("inn."):]: v for k, v in sd.items()}
    again = TTI.import_state_dict(spec, raw)
    assert all(torch.equal(a, b) for a, b in
               zip(TI.flat_params(again), TI.flat_params(params)))


def test_schema_mismatches_fail_loudly():
    cfg = SRConfig(architecture="IRN", **TINY, device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    sd = TTI.flatten_checkpoint(TTI.export_state_dict(
        spec, TI.init_inn(torch.Generator().manual_seed(1), spec)))
    spec1, _ = TI.build_inn_spec(cfg.replace(num_coupling=1))
    with pytest.raises(TTI.TorchImportError, match="sequence"):
        TTI.import_state_dict(spec1, dict(sd))
    bad = dict(sd)
    bad["operations.9.extra.weight"] = torch.zeros(1, 1, 1, 1)
    with pytest.raises(TTI.TorchImportError):
        TTI.import_state_dict(spec, bad)
    bad = dict(sd)
    bad["operations.0.haar_weights"] = torch.zeros_like(
        bad["operations.0.haar_weights"])
    with pytest.raises(TTI.TorchImportError, match="Haar"):
        TTI.import_state_dict(spec, bad)
    bad = dict(sd)
    bad["operations.2.F.conv1.weight"] = bad[
        "operations.2.F.conv1.weight"][:, :-1]
    with pytest.raises(TTI.TorchImportError, match="shape"):
        TTI.import_state_dict(spec, bad)
    with pytest.raises(TTI.TorchImportError, match="dict"):
        TTI.import_state_dict(spec, [1, 2])

    cfg_s = SRConfig(**TINY, device="cpu")
    spec_s, _ = TI.build_inn_spec(cfg_s)
    sd_s = TTI.flatten_checkpoint(TTI.export_state_dict(
        spec_s, TI.init_inn(torch.Generator().manual_seed(2), spec_s)))
    k = "module_list.2.s1.0.weight"
    bad = dict(sd_s)
    bad[k] = bad[k][:, :, :1, :1]      # a 3x3 coupling handed a 1x1 kernel
    with pytest.raises(TTI.TorchImportError):
        TTI.import_state_dict(spec_s, bad)
    with pytest.raises(TTI.TorchImportError, match="coupling blocks"):
        TTI.import_state_dict(TI.build_inn_spec(
            cfg_s.replace(num_coupling=4))[0], dict(sd_s))
    with pytest.raises(TTI.TorchImportError, match="not a FrEIA"):
        TTI.import_state_dict(spec_s, {"foo.weight": torch.zeros(1)})


def test_renumber_module_list_shifts_only_indices():
    sd = {"inn.module_list.0.s1.0.weight": torch.zeros(1),
          "module_list.12.s2.2.bias": torch.ones(1),
          "other.key": torch.ones(2)}
    assert set(TTI.renumber_module_list(sd, 1)) == {
        "inn.module_list.1.s1.0.weight", "module_list.13.s2.2.bias",
        "other.key"}


def test_create_state_imports(tmp_path):
    cfg = SRConfig(architecture="IRN", **TINY, device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    params = TI.init_inn(torch.Generator().manual_seed(6), spec)
    path = TTI.save_reference_checkpoint(
        str(tmp_path / "ref.ckpt"), TTI.export_state_dict(spec, params))
    _, state = TSR.create_train_state(R.root_generator(0),
                                      cfg.replace(import_torch=path))
    assert all(torch.equal(a.detach(), b) for a, b in
               zip(TI.flat_params(state.params), TI.flat_params(params)))


def test_checkpoint_wins_over_import_and_skips_torch_load(tmp_path, caplog):
    cfg = SRConfig(architecture="IRN", **TINY, device="cpu",
                   working_dir=str(tmp_path))
    spec, state = TSR.create_train_state(R.root_generator(3), cfg)
    state.step = 7
    CheckpointStore(os.path.join(LP.sr_dirs(cfg, "train"),
                                 "checkpoints")).save(1, state.state_dict())
    with caplog.at_level(logging.WARNING):
        _, s2, _, start = LP._sr_create_and_restore(
            cfg.replace(import_torch=str(tmp_path / "missing.ckpt")),
            R.root_generator(0))
    assert start == 1 and s2.step == 7
    assert "takes precedence" in caplog.text
    with pytest.raises(FileNotFoundError, match="resume_state"):
        LP._sr_create_and_restore(
            cfg.replace(resume_state=str(tmp_path / "none")),
            R.root_generator(0))
    with pytest.raises(FileNotFoundError, match="export"):
        LP.run_sr_export(cfg.replace(working_dir=str(tmp_path / "empty")))


def test_run_sr_export_round_trips(tmp_path, video):
    cfg = SRConfig(**TINY, fps=30, device="cpu", batch_size=2, epochs=1,
                   save_iter=1, working_dir=str(tmp_path))
    out = LP.run_sr_train(cfg, video=video)
    path = LP.run_sr_export(cfg)
    assert path.endswith("SRF_default_export.ckpt") and os.path.isfile(path)
    _, back = TTI.load_reference_checkpoint(path, cfg)
    for a, b in zip(TI.flat_params(back), TI.flat_params(out["state"].params)):
        assert torch.equal(a, b.detach())
    # a fresh experiment serves the imported weights as the trained run does
    fresh = cfg.replace(working_dir=str(tmp_path / "fresh"), import_torch=path)
    spec, state, _, step = LP._sr_create_and_restore(
        fresh, R.root_generator(1), require="no checkpoint")
    assert step == 0
    a = np.stack(list(LP.sr_test_frames(cfg, video, out["state"],
                                        out["spec"])))
    b = np.stack(list(LP.sr_test_frames(fresh, video, state, spec)))
    np.testing.assert_array_equal(a, b)


def test_sr_train_import_then_export_cli(tmp_path, video):
    scene, work = "clip", str(tmp_path / "exp")
    _write_dataset(str(tmp_path / "data"), video, scene)
    cfg = SRConfig(architecture="IRN", **TINY, device="cpu")
    spec, _ = TI.build_inn_spec(cfg)
    ref = TTI.save_reference_checkpoint(
        str(tmp_path / "ref.ckpt"), TTI.export_state_dict(
            spec, TI.init_inn(torch.Generator().manual_seed(9), spec)))
    common = ["--dataset", str(tmp_path / "data"), "-s", scene, "-a", "IRN",
              "--scale", "2", "--lr_window", "1", "-c", "2", "--dense_gc",
              "8", "-f", "30", "-w", work, "--val_batch_size", "4",
              "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "sin_inn_tpu_torch.cli", "sr", *args,
         *common], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=180)
    res = run("train", "-e", "1", "-b", "2", "--import-torch", ref)
    assert res.returncode == 0, res.stderr
    out = str(tmp_path / "exported.ckpt")
    res = run("export", "--export-out", out)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == out
    exp_dir = os.path.join(work, "train", cfg.replace(scene=scene).exp_name)
    trained, _ = CheckpointStore(os.path.join(exp_dir,
                                              "checkpoints")).restore()
    _, back = TTI.load_reference_checkpoint(out, cfg)
    for a, b in zip(TI.flat_params(back), TI.flat_params(trained["params"])):
        assert torch.equal(a, b)
