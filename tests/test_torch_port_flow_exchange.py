"""The flow half of the port's checkpoint exchange and its entry points
against the JAX package on the CPU.

``mask_from_counts`` equals JAX's bit for bit; ``export_flow_state_dict`` of
JAX params carried over with ``models/convert.py`` equals JAX's key for key
and bit for bit (RBF, FFN, siren, PFF under the linear and the spatial
controller; the masks' fractions are dyadic, so every order of the count's
sum is exact); the port's import of a JAX-exported file gives JAX's
imported params, consts and controller state bit for bit, and the same
flows within 1e-5 px; the schema errors; the ``--import-torch``
precedence rule of the flow entry points; and ``flow export``, ``flow
summarize`` and ``flow sintel`` through the CLI (the AEPE within 1e-5
relative of JAX's ``run_flow_summarize``, every ``.flo`` within
1e-5 + 1e-5 |JAX| of JAX's ``run_flow_sintel``: fp32 INR products summed in
another order, times the flow scale W / 5).
"""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.models import torch_import as JTI
from sin_inn_tpu.train import flow as JF
from sin_inn_tpu.train import loop as JL
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.data import flo as TFLO
from sin_inn_tpu_torch.data.flow_media import FlowMedia
from sin_inn_tpu_torch.data.synthetic import moving_texture_video
from sin_inn_tpu_torch.models import controllers as C
from sin_inn_tpu_torch.models import torch_import as TTI
from sin_inn_tpu_torch.models.convert import (ctrl_state_from_jax,
                                              inr_params_from_jax)
from sin_inn_tpu_torch.models.inr import flat_leaves
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import loop as TL
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_frequencies=8, hidden_dim=16, num_layers=2, spatial_res=3,
            epochs=40)
H, W = 12, 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(net, spatial=False, **kw):
    return (JaxFlowConfig(net=net, spatially_adaptive=spatial, **TINY, **kw),
            FlowConfig(net=net, spatially_adaptive=spatial, **TINY,
                       device="cpu", **kw))


def _dyadic_masks(spec, ccfg, state):
    """A JAX controller state whose masks are canonical (ones, then a
    dyadic fraction): the counts survive any order of summation exactly."""
    if state is None:
        return None
    if isinstance(state, JF.ctrl.SpatialState):
        counts = (np.arange(ccfg.cells) * 0.75 + 0.25) % spec.encoding_dim
        return state._replace(
            mask=jnp.asarray(JTI.mask_from_counts(counts, spec.encoding_dim)),
            log_buffer=jnp.arange(ccfg.cells, dtype=jnp.float32) * 0.5,
            log_counter=jnp.full((ccfg.cells,), 2.0))
    return state._replace(mask=jnp.asarray(
        JTI.mask_from_counts([7.25], spec.encoding_dim)[0]))


def _paired(net, spatial=False, seed=8):
    """The same net (and controller state) in both packages."""
    jcfg, tcfg = _cfgs(net, spatial)
    jspec, jp, jc, jccfg, jstate = JF.build_flow_model(
        jax.random.PRNGKey(seed), jcfg)
    jstate = _dyadic_masks(jspec, jccfg, jstate)
    tspec, _, _, tccfg, _ = TF.build_flow_model(
        torch.Generator().manual_seed(0), tcfg)
    tp, tc = inr_params_from_jax(_np(jp), _np(jc))
    tstate = ctrl_state_from_jax(_np(jstate)) if jstate is not None else None
    return (jcfg, jspec, jp, jc, jccfg, jstate), (tcfg, tspec, tp, tc,
                                                  tccfg, tstate)


def _same(a, b, what):
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))
    b = b.detach().cpu() if isinstance(b, torch.Tensor) else torch.as_tensor(
        np.asarray(b))
    assert a.dtype == b.dtype and torch.equal(a, b), what


NETS = [("RBF", False), ("FFN", False), ("siren", False), ("PFF", False),
        ("PFF", True)]
NET_IDS = ["RBF", "FFN", "siren", "PFF-linear", "PFF-spatial"]


def test_mask_from_counts_matches_jax():
    e = 9
    counts = np.array([0.0, 0.5, 3.0, 6.7, 8.99, 9.0, 1e-7, 4.25],
                      np.float32)
    got = TTI.mask_from_counts(torch.from_numpy(counts), e)
    ref = JTI.mask_from_counts(counts, e)
    assert got.dtype == torch.float32 and got.shape == (8, e)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(TTI.mask_from_counts([7.3], 12).numpy(),
                                  JTI.mask_from_counts([7.3], 12))


@pytest.mark.parametrize("net,spatial", NETS, ids=NET_IDS)
def test_export_matches_jax(net, spatial):
    (_, jspec, jp, jc, _, jstate), (_, tspec, tp, tc, _, tstate) = \
        _paired(net, spatial)
    ref = JTI.export_flow_state_dict(jspec, jstate, jp, jc)
    got = TTI.export_flow_state_dict(tspec, tstate, tp, tc)
    assert list(got) == list(ref)
    for k in ref:
        _same(got[k], torch.from_numpy(np.array(ref[k])), k)
        assert got[k].is_contiguous() and got[k].device.type == "cpu"


@pytest.mark.parametrize("net,spatial", NETS, ids=NET_IDS)
def test_import_of_a_jax_export_matches_jax(net, spatial, tmp_path):
    """JAX exports a file; both packages import it onto fresh templates of
    another seed: the same params, consts and controller state, bit for
    bit, and the same flows."""
    (jcfg, jspec, jp, jc, jccfg, jstate), (tcfg, tspec, _, _, tccfg, _) = \
        _paired(net, spatial)
    ref_file = str(tmp_path / "ref.ckpt")
    JTI.save_reference_checkpoint(
        ref_file, JTI.export_flow_state_dict(jspec, jstate, jp, jc))
    _, jp0, jc0, _, js0 = JF.build_flow_model(jax.random.PRNGKey(99), jcfg)
    jp2, jc2, js2 = JTI.load_flow_reference_checkpoint(
        ref_file, jspec, jccfg, js0, jp0, jc0)
    tspec, tp2, tc2, tccfg, ts2 = TF.build_flow_model(
        torch.Generator().manual_seed(99), tcfg.replace(import_torch=ref_file))
    tp_ref, tc_ref = inr_params_from_jax(_np(jp2), _np(jc2))
    for (k, a), (_, b) in zip(flat_leaves(tp2), flat_leaves(tp_ref)):
        _same(a, b, f"params.{k}")
    assert [k for k, _ in flat_leaves(tc2)] == [k for k, _ in
                                                flat_leaves(tc_ref)]
    for (k, a), (_, b) in zip(flat_leaves(tc2), flat_leaves(tc_ref)):
        _same(a, b, f"consts.{k}")
    if js2 is None:
        assert ts2 is None
    else:
        want = ctrl_state_from_jax(_np(js2))
        for name, a in C.state_to_dict(ts2).items():
            b = C.state_to_dict(want)[name]
            if isinstance(a, torch.Tensor):
                _same(a, b, f"ctrl_state.{name}")
            else:
                assert a == b, name

    times = np.array([-1.0, 0.5], np.float32)
    infer = JF.make_flow_infer(jspec, jcfg, jccfg)
    j12, j21 = infer(jp2, jc2, js2, jnp.asarray(times), jnp.float32(1.0), H,
                     W)
    t12, t21 = TF.flow_infer(tspec, tp2, tc2, torch.from_numpy(times), 1.0,
                             H, W, tccfg, ts2)
    np.testing.assert_allclose(t12.numpy(), np.asarray(j12), atol=1e-5)
    np.testing.assert_allclose(t21.numpy(), np.asarray(j21), atol=1e-5)


def test_schema_mismatches():
    """The JAX package's errors (``tests/test_torch_import.py``), by the
    same messages."""
    _, (tcfg, tspec, tp, tc, tccfg, tstate) = _paired("PFF")
    sd = TTI.export_flow_state_dict(tspec, tstate, tp, tc)
    build = lambda **kw: TF.build_flow_model(torch.Generator().manual_seed(0),
                                             tcfg.replace(**kw))

    spec, p, c, ccfg, st = build()
    nomask = {k: v for k, v in sd.items() if k != "net.mask_stashed"}
    with pytest.raises(TTI.TorchImportError, match="no controller mask"):
        TTI.import_flow_state_dict(spec, ccfg, st, p, c, nomask)
    with pytest.raises(TTI.TorchImportError, match="not progressive"):
        TTI.import_flow_state_dict(*_np_args(build(net="FFN")), sd)
    with pytest.raises(TTI.TorchImportError, match="shape"):
        TTI.import_flow_state_dict(*_np_args(build(num_frequencies=16)), sd)
    spatial_sd = dict(sd, **{"net.mask_stashed": torch.full((27,), 3.0)})
    with pytest.raises(TTI.TorchImportError, match="spatial"):
        TTI.import_flow_state_dict(spec, ccfg, st, p, c, spatial_sd)
    with pytest.raises(TTI.TorchImportError, match="--spatial-res"):
        TTI.import_flow_state_dict(*_np_args(build(spatially_adaptive=True,
                                                   spatial_res=4)),
                                   spatial_sd)
    missing = {k: v for k, v in sd.items() if not k.endswith("0.bias")}
    with pytest.raises(TTI.TorchImportError, match="missing key"):
        TTI.import_flow_state_dict(spec, ccfg, st, p, c, missing)
    extra = dict(sd, **{"net.model.extra.weight": torch.zeros(2)})
    with pytest.raises(TTI.TorchImportError, match="not consumed"):
        TTI.import_flow_state_dict(spec, ccfg, st, p, c, extra)
    # the templates are left as they were
    spec, p, c, ccfg, st = build()
    before = [t.clone() for _, t in flat_leaves(p)]
    TTI.import_flow_state_dict(spec, ccfg, st, p, c, sd)
    for a, (_, b) in zip(before, flat_leaves(p)):
        assert torch.equal(a, b)


def _np_args(built):
    spec, p, c, ccfg, st = built
    return spec, ccfg, st, p, c


# -- the entry points ---------------------------------------------------------

def _ref_checkpoint(tmp_path, net="RBF", spatial=False):
    """A reference checkpoint exported by the JAX package, and the model."""
    (jcfg, jspec, jp, jc, jccfg, jstate), _ = _paired(net, spatial)
    ref = str(tmp_path / f"ref_{net}.ckpt")
    JTI.save_reference_checkpoint(
        ref, JTI.export_flow_state_dict(jspec, jstate, jp, jc))
    return ref


def test_flow_import_precedence(tmp_path, caplog):
    """A checkpoint on disk wins over --import-torch, with a warning; without
    one the import seeds the run and serving needs no checkpoint."""
    ref = _ref_checkpoint(tmp_path)
    sd = torch.load(ref)["state_dict"]
    cfg = _cfgs("RBF")[1].replace(checkpoints_dir=str(tmp_path / "ck"),
                                  results_dir=str(tmp_path / "res"), epochs=1)
    video = moving_texture_video(3, H, W, seed=2)
    init = torch.Generator().manual_seed(0)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TL._flow_create_and_restore(cfg, init, "sc", require="no checkpoint")
    spec, params, consts, _, step, _, _ = TL._flow_create_and_restore(
        cfg.replace(import_torch=ref), init, "sc", require="no checkpoint")
    assert step == 0
    _same(params["mlp"][0]["w"], sd["net.model.model.0.weight"].t(), "w0")
    _same(consts["enc"]["centres"], sd["net.encode.centres"], "centres")

    out = TL.run_flow_train(cfg.replace(import_torch=ref),
                            media=FlowMedia(video), scene="sc")
    trained = out["state"].params["mlp"][0]["w"].detach().clone()
    assert not torch.equal(trained, sd["net.model.model.0.weight"].t())
    with caplog.at_level(logging.WARNING):
        _, params, consts, _, step, _, _ = TL._flow_create_and_restore(
            cfg.replace(import_torch=str(tmp_path / "absent.ckpt")), init,
            "sc")
    assert step == 1 and "takes precedence" in caplog.text
    _same(params["mlp"][0]["w"], trained, "resumed w0")
    _same(consts["enc"]["centres"], sd["net.encode.centres"], "kept centres")


def _scenes(tmp_path):
    """Two Sintel-style scenes (frames/<scene>/frame_%04d.png) with GT flow
    (flow/<scene>/frame_%04d.flo)."""
    import imageio.v2 as io

    root = tmp_path / "final"
    flows = tmp_path / "flow"
    for s, scene in enumerate(("alley_1", "bamboo_2")):
        (root / scene).mkdir(parents=True)
        (flows / scene).mkdir(parents=True)
        frames = moving_texture_video(3 + s, H, W, seed=s)
        for i, f in enumerate((frames * 255).astype(np.uint8)):
            io.imwrite(str(root / scene / f"frame_{i + 1:04d}.png"), f)
        rng = np.random.RandomState(s)
        for i in range(2 + s):
            TFLO.write_flo(str(flows / scene / f"frame_{i + 1:04d}.flo"),
                           rng.randn(H, W, 2).astype(np.float32))
    return root, flows


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "sin_inn_tpu_torch.cli",
                          "flow", *args], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_flow_export_summarize_sintel_cli_match_jax(tmp_path):
    root, flows = _scenes(tmp_path)
    ref = _ref_checkpoint(tmp_path)
    work = tmp_path / "port"
    work.mkdir()
    common = ["--input-video", str(root / "alley_1"), "--size", str(H),
              "--test-size", str(H), "--net", "RBF", "--num-frequencies", "8",
              "--hidden-dim", "16", "--num-layers", "2", "--flow-dir",
              str(flows), "--import-torch", ref, "--device", "cpu"]
    jcfg = _cfgs("RBF")[0].replace(
        input_video=str(root / "alley_1"), size=H, test_size=H,
        flow_dir=str(flows), import_torch=ref,
        checkpoints_dir=str(tmp_path / "jck"),
        results_dir=str(tmp_path / "jres"))

    # export: no checkpoint, so the imported weights, key for key
    out = str(work / "exported.ckpt")
    assert _cli(work, "export", "--export-out", out,
                *common).strip().splitlines()[-1] == out
    got = torch.load(out)["state_dict"]
    want = torch.load(JL.run_flow_export(
        jcfg, out=str(tmp_path / "jexp.ckpt")))["state_dict"]
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k], k)

    # summarize: the frame-weighted AEPE of both scenes
    line = [l for l in _cli(work, "summarize", *common).splitlines()
            if l.startswith("Normalized AEPE:")]
    aepe = float(line[-1].split(":")[1])
    jaepe = JL.run_flow_summarize(jcfg)
    np.testing.assert_allclose(aepe, jaepe, rtol=1e-5)
    per_scene = [TL.run_flow_test(_cfgs("RBF")[1].replace(
        input_video=str(root / s), size=H, test_size=H, import_torch=ref,
        flow_dir=str(flows / s), checkpoints_dir=str(tmp_path / "tck"),
        results_dir=str(tmp_path / "tres"))) for s in ("alley_1", "bamboo_2")]
    assert [r["num_frames"] for r in per_scene] == [2, 3]
    np.testing.assert_allclose(aepe, TL.normalized_aepe(per_scene),
                               rtol=1e-6)

    # sintel: one .flo a pair, in <outroot>/final/<scene>/
    sub = _cli(work, "sintel", *common).strip().splitlines()[-1]
    assert sub == os.path.join("sintel_submission", "final")
    JL.run_flow_sintel(jcfg, outroot=str(tmp_path / "jsub"))
    for scene, n in (("alley_1", 2), ("bamboo_2", 3)):
        names = sorted(os.listdir(work / sub / scene))
        assert names == [f"frame_{i + 1:04d}.flo" for i in range(n)]
        for name in names:
            np.testing.assert_allclose(
                TFLO.read_flo(str(work / sub / scene / name)),
                TFLO.read_flo(str(tmp_path / "jsub" / "final" / scene / name)),
                atol=1e-5, rtol=1e-5)


def test_sintel_and_summarize_cores(tmp_path):
    """The in-memory cores: each .flo reads back bit for bit as the returned
    flow and as flow_test_outputs' flow of the same model; the AEPE is the
    frame-weighted mean."""
    _, (tcfg, tspec, tp, tc, tccfg, tstate) = _paired("PFF", True)
    video = moving_texture_video(4, H, W, seed=5)
    gt = np.random.RandomState(3).randn(3, H, W, 2).astype(np.float32)
    media = FlowMedia(video, flow=gt)
    flows = TL.sintel_scene_flows(tcfg, media, tspec, tp, tc, tccfg, tstate,
                                  outdir=str(tmp_path / "s"))
    assert flows.shape == (3, H, W, 2) and flows.dtype == np.float32
    ref = TL.flow_test_outputs(tcfg, media, tspec, tp, tc, tccfg, tstate)
    for i in range(3):
        got = TFLO.read_flo(str(tmp_path / "s" / f"frame_{i + 1:04d}.flo"))
        np.testing.assert_array_equal(got, flows[i])
        np.testing.assert_array_equal(got, ref["flow12"][i])
    assert TL.normalized_aepe([{"epe": 1.0, "num_frames": 1},
                               {"epe": 4.0, "num_frames": 3}]) == 3.25
    assert TL.normalized_aepe([]) == 0.0


def test_scene_flow_dir(tmp_path):
    (tmp_path / "flows" / "a").mkdir(parents=True)
    assert TL._scene_flow_dir(str(tmp_path / "flows"), "a") == str(
        tmp_path / "flows" / "a")
    assert TL._scene_flow_dir(str(tmp_path / "flows"), "b") is None
    assert TL._scene_flow_dir(None, "a") is None
