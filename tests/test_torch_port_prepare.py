"""The port's data preparation and the last small modules held against the
JAX package on the CPU.

``data/prepare.py``: every function on seeded arrays, bitwise (both are the
same numpy / cv2 / scipy arithmetic); ``prepare_video`` through the port's
``prepare`` command on the small clip of ``tests/test_cli_end_to_end.py``
(a GIF where no video codec is installed) against the JAX package's on a
copy of it: the same file names and equal frames; then the port's CPU ``sr
train`` / ``sr test`` on the prepared folder. The polynomial encoding
(atol 1e-6), the dense block's measurement forms (``fused``, ``shift``,
``conv2d_shift``; atol 1e-5) and ``examples/pair_flow_torch.py`` (three
steps from the JAX example's converted params: loss rel 1e-4; and the
script itself with ``--device cpu``).
"""

import importlib.util
import os
import os.path as path
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import PrepareConfig as JaxPrepareConfig
from sin_inn_tpu.data import prepare as JP
from sin_inn_tpu.data.synthetic import moving_texture_video
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core.config import PrepareConfig
from sin_inn_tpu_torch.data import prepare as TP
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIRS = ("hr_frames", "lr_frames", "lr_frames_demosaiced",
           "hr_frames_noisy")


# -- functions ---------------------------------------------------------------

@pytest.mark.parametrize("operator", ["linear", "cubic", "lanczos4",
                                      "nearest", "area"])
def test_cv_resize_matches_jax(operator):
    import cv2

    flag = getattr(cv2, f"INTER_{operator.upper()}")
    bayer = np.random.RandomState(0).rand(32, 48)
    np.testing.assert_array_equal(TP.cv_resize(bayer, operator, 2),
                                  JP.cv_resize(bayer, flag, 2))


def test_pack_and_demosaic_match_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(6, 10, 4)
    np.testing.assert_array_equal(TP.pack_bayer(img), JP.pack_bayer(img))
    mosaic = rng.rand(12, 20)
    np.testing.assert_array_equal(TP.demosaic_bilinear(mosaic),
                                  JP.demosaic_bilinear(mosaic))
    np.testing.assert_array_equal(TP.pack_demosaic(img),
                                  JP.pack_demosaic(img))


def test_bayer_binning_and_conversions_match_jax():
    rng = np.random.RandomState(2)
    u8 = rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)
    u16 = rng.randint(0, 2 ** 16, (16, 24, 3)).astype(np.uint16)
    for frame in (u8, u16):
        np.testing.assert_array_equal(TP._normalize(frame),
                                      JP._normalize(frame))
    with pytest.raises(NotImplementedError):
        TP._normalize(u8.astype(np.float32))
    x = rng.rand(8, 8, 3) * 1.4 - 0.2
    np.testing.assert_array_equal(TP._to_u8(x), JP._to_u8(x))
    for scale in (1.0, 2.0):
        for a, b in zip(TP.extract_bayer(TP._normalize(u8), scale),
                        JP.extract_bayer(JP._normalize(u8), scale)):
            np.testing.assert_array_equal(a, b)
    bayer, _ = TP.extract_bayer(TP._normalize(u8))
    for red in ("mean", "sum"):
        np.testing.assert_array_equal(TP.binning(bayer, red, 2),
                                      JP.binning(bayer, red, 2))


def test_prepare_config_matches_jax():
    assert PrepareConfig() == PrepareConfig(**JaxPrepareConfig().__dict__)
    with pytest.raises(ValueError, match="operator"):
        PrepareConfig(operator="bicubic")
    with pytest.raises(ValueError, match="reduction"):
        PrepareConfig(reduction="max")


def test_encode_previews_is_gated_on_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    TP._encode_previews(str(tmp_path), "scene")
    assert not os.listdir(tmp_path)


# -- prepare_video and the prepare command -------------------------------------

def _write_clip(root) -> str:
    import imageio.v2 as io

    vid_dir = root / "videos"
    vid_dir.mkdir(parents=True)
    frames = (moving_texture_video(80, 16, 16) * 255).astype(np.uint8)
    vpath = str(vid_dir / "clip.mp4")
    try:
        io.mimsave(vpath, list(frames), fps=30)
    except Exception:
        # no video codec available: a GIF container
        vpath = str(vid_dir / "clip.gif")
        io.mimsave(vpath, list(frames), format="GIF", fps=30)
    return vpath


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The clip prepared by each package, the port through its CLI."""
    root = tmp_path_factory.mktemp("prep")
    vj = _write_clip(root / "jax")
    vt = path.join(root / "torch", "videos", path.basename(vj))
    os.makedirs(path.dirname(vt))
    shutil.copy(vj, vt)
    jout = JP.prepare_video(JaxPrepareConfig(video=vj, scale=2, noise=2.0))
    rc = cli.main(["prepare", vt, "-s", "2", "-n", "2.0"])
    tout = (path.join(path.dirname(vt), ".."), "clip_binning_2x")
    return jout, tout, rc


def test_prepare_command_writes_jax_files_and_frames(prepared, capsys):
    import imageio.v2 as io

    (jd, jscene), (td, tscene), rc = prepared
    assert rc == 0 and jscene == tscene == "clip_binning_2x"
    for sub in SUBDIRS:
        jfiles = sorted(os.listdir(path.join(jd, sub, jscene)))
        tfiles = sorted(os.listdir(path.join(td, sub, tscene)))
        assert jfiles == tfiles, sub
        assert jfiles[0] == "frame_00001.png" and len(jfiles) >= 70
        for f in jfiles[::7]:
            np.testing.assert_array_equal(
                io.imread(path.join(td, sub, tscene, f)),
                io.imread(path.join(jd, sub, jscene, f)), err_msg=f)


def test_prepare_cli_prints_dataset_and_scene(tmp_path, capsys):
    vpath = _write_clip(tmp_path)
    assert cli.main(["prepare", vpath, "-s", "2", "-p", "area"]) == 0
    out = capsys.readouterr().out
    assert "clip_area_2x" in out
    assert os.listdir(path.join(tmp_path, "lr_frames", "clip_area_2x"))


def test_sr_train_and_test_on_the_prepared_folder(prepared, tmp_path):
    _, (dataset, scene), _ = prepared
    common = ["--dataset", dataset, "-s", scene, "--scale", "2",
              "--lr_window", "1", "-c", "1", "-f", "30", "-a", "IRN",
              "--hidden_channels", "8", "--dense_gc", "8",
              "--val_batch_size", "4", "-w", str(tmp_path / "exp"),
              "--device", "cpu"]
    assert cli.main(["sr", "train", "-b", "4", "-e", "2", "--save_iter", "1",
                     "-p", "1"] + common) == 0
    run = tmp_path / "exp" / "train" / f"{scene}_IRN_default"
    assert (run / "checkpoints" / "step_0000000002").is_dir()
    assert cli.main(["sr", "test", "--save_images"] + common) == 0
    img_dir = tmp_path / "exp" / "test" / f"{scene}_IRN_default" / \
        "IRN_default_t0.8"
    assert len(os.listdir(img_dir)) > 0


# -- the polynomial encoding ---------------------------------------------------

@pytest.mark.parametrize("d,power", [(2, 2), (2, 5), (3, 4)])
def test_polynomial_encoding_matches_jax(d, power):
    from sin_inn_tpu.ops import encodings as JE
    from sin_inn_tpu_torch.ops import encodings as TE

    assert TE.polynomial_kernel(d, power) == JE.polynomial_kernel(d, power)
    params, consts = TE.polynomial_init(torch.Generator(), d, power)
    _, jconsts = JE.polynomial_init(jax.random.key(0), d, power)
    assert params == {} and consts == jconsts
    x = np.random.RandomState(d + power).rand(50, d).astype(np.float32) * 2 - 1
    got = TE.polynomial_apply(params, consts, torch.from_numpy(x))
    want = np.asarray(JE.polynomial_apply({}, jconsts, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    x2 = torch.tensor([[2.0, 3.0]])
    if (d, power) == (2, 2):
        out = TE.polynomial_apply({}, consts, x2)
        assert sorted(out[0].tolist()) == [4.0, 6.0, 9.0]


def test_flow_config_power_in_model_params():
    from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
    from sin_inn_tpu_torch.core.config import FlowConfig

    assert FlowConfig().power == 20
    assert FlowConfig(power=7).model_params() == \
        JaxFlowConfig(power=7).model_params()


# -- the dense block's measurement forms ----------------------------------------

def _dense_params(seed, c_in, c_out, gc):
    rng = np.random.RandomState(seed)
    p = {}
    for i in range(5):
        cin = c_in + i * gc
        cout = gc if i < 4 else c_out
        p[f"conv{i + 1}"] = {
            "w": (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
            "b": (rng.randn(cout) * 0.1).astype(np.float32)}
    return p


def _to_oihw(p):
    return {k: {"w": torch.from_numpy(v["w"].transpose(3, 2, 0, 1).copy()),
                "b": torch.from_numpy(v["b"])} for k, v in p.items()}


@pytest.mark.parametrize("form", ["default", "fused", "shift"])
def test_dense_block_forms_match_jax(form):
    from sin_inn_tpu.ops import subnet as JS
    from sin_inn_tpu_torch.ops import subnet as TS

    p = _dense_params(3, 6, 5, 4)
    x = np.random.RandomState(4).randn(2, 5, 7, 6).astype(np.float32)
    kw = {"fused": form == "fused", "shift": form == "shift"}
    want = np.asarray(JS.dense_block_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        compute_dtype="highest", **kw))
    got = TS.dense_block_apply(_to_oihw(p), torch.from_numpy(x),
                               compute="highest", **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_conv2d_shift_matches_jax_and_refuses_other_kernels():
    from sin_inn_tpu.ops import subnet as JS
    from sin_inn_tpu_torch.ops import subnet as TS

    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 9, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    want = np.asarray(JS.conv2d_shift(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), "highest"))
    got = TS.conv2d_shift(torch.from_numpy(x),
                          torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                          torch.from_numpy(b), "highest")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), TS.conv2d(torch.from_numpy(x), torch.from_numpy(
            w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
            "highest").numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="3x3"):
        TS.conv2d_shift(torch.from_numpy(x), torch.zeros(3, 4, 1, 1))


# -- examples/pair_flow_torch.py ------------------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "pair_flow_torch", path.join(REPO, "examples", "pair_flow_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pair_flow_example_matches_jax_steps():
    """Three steps of the pair experiment (2-D PRBF, linear controller) from
    the JAX example's init, converted, against the JAX example's steps."""
    from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
    from sin_inn_tpu.train import flow as JFT
    from sin_inn_tpu_torch.models.convert import inr_params_from_jax

    ex = _example()
    vid = moving_texture_video(3, 24, 32, seed=2)
    sample = {"frame1": vid[0:1], "frame2": vid[1:2],
              "scale": np.float32(8.0)}
    jcfg = JaxFlowConfig(net="PRBF", domain_dim=2, std_rbf=50.0, std=50.0,
                         epochs=3, lr=1e-3, loss_l1=1.0, loss_census=0.1,
                         loss_smooth1=0.1)
    spec, state, consts, ctrl_cfg, tx = JFT.create_flow_state(
        jax.random.key(0), jcfg)
    tp, tc = inr_params_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, consts))
    jstep = JFT.make_flow_train_step(spec, jcfg, ctrl_cfg, tx)
    jb = {"frame1": jnp.asarray(sample["frame1"]),
          "frame2": jnp.asarray(sample["frame2"]),
          "times": jnp.zeros((1,), jnp.float32),
          "scale": jnp.asarray(sample["scale"])}
    want = []
    for _ in range(3):
        state, m = jstep(state, consts, jb)
        want.append(float(m["loss"]))
    cfg = ex.pair_config("PRBF", 3, "cpu")
    _, _, _, got = ex.fit_pair(cfg, ex.pair_batch(sample, "cpu"), 3,
                               params=tp, consts=tc, log=None)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pair_flow_example_script_on_cpu(tmp_path):
    import imageio.v2 as io

    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate((moving_texture_video(3, 24, 32) * 255
                           ).astype(np.uint8)):
        io.imwrite(frames / f"frame_{i + 1:04d}.png", f)
    out = subprocess.run(
        [sys.executable, path.join(REPO, "examples", "pair_flow_torch.py"),
         "--frames", str(frames), "--size", "24", "--epochs", "3",
         "--device", "cpu", "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "epoch 3: loss" in out.stdout
    assert (tmp_path / "out" / "flow.png").is_file()
