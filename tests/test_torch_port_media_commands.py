"""The port's commands run from PNG, GIF and JPEG files without imageio
and cv2.

``cli.main`` drives each command on the CPU at tiny widths twice: once
with ``imageio``, ``cv2`` and ``PIL`` blocked in ``sys.modules`` (as on a
machine that has none of them), once with them importable. Both runs start
from the same files, written by the port's ``imwrite``
(``data/synthetic.py``'s writers), and every file each run leaves (images,
GIFs, ``.flo`` files, checkpoints read back tensor by tensor, JSON
sidecars) must be equal. The commands: ``sr train`` (and its resume),
``sr test`` (a GIF, and ``--save_images``), ``flow train``, ``flow test``,
``flow interpolate``, ``flow export``, ``flow summarize``, ``flow sintel``,
``flow train --flow-producer`` with a subprocess template whose tool reads
the PNGs with the port's ``imread``, ``scene-space gather``; and the inputs
that need the port's resize, GIF and JPEG readers: ``flow train --size`` /
``flow test --test-size`` on resized frames, ``flow train --input-video``
on a GIF, ``prepare`` from a GIF (``binning``, ``lanczos4 -d 2``,
``cubic``) and the four ``scene-space`` operations on a scene of JPEGs.
The JAX package's readers (cv2 and imageio) read the same files to the
same arrays as the port's: the datasets, the resized frames, the GIF clip,
every PNG ``prepare`` writes and the JPEG scene.
"""

import contextlib
import io as _io
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sin_inn_tpu.data import flow_media as JM
from sin_inn_tpu.data import sr_video as JV
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data import flow_media as TM
from sin_inn_tpu_torch.data import sr_video as TV
from sin_inn_tpu_torch.data.synthetic import (moving_texture_video,
                                              synth_scene, synthetic_sr_video,
                                              write_flow_scene,
                                              write_scene_dir,
                                              write_sparse_model,
                                              write_sr_dataset)
from sin_inn_tpu_torch.io import gif, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("imageio", "cv2", "PIL")
H, W = 16, 24
SR_TINY = dict(scale=2, lr_window=1, num_coupling=2, hidden_channels=16,
               fps=30)
SR = ["--dataset", None, "-s", "clip", "--scale", "2", "--lr_window", "1",
      "-c", "2", "--hidden_channels", "16", "-f", "30", "-b", "2",
      "--val_batch_size", "4", "-p", "1", "--save_iter", "1", "-w", "exp",
      "--device", "cpu"]
NET = ["--net", "RBF", "--num-frequencies", "8", "--hidden-dim", "16",
       "--num-layers", "2", "--batch", "2", "--epochs", "1", "--device",
       "cpu"]
FLOW = ["--size", str(H), "--test-size", str(H), *NET]
# frames shrunk at a general ratio (area) and enlarged (linear)
FLOW_RS = ["--size", "10", "--test-size", "20", *NET]
SCENE_OPS = ("read_matrices", "depth_information", "reproject", "gather")

# each case: the commands it runs after the shared training runs, as
# argument lists ("{data}" is replaced by the data directory)
CASES = {
    "sr_train": [],
    "sr_test_gif": [["sr", "test", *SR]],
    "sr_test_save_images": [["sr", "test", "--save_images", *SR]],
    "flow_train": [],
    "flow_test": [["flow", "test", "--input-video", "{gt}", *FLOW]],
    "flow_interpolate": [["flow", "interpolate", "--input-video", "{gt}",
                          "--interp-factor", "3", *FLOW]],
    "flow_export": [["flow", "export", "--input-video", "{gt}",
                     "--export-out", "exported.ckpt", *FLOW]],
    "flow_summarize": [["flow", "summarize", "--input-video", "{gt}",
                        *FLOW]],
    "flow_sintel": [["flow", "sintel", "--input-video", "{gt}", *FLOW]],
    "flow_producer": [["flow", "train", "--input-video", "{nogt}",
                       "--flow-producer", "{producer}", *FLOW]],
    "scene_space_gather": [["scene-space", "gather", "--scene-dir",
                            "{scene}", "--out", "scene_out", "--frame", "1",
                            "--device", "cpu"]],
    "flow_resize": [["flow", "train", "--input-video", "{gt}", "--name", "rs",
                     *FLOW_RS],
                    ["flow", "test", "--input-video", "{gt}", "--name", "rs",
                     *FLOW_RS]],
    "flow_video_gif": [["flow", "train", "--input-video", "{gif}", "--name",
                        "vid", "--step", "1", *FLOW_RS]],
    "prepare_gif": [["prepare", os.path.join("videos", "clip.gif"), "-s",
                     "2", *extra] for extra in
                    ([], ["-p", "lanczos4", "-d", "2"], ["-p", "cubic"])],
    "scene_space_jpeg": [["scene-space", op, "--scene-dir", "{jscene}",
                          "--out", "jscene_out", "--frame", "1", "--device",
                          "cpu"] for op in SCENE_OPS],
}
TRAINING = [["sr", "train", "-e", "2", *SR], ["sr", "train", "-e", "3", *SR],
            ["flow", "train", "--input-video", "{gt}", *FLOW]]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Several test workers share the box's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("media_data")
    video = synthetic_sr_video(SRConfig(**SR_TINY, device="cpu"), h=16, w=16)
    write_sr_dataset(str(d / "sr"), "clip", video)
    frames = moving_texture_video(4, H, W, seed=1)
    gt = np.random.RandomState(2).randn(3, H, W, 2).astype(np.float32)
    paths = {"data": str(d), "sr": str(d / "sr"),
             "gt": write_flow_scene(str(d / "sintel"), "alley_1", frames,
                                    gt),
             "nogt": write_flow_scene(str(d / "clips"), "walk",
                                      moving_texture_video(3, H, W, seed=3))}
    write_scene_dir(str(d / "scene"), *_scene_arrays())
    paths["scene"] = str(d / "scene")
    # a GIF clip (the port's writer) and a scene of JPEGs (Pillow's)
    clip = (moving_texture_video(6, H, W, seed=4) * 255).astype(np.uint8)
    os.makedirs(d / "videos")
    paths["gif"] = str(d / "videos" / "clip.gif")
    gif.mimsave(paths["gif"], list(clip), fps=10)
    imgs, depths, poses, bds = _scene_arrays()
    write_scene_dir(str(d / "jscene"), imgs, depths, poses, bds,
                    jpegs=[_jpeg(im) for im in imgs])
    write_sparse_model(str(d / "jscene" / "sparse" / "0"),
                       [f"im_{i:04d}.jpg" for i in range(len(imgs))],
                       *imgs.shape[1:3])
    paths["jscene"] = str(d / "jscene")
    tool = d / "producer.py"
    tool.write_text(
        "import sys\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from sin_inn_tpu_torch.data.flo import write_flo\n"
        "from sin_inn_tpu_torch.io.png import imread\n"
        "a = imread(sys.argv[1]).astype(np.float32)\n"
        "b = imread(sys.argv[2]).astype(np.float32)\n"
        "f = np.stack([(a - b)[..., 0] / 255, (a + b)[..., 1] / 510], -1)\n"
        "write_flo(sys.argv[3], f.astype(np.float32))\n")
    paths["producer"] = f"{sys.executable} {tool} {{f1}} {{f2}} {{out}}"
    return paths


def _jpeg(img) -> bytes:
    from PIL import Image

    b = _io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        b, "JPEG", quality=90)
    return b.getvalue()


def _scene_arrays():
    imgs, depths, poses, bds = synth_scene(3, 8, 10)
    return imgs, depths, poses, bds


def _argv(args, data):
    out = []
    for a in args:
        if a is None:
            a = data["sr"]
        out.append(a.format(**data) if "{" in a else a)
    return out


def _block(mp):
    """``import imageio`` (and cv2, PIL) raises ImportError, even where a
    module is already loaded."""
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            mp.setitem(sys.modules, name, None)
    for name in BLOCKED:
        mp.setitem(sys.modules, name, None)


def _run(work, args, data, blocked):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        if blocked:
            _block(mp)
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(_argv(args, data)) == 0
    return out.getvalue()


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(obj, (list, tuple)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    if isinstance(obj, torch.Tensor):
        return {prefix: obj.detach().numpy()}
    return {prefix: obj}


def _files(work):
    """Every file under ``work``: its bytes, or, for a torch checkpoint,
    its tensors and values by path. Metrics logs (wall-clock times) are
    left out."""
    out = {}
    for root, _, files in os.walk(work):
        for f in files:
            p = os.path.join(root, f)
            rel = os.path.relpath(p, work)
            if f.endswith(".jsonl"):
                continue
            if f.endswith((".pt", ".ckpt")):
                out[rel] = _flatten(torch.load(p, weights_only=False))
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """Both routes' work directories after the shared training runs."""
    works = {}
    for blocked in (True, False):
        work = tmp_path_factory.mktemp("blocked" if blocked else "present")
        for args in TRAINING:
            _run(work, args, data, blocked)
        works[blocked] = work
    return works


def _same(a, b, what):
    assert a.keys() == b.keys(), (what, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k], f"{what}:{k}")
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}:{k}")
        else:
            assert a[k] == b[k], (what, k)


@pytest.mark.parametrize("case", list(CASES))
def test_command_runs_without_imageio_and_cv2(case, data, trained,
                                              tmp_path_factory):
    printed = {}
    outs = {}
    for blocked in (True, False):
        work = tmp_path_factory.mktemp(f"{case}_{blocked}")
        # a copy of the route's trained state, so cases stay independent
        shutil.copytree(trained[blocked], work, dirs_exist_ok=True)
        if case == "prepare_gif":   # prepare writes beside the video's dir
            os.makedirs(work / "videos")
            shutil.copy(data["gif"], work / "videos")
        printed[blocked] = [_run(work, args, data, blocked)
                            for args in CASES[case]]
        outs[blocked] = _files(work)
    _same(outs[True], outs[False], case)
    assert printed[True] == printed[False]
    files = outs[True]
    if case == "sr_train":
        steps = sorted(f for f in files if f.endswith("state.pt"))
        assert len(steps) >= 2, steps
    if case == "sr_test_gif":
        gifs = [f for f in files if f.endswith(".gif") and "SRF" in f]
        assert len(gifs) == 1 and files[gifs[0]].endswith(b"\x3b")
    if case == "sr_test_save_images":
        pngs = sorted(f for f in files if f.endswith(".png"))
        assert pngs
        back = png.decode(files[pngs[0]])
        assert back.shape == (16, 16, 3) and back.dtype == np.uint8
    if case in ("flow_train", "flow_test"):
        assert any(f.startswith("results") and f.endswith(".gif")
                   for f in files)
    if case == "flow_interpolate":
        gif = [f for f in files if "interp_" in f and f.endswith(".gif")]
        assert len(gif) == 1
    if case == "flow_export":
        assert "exported.ckpt" in files
    if case == "flow_summarize":
        assert "Normalized AEPE:" in printed[True][0]
    if case == "flow_sintel":
        flo = [f for f in files if f.startswith("sintel_submission")]
        assert len(flo) == 3
    if case == "flow_producer":
        assert any("pseudo_gt" in f and f.endswith(".flo") for f in files)
    if case == "scene_space_gather":
        g = png.decode(files[os.path.join("scene_out", "gather_001.png")])
        assert g.shape == (8, 10, 3)
    if case == "flow_resize":
        assert any(f.startswith("results") and "rs" in f
                   and f.endswith(".gif") for f in files)
    if case == "flow_video_gif":
        assert any(os.path.join("clip", "vid") in f for f in files)
    if case == "prepare_gif":
        for scene in ("clip_binning_2x", "clip_lanczos4_2x", "clip_cubic_2x"):
            lr = [f for f in files if os.path.join("lr_frames", scene) in f]
            assert len(lr) == 6, (scene, lr)
    if case == "scene_space_jpeg":
        out = {os.path.basename(f) for f in files if "jscene_out" in f}
        assert {"intrinsics.npy", "extrinsics.npy", "reproject_001.png",
                "gather_001.png"} <= out


def test_dataset_reads_like_the_jax_package(data):
    """The PNGs the commands read decode to the same arrays through the
    JAX package's readers (imageio) and the port's."""
    for kind in ("hr_frames", "lr_frames"):
        d = os.path.join(data["sr"], kind, "clip")
        got, want = TV._read_frames(d), JV._read_frames(d)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for d in (data["gt"], data["nogt"]):
        got, want = TM.load_images(d, size=H), JM.load_images(d, size=H)
        np.testing.assert_array_equal(got.video, want.video)
        if want.flow is None:
            assert got.flow is None
        else:
            np.testing.assert_array_equal(got.flow, want.flow)


JAX_READS = ("load_images_resized", "load_video_clip_gif", "prepare_binning",
             "prepare_lanczos4_d2", "prepare_cubic", "scene_jpeg")


def _prepared_pngs(root):
    out = {}
    for sub in ("hr_frames", "lr_frames", "lr_frames_demosaiced",
                "hr_frames_noisy"):
        for dp, _, files in os.walk(os.path.join(root, sub)):
            for f in files:
                p = os.path.join(dp, f)
                out[os.path.relpath(p, root)] = png.imread(p)
    return out


@pytest.mark.parametrize("kind", JAX_READS)
def test_media_reads_like_the_jax_package(kind, data, tmp_path):
    """The inputs of the new cases read (and ``prepare`` writes) the JAX
    package's arrays, its cv2 and imageio calls against the port's own
    code."""
    if kind == "load_images_resized":
        for size in (10, 20):
            got = TM.load_images(data["gt"], size=size)
            want = JM.load_images(data["gt"], size=size)
            np.testing.assert_array_equal(got.video, want.video)
            np.testing.assert_array_equal(got.flow, want.flow)
    elif kind == "load_video_clip_gif":
        for size in (H, 10, 20):
            got = TM.load_video_clip(data["gif"], step=1, size=size)
            want = JM.load_video_clip(data["gif"], step=1, size=size)
            assert got.video.shape == want.video.shape
            np.testing.assert_array_equal(got.video, want.video)
    elif kind.startswith("prepare_"):
        from sin_inn_tpu.core.config import PrepareConfig as JaxPrepareConfig
        from sin_inn_tpu.data import prepare as JP
        from sin_inn_tpu_torch.core.config import PrepareConfig
        from sin_inn_tpu_torch.data import prepare as TP

        operator = kind.split("_")[1]
        kw = dict(operator=operator, scale=2, noise=3.0,
                  downsampling=2.0 if kind.endswith("_d2") else 1.0)
        roots = {}
        for who, cfg_cls, fn in (("port", PrepareConfig, TP.prepare_video),
                                 ("jax", JaxPrepareConfig, JP.prepare_video)):
            vdir = tmp_path / who / "videos"
            os.makedirs(vdir)
            shutil.copy(data["gif"], vdir)
            fn(cfg_cls(video=str(vdir / "clip.gif"), **kw),
               rng=np.random.RandomState(5))
            roots[who] = _prepared_pngs(str(tmp_path / who))
        assert sorted(roots["port"]) == sorted(roots["jax"])
        assert len(roots["port"]) == 4 * 6
        for f, a in roots["port"].items():
            np.testing.assert_array_equal(a, roots["jax"][f], err_msg=f)
    else:
        from sin_inn_tpu.scene_space import data as JD
        from sin_inn_tpu.scene_space import pose_utils as JPU
        from sin_inn_tpu_torch.scene_space import data as TD
        from sin_inn_tpu_torch.scene_space import pose_utils as TPU

        for a, b in zip(TPU.load_data(data["jscene"]),
                        JPU.load_data(data["jscene"])):
            np.testing.assert_array_equal(a, b)
        tds, jds = TD.ImagesData(data["jscene"]), JD.ImagesData(data["jscene"])
        for i in range(len(tds)):
            for a, b in zip(tds[i], jds[i]):
                np.testing.assert_array_equal(a, b)


def test_flow_test_size_200_runs_in_both_packages(tmp_path):
    """``chip_smoke.py`` phase 22 tests at ``--test-size 200`` on 436x1024
    frames: 200x470, the general area route. Both packages read the same
    frames and flows at that size, and both packages' ``flow train`` (with
    its test at the end) and ``flow test`` run there on the CPU and write
    200x470 flow images of every pair."""
    from sin_inn_tpu import cli as jax_cli

    frames = moving_texture_video(3, 436, 1024, seed=5)
    gt = np.random.RandomState(6).randn(2, 436, 1024, 2).astype(np.float32)
    scene = write_flow_scene(str(tmp_path / "sintel"), "alley_1", frames, gt)
    got, want = TM.load_images(scene, size=200), JM.load_images(scene,
                                                                size=200)
    assert got.video.shape == (3, 200, 470, 3)
    assert got.flow.shape == (2, 200, 470, 2)
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.flow, want.flow)
    args = ["--input-video", scene, "--name", "w200", "--size", "10",
            "--test-size", "200", *NET[:-2]]
    for who, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, [])):
        work = tmp_path / who
        work.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(work)
            with contextlib.redirect_stdout(_io.StringIO()):
                for op in ("train", "test"):
                    assert main(["flow", op, *args, *extra]) == 0, (who, op)
        flows = sorted((work / "results").glob("flow_alley_1_w200_*.gif"))
        assert len(flows) == 1, (who, flows)
        read = gif.mimread(str(flows[0]))
        assert len(read) == 2 and read[0].shape == (200, 470, 3), who
