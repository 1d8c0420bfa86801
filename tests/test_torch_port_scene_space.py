"""The port's scene space (``sin_inn_tpu_torch/scene_space``) against the
JAX package's on the CPU.

The COLMAP readers, ``pose_utils`` and ``ImagesData`` equal JAX's on the
same synthetic files; ``unpack_matrices``, ``pack_frustum_corners``,
``project_bounding_boxes``, the windowed read's geometry and
``_windowed_candidate_read`` equal JAX's (1e-6; a box side may differ by
1 px only where a corner sits on an exact .5 rounding tie). ``gather_scene``
with ``window`` 'off' and 'on' is within 1e-5 of JAX's 'off' with the
frustum side-plane filter off, on a scene with no such ties; with the
filter on, on the JAX suite's own parity scene, the residual is bounded as
that suite bounds its numpy baseline's (mean < 0.03, max < 0.3 a pixel):
the reference frame's own corner candidates lie on its side planes, a sign
test that any two fp32 implementations break differently. The filter's
planes and mask are held against float64 away from those ties. 'auto'
takes the exact gather (the
port's deliberate difference from JAX's TPU cost model), 'on' refuses a
frame smaller than a block, the drift guard warns under a shrunk window,
and the four ``scene-space`` operations run end to end.
"""

import argparse
import logging
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.scene_space import cli as JCLI
from sin_inn_tpu.scene_space import colmap as JC
from sin_inn_tpu.scene_space import data as JD
from sin_inn_tpu.scene_space import gather as JG
from sin_inn_tpu.scene_space import pose_utils as JP
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.data.synthetic import synth_scene
from sin_inn_tpu_torch.scene_space import colmap as TC
from sin_inn_tpu_torch.scene_space import data as TD
from sin_inn_tpu_torch.scene_space import gather as TG
from sin_inn_tpu_torch.scene_space import pose_utils as TP

io = pytest.importorskip("imageio.v2")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several workers on the box's cores; torch's default of
    a thread per core in each of them oversubscribes the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# synthetic COLMAP files and scenes
# ---------------------------------------------------------------------------

def _write_sparse(d, n=3, h=8, w=10):
    """A SIMPLE_RADIAL sparse model of n images and 4 points."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(3)
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 2, w, h))
        f.write(struct.pack("<dddd", 20.0, w / 2 + 0.5, h / 2 - 0.25, 0.01))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            q = rng.randn(4)
            q = q / np.linalg.norm(q)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *rng.randn(3)))
            f.write(struct.pack("<i", 1))
            f.write(f"im_{(n - 1 - i):04d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.5, 2.5, 1))
            f.write(struct.pack("<ddq", 3.0, 4.0, -1))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 4))
        for p in range(4):
            f.write(struct.pack("<Q", p + 1))
            f.write(struct.pack("<ddd", *(rng.randn(3) * 0.3 + [0, 0, 4])))
            f.write(struct.pack("<BBB", 10, 20, 30))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, 0, 2, 1))


def _identity_scene(n=3, h=8, w=10):
    rng = np.random.RandomState(0)
    poses = np.zeros((n, 3, 5), np.float32)
    for i in range(n):
        poses[i, :, :3] = np.eye(3)
        poses[i, 0, 4], poses[i, 1, 4], poses[i, 2, 4] = h, w, 20.0
    img = rng.rand(h, w, 3).astype(np.float32)
    depths = np.ones((n, h, w), np.float32) * 2.0
    bds = np.stack([np.full(n, 1.0), np.full(n, 4.0)], 1)
    return poses, bds, np.stack([img] * n), depths


def _write_scene(d, poses, bds, imgs, depths, skip_depth=()):
    (d / "images").mkdir(parents=True)
    (d / "stereo" / "depth_maps").mkdir(parents=True)
    n, h, w = depths.shape
    np.save(str(d / "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bds], axis=1))
    for i in range(n):
        io.imwrite(str(d / "images" / f"im_{i:04d}.png"),
                   (imgs[i] * 255).astype(np.uint8))
        if i in skip_depth:
            continue
        with open(d / "stereo" / "depth_maps" / f"im_{i:04d}.png.geometric.bin",
                  "wb") as f:
            f.write(f"{w}&{h}&1&".encode())
            depths[i].astype(np.float32).tofile(f)


def _tie_broken_scene(n=4, h=64, w=224):
    """synth_scene with noisy depth and per-frame rotations (the JAX suite's
    parity scene; from 32 x 112 a default (32 x 112) block fits): the side-plane
    values of frames >= 1 stay away from zero and no projection sits on a
    rounding tie."""
    imgs, depths, poses, bds = synth_scene(n, h, w)
    rng = np.random.RandomState(7)
    depths = (depths + rng.uniform(-1.0, 1.0, depths.shape)).astype(np.float32)
    for i in range(1, n):
        a = 0.02 * i
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        poses[i, :, :3] = poses[i, :, :3] @ rot
        poses[i, 1, 3] = 0.01 * i
    return imgs, depths, poses, bds


def _translated_scene(n=5, h=64, w=224, seed=1):
    """The JAX suite's windowed-read scene: per-frame translation, a slight
    rotation, non-constant depth."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, h, w, 3).astype(np.float32)
    depths = np.full((n, h, w), 10.0, np.float32) \
        + np.linspace(-1, 1, h * w).reshape(1, h, w).astype(np.float32)
    poses = np.zeros((n, 3, 5), np.float32)
    for i in range(n):
        poses[i, :, :3] = np.eye(3)
        poses[i, 0, 3] = 0.02 * (i - n / 2)
        poses[i, 0, 4], poses[i, 1, 4] = h, w
        poses[i, 2, 4] = 2.0 * max(h, w)
    th = 0.01
    poses[3, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    bds = np.tile(np.array([[8.0, 12.0]], np.float32), (n, 1))
    return imgs, depths, poses, bds


def _port(imgs, depths, poses, bds, **kw):
    return TG.gather_scene(torch.from_numpy(imgs), torch.from_numpy(depths),
                           poses, bds, **kw).numpy()


def _jax(imgs, depths, poses, bds, **kw):
    return np.asarray(JG.gather_scene(jnp.asarray(imgs), jnp.asarray(depths),
                                      poses, bds, **kw))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_colmap_readers_match_jax(tmp_path):
    _write_sparse(tmp_path / "sparse" / "0")
    d = str(tmp_path / "sparse" / "0")
    for name in ("read_cameras_binary", "read_images_binary",
                 "read_points3d_binary"):
        fn = name.replace("read_", "").replace("_binary", "")
        fn = {"points3d": "points3D"}.get(fn, fn)
        got = getattr(TC, name)(os.path.join(d, f"{fn}.bin"))
        ref = getattr(JC, name)(os.path.join(d, f"{fn}.bin"))
        assert got.keys() == ref.keys()
        for k in ref:
            for field, v in vars(ref[k]).items():
                np.testing.assert_array_equal(getattr(got[k], field), v)
    # the text readers and read_model
    (tmp_path / "txt").mkdir()
    (tmp_path / "txt" / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 640 480 500 500 320 240\n")
    (tmp_path / "txt" / "images.txt").write_text(
        "5 1 0 0 0 0.5 0.25 -1 1 a.png\n10 20 7 30 40 -1\n"
        "6 1 0 0 0 0 0 0 1 b.png\n\n")
    got = TC.read_model(str(tmp_path / "txt"), ".txt")
    ref = JC.read_model(str(tmp_path / "txt"), ".txt")
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            for field, v in vars(r[k]).items():
                np.testing.assert_array_equal(getattr(g[k], field), v)
    q = np.random.RandomState(1).randn(4)
    q = q / np.linalg.norm(q) * (1 if q[0] > 0 else -1)
    np.testing.assert_array_equal(TC.qvec2rotmat(q), JC.qvec2rotmat(q))
    np.testing.assert_allclose(TC.rotmat2qvec(TC.qvec2rotmat(q)), q,
                               atol=1e-8)
    p = str(tmp_path / "d.geometric.bin")
    depth = np.random.RandomState(2).rand(4, 6).astype(np.float32)
    with open(p, "wb") as f:
        f.write(b"6&4&1&")
        depth.tofile(f)
    np.testing.assert_array_equal(TC.read_depth_bin(p), JC.read_depth_bin(p))


def test_pose_utils_match_jax(tmp_path):
    _write_sparse(tmp_path / "sparse" / "0")
    got = TP.load_colmap_data(str(tmp_path))
    ref = JP.load_colmap_data(str(tmp_path))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[3] == ref[3] and got[2].keys() == ref[2].keys()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    np.testing.assert_array_equal(
        TP.save_poses(str(tmp_path / "t"), got[0], got[1], got[2]),
        JP.save_poses(str(tmp_path / "j"), *ref[:3]))
    poses, bds, imgs, depths = _identity_scene()
    _write_scene(tmp_path / "scene", poses, bds, imgs, depths * np.arange(
        1.0, 4.0)[:, None, None])
    for g, r in zip(TP.load_data(str(tmp_path / "scene")),
                    JP.load_data(str(tmp_path / "scene"))):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(TP.get_camera_matrices(poses),
                    JP.get_camera_matrices(poses)):
        np.testing.assert_array_equal(g, r)
    assert TC.pair_depth_maps(str(tmp_path / "scene" / "stereo" /
                                  "depth_maps"), ["im_0001.png", "x.png"]) == \
        JC.pair_depth_maps(str(tmp_path / "scene" / "stereo" / "depth_maps"),
                           ["im_0001.png", "x.png"])


def test_images_data_matches_jax(tmp_path):
    poses, bds, imgs, depths = _identity_scene()
    _write_scene(tmp_path / "scene", poses, bds, imgs, depths,
                 skip_depth=(1,))
    got, ref = TD.ImagesData(str(tmp_path / "scene")), JD.ImagesData(
        str(tmp_path / "scene"))
    assert len(got) == len(ref) == 3
    np.testing.assert_array_equal(got.K, ref.K)
    np.testing.assert_array_equal(got.K_inv, ref.K_inv)
    for i in range(3):
        for g, r in zip(got[i], ref[i]):
            if r is None:
                assert g is None and i == 1
            else:
                np.testing.assert_array_equal(g, r)
    with pytest.raises(IndexError):
        got[3]
    assert len(TD.ImagesData(str(tmp_path / "scene"), length=2)) == 2
    with pytest.raises(ValueError, match="missing"):
        TP.load_data(str(tmp_path / "scene"))


# ---------------------------------------------------------------------------
# the gather's pieces
# ---------------------------------------------------------------------------

def test_geometry_pieces_match_jax():
    for ncol in (5, 6):
        imgs, depths, poses, bds = synth_scene(3, 12, 20)
        poses = poses[..., :ncol]
        for g, r in zip(TG.unpack_matrices(poses), JG.unpack_matrices(poses)):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(
        TG.pack_frustum_corners(6, 8, 1.0, 4.0, 3).numpy(),
        np.asarray(JG.pack_frustum_corners(6, 8, 1.0, 4.0, 3)))
    # translated cameras put corners on exact .5 rounding ties, which two
    # fp32 implementations may round either way: every box side that
    # differs differs by 1 px at such a tie (float64 corners within 1e-4
    # of a half)
    poses, bds, _, _ = _identity_scene(n=3, h=8, w=10)
    poses[1, 0, 3] = 0.5
    poses[2, 1, 3] = -0.7
    got = TG.project_bounding_boxes(poses, bds, 8, 10, patch=3).numpy()
    ref = np.asarray(JG.project_bounding_boxes(poses, bds, 8, 10, patch=3))
    K, K_inv, c2w, w2c = (a.astype(np.float64)
                          for a in JG.unpack_matrices(poses))
    corners = np.asarray(JG.pack_frustum_corners(8, 10, 1.0, 4.0, 3),
                         np.float64)
    scene = corners @ (c2w[0] @ K_inv).T
    cam = np.stack([scene @ (K @ w2c[f]).T for f in range(3)])
    cam = cam[..., :2] / cam[..., 2:3]                  # (N, h, w, 8, yx)
    tie = (np.abs(cam - np.floor(cam) - 0.5) < 1e-4).any(-2)
    tie = np.concatenate([tie, tie], -1)                # (ymin,xmin,ymax,xmax)
    diff = got != ref
    assert np.all(np.abs(got - ref) <= 1) and np.all(tie[diff])
    assert diff.sum() <= tie.sum() and not np.allclose(ref[0], ref[1])
    _, _, poses, bds = _translated_scene()
    for rc, cc in ((32, 112), (16, 112), (8, 16)):
        assert TG._host_window_geometry(poses, bds, 64, 224, 3, 0, rc, cc) \
            == JG._host_window_geometry(poses, bds, 64, 224, 3, 0, rc, cc,
                                        True)
    assert TG._host_window_geometry(poses, bds, 8, 10, 3, 0, 16, 112) is None


def test_windowed_candidate_read_matches_jax():
    imgs, depths, poses, bds = _translated_scene()
    h, w, m = 64, 224, 3
    geo = TG._host_window_geometry(poses, bds, h, w, m, 0, 16, 112)
    rng = np.random.RandomState(5)
    planes = np.pad(rng.rand(h, w, 4).astype(np.float32),
                    ((0, geo["KW"]), (0, geo["KXW"]), (0, 0)))
    # anchors a few px around the pixel index, as a frame's are
    yy, xx = np.meshgrid(np.arange(geo["h_pad"]), np.arange(geo["w_pad"]),
                         indexing="ij")
    ay = np.clip(yy + rng.randint(-3, 4, yy.shape), 0, h - 1).astype(
        np.float32)
    ax = np.clip(xx + rng.randint(-3, 4, xx.shape), 0, w - 1).astype(
        np.float32)
    blk = lambda a: a.reshape(geo["h_pad"] // 16, 16, geo["w_pad"] // 112,
                              112).min((1, 3)).reshape(-1)
    by, bx = blk(ay).astype(np.int64), blk(ax).astype(np.int64)
    got = TG._windowed_candidate_read(
        torch.from_numpy(planes), torch.from_numpy(ay), torch.from_numpy(ax),
        torch.from_numpy(by), torch.from_numpy(bx), geo, m, h, w)
    ref = JG._windowed_candidate_read(
        jnp.asarray(planes), jnp.asarray(ay), jnp.asarray(ax),
        jnp.asarray(by, jnp.int32), jnp.asarray(bx, jnp.int32), geo, m, h, w)
    assert got.shape == (h, w, m * m, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


# ---------------------------------------------------------------------------
# gather_scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gathers():
    """JAX's exact gather of the tie-free scene (side-plane filter off) and
    of the JAX suite's parity scene (filter on), once for both windows."""
    big, small = _tie_broken_scene(h=32, w=112), _tie_broken_scene(h=24,
                                                                   w=32)
    return (big, _jax(*big, window="off", _plane_filter=False),
            small, _jax(*small, window="off"))


@pytest.mark.parametrize("window", ["off", "on"])
def test_gather_scene_matches_jax(window, jax_gathers):
    scene, ref, small, ref_f = jax_gathers
    got = _port(*scene, window=window, _plane_filter=False)
    assert got.shape == (32, 112, 3) and np.isfinite(got).all()
    print(f"gather {window}: max |port - JAX| {np.abs(got - ref).max():.3e}")
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # with the filter, on the JAX suite's own parity scene and bound: the
    # frame-0 tie flips shift most pixels a little
    got_f = _port(*small, window=window, row_chunk=8, col_chunk=16)
    d = np.abs(got_f - ref_f).max(-1)
    print(f"gather {window}, side-plane filter on: mean {d.mean():.3e}, "
          f"max {d.max():.3e}")
    assert d.mean() < 0.03 and d.max() < 0.3


def test_frustum_plane_filter_against_float64():
    """The side-plane filter's math: the port's planes against the JAX
    package's formulas evaluated in float64, and its outside mask equal to
    float64's wherever a product of signed distances is not within
    rounding of 0 (the ties of the reference frame's own corners)."""
    imgs, depths, poses, bds = _tie_broken_scene(h=24, w=32)
    K, K_inv, c2w, w2c = JG.unpack_matrices(poses)
    corners = TG.pack_frustum_corners(24, 32, 8.0, 12.0, 3)
    c2wK = torch.as_tensor(c2w[0] @ K_inv)
    sp = torch.cat([8.0 * TG._project(c2wK, corners[..., :4, :]),
                    12.0 * TG._project(c2wK, corners[..., 4:, :])], -2)
    planes = TG._frustum_planes(sp)
    sp64 = sp[..., :3].double().numpy()
    want = []
    for a, b, c in ((0, 2, 4), (1, 3, 5), (0, 1, 5), (2, 3, 6)):
        nrm = np.cross(sp64[..., b, :] - sp64[..., a, :],
                       sp64[..., c, :] - sp64[..., a, :])
        want.append((nrm, -np.sum(nrm * sp64[..., a, :], -1)))
    for (n, o), (wn, wo) in zip(planes, want):
        np.testing.assert_allclose(n.numpy(), wn, rtol=1e-4,
                                   atol=1e-4 * np.abs(wn).max())
        np.testing.assert_allclose(o.numpy(), wo, rtol=1e-4,
                                   atol=1e-4 * np.abs(wo).max())
    # candidates: frame 2's pixels lifted through their depth
    rng = np.random.RandomState(9)
    sc = torch.as_tensor(sp64[:, :, :1, :] + rng.uniform(
        -3, 3, (24, 32, 9, 3)), dtype=torch.float32)
    got = TG._outside(sc, planes).numpy()
    sc64 = sc.double().numpy()
    side = [np.sum(sc64 * n[:, :, None, :], -1) + o[:, :, None]
            for n, o in want]
    p12, p34 = side[0] * side[1], side[2] * side[3]
    ref = (p12 >= 0) | (p34 >= 0)
    scale = np.abs(np.stack([p12, p34])).max()
    clear = (np.abs(p12) > 1e-4 * scale) & (np.abs(p34) > 1e-4 * scale)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], ref[clear])


@pytest.mark.parametrize("plane_filter", [True, False])
def test_gather_windowed_equals_exact_in_the_port(plane_filter):
    chunks = dict(row_chunk=8, col_chunk=16)
    for scene in (_translated_scene(h=24, w=48), synth_scene(3, 16, 40)):
        off = _port(*scene, window="off", _plane_filter=plane_filter)
        np.testing.assert_allclose(
            _port(*scene, window="on", _plane_filter=plane_filter, **chunks),
            off, atol=1e-6)
        np.testing.assert_array_equal(
            _port(*scene, window="auto", _plane_filter=plane_filter), off)


def test_gather_window_modes(monkeypatch):
    imgs, depths, poses, bds = _translated_scene()

    def refuse(*a, **k):
        raise AssertionError("'auto' must take the exact gather")

    monkeypatch.setattr(TG, "_windowed_candidate_read", refuse)
    monkeypatch.setattr(TG, "_host_window_geometry", refuse)
    assert np.isfinite(_port(imgs, depths, poses, bds, window="auto")).all()
    monkeypatch.undo()
    p2, b2, i2, d2 = _identity_scene()
    with pytest.raises(ValueError, match="window"):
        _port(i2, d2, p2, b2, window="on")
    with pytest.raises(ValueError, match="window"):
        _port(imgs, depths, poses, bds, window="bogus")
    # the identity views keep the image where candidates were found
    out = _port(i2, d2, p2, b2)
    assert out.min() >= i2[0].min() - 1e-5 and out.max() <= i2[0].max() + 1e-5


def test_drift_guard_warns_under_a_shrunk_window(monkeypatch, caplog):
    imgs, depths, poses, bds = _translated_scene(h=32, w=112)
    real = TG._host_window_geometry

    def shrunk(*a, **k):
        geo = dict(real(*a, **k))
        geo["K0"], geo["KW"] = 1, 3          # 1 row-offset slot
        geo["KX0"], geo["KXW"] = 1, 3        # 1 col-offset slot
        return geo

    with caplog.at_level(logging.WARNING):
        _port(imgs, depths, poses, bds, window="on")
    assert "host mirror drift" not in caplog.text
    monkeypatch.setattr(TG, "_host_window_geometry", shrunk)
    with caplog.at_level(logging.WARNING):
        _port(imgs, depths, poses, bds, window="on")
    assert "host mirror drift" in caplog.text


def test_gather_keeps_the_tf32_flag(monkeypatch):
    m = torch.backends.cuda.matmul
    scene = synth_scene(2, 12, 20)
    for flag in (False, True):
        monkeypatch.setattr(m, "allow_tf32", flag)
        _port(*scene)
        assert m.allow_tf32 is flag


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def test_scene_space_command_end_to_end(tmp_path, monkeypatch):
    poses, bds, imgs, depths = _identity_scene(n=3, h=8, w=10)
    depths[1] *= 1.5
    scene = tmp_path / "dense"
    _write_scene(scene, poses, bds, imgs, depths)
    _write_sparse(scene / "sparse" / "0")
    out, jout = tmp_path / "out", tmp_path / "jout"
    base = ["scene-space", None, "--scene-dir", str(scene), "--out",
            str(out), "--frame", "1", "--device", "cpu"]
    for op in ("read_matrices", "depth_information", "reproject", "gather"):
        base[1] = op
        assert cli.main(base) == 0
        JCLI.run(argparse.Namespace(operation=op, scene_dir=str(scene),
                                    out=str(jout), frame=1, patch=3,
                                    window="auto"))
    for f in ("intrinsics.npy", "extrinsics.npy"):
        np.testing.assert_array_equal(np.load(out / f), np.load(jout / f))
    np.testing.assert_array_equal(io.imread(out / "reproject_001.png"),
                                  io.imread(jout / "reproject_001.png"))
    got = io.imread(out / "gather_001.png").astype(np.float32) / 255
    ref = io.imread(jout / "gather_001.png").astype(np.float32) / 255
    assert got.shape == (8, 10, 3)
    assert np.median(np.abs(got - ref)) <= 1 / 255 + 1e-6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base[-1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(base)
