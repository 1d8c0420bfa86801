"""COLMAP pose pipeline: run SfM, load poses/bounds/images/depths.

A numpy copy of ``sin_inn_tpu/scene_space/pose_utils.py``: drive the COLMAP
binary through a subprocess (host side), convert w2c to c2w with the
LLFF-style [-u, r, -t] axis flip, save and load ``poses_bounds.npy`` with
0.1/99.9-percentile depth bounds, and read the geometric depth maps.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Optional

import numpy as np

from sin_inn_tpu_torch.scene_space.colmap import (pair_depth_maps, qvec2rotmat,
                                            read_depth_bin, read_model)


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher",
               dense: bool = True):
    """Feature extraction -> matching -> mapping (-> undistort + stereo)."""
    logfile = os.path.join(basedir, "colmap_output.txt")
    db = os.path.join(basedir, "database.db")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)

    def run(args):
        with open(logfile, "a") as log:
            subprocess.check_call(args, stdout=log, stderr=log)

    run(["colmap", "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--ImageReader.single_camera", "1"])
    run(["colmap", match_type, "--database_path", db])
    run(["colmap", "mapper", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--output_path", sparse, "--Mapper.num_threads", "16",
         "--Mapper.init_min_tri_angle", "4",
         "--Mapper.multiple_models", "0",
         "--Mapper.extract_colors", "0"])
    if dense:
        dense_dir = os.path.join(basedir, "dense")
        run(["colmap", "image_undistorter", "--image_path",
             os.path.join(basedir, "images"), "--input_path",
             os.path.join(sparse, "0"), "--output_path", dense_dir,
             "--output_type", "COLMAP"])
        run(["colmap", "patch_match_stereo", "--workspace_path", dense_dir,
             "--workspace_format", "COLMAP",
             "--PatchMatchStereo.geom_consistency", "true"])


def load_colmap_data(realdir: str):
    """Read the sparse model -> (poses, perm, points3d, image names).

    poses: (3, 6, N) with [R | t | (h, w, f) | (cx, cy, k)] columns and the
    LLFF-style [-u, r, -t] axis flip. The sixth column carries COLMAP's true
    principal point and radial coefficient.
    """
    camerasfile = os.path.join(realdir, "sparse/0")
    if not os.path.isdir(camerasfile):
        camerasfile = os.path.join(realdir, "sparse")
    cameras, images, points = read_model(camerasfile, ".bin")

    cam = next(iter(cameras.values()))
    h, w, f = cam.height, cam.width, cam.params[0]
    hwf = np.array([h, w, f]).reshape(3, 1)
    # principal point: SIMPLE_RADIAL params = [f, cx, cy, k],
    # SIMPLE_PINHOLE = [f, cx, cy], PINHOLE = [fx, fy, cx, cy] (the
    # single-focal format wants fx == fy); other models fall back to the
    # image center, with a warning
    if cam.model in ("SIMPLE_RADIAL", "RADIAL", "SIMPLE_PINHOLE"):
        cx, cy = float(cam.params[1]), float(cam.params[2])
        k = float(cam.params[3]) if len(cam.params) > 3 else 0.0
    elif cam.model == "PINHOLE":
        fx, fy = float(cam.params[0]), float(cam.params[1])
        if abs(fx - fy) > 1e-3 * max(abs(fx), 1.0):
            logging.warning(
                "PINHOLE camera has fx=%.4f != fy=%.4f; the single-focal "
                "pose format uses fx", fx, fy)
        cx, cy, k = float(cam.params[2]), float(cam.params[3]), 0.0
    else:
        logging.warning(
            "camera model %r has no principal-point mapping; falling back "
            "to the image center (w/2, h/2)", cam.model)
        cx, cy, k = w / 2.0, h / 2.0, 0.0
    cxcys = np.array([cx, cy, k]).reshape(3, 1)

    names = [images[k].name for k in images]
    perm = np.argsort(names)
    w2c_mats = []
    bottom = np.array([0, 0, 0, 1.0]).reshape(1, 4)
    for k in images:
        im = images[k]
        R = qvec2rotmat(im.qvec)
        t = im.tvec.reshape(3, 1)
        w2c_mats.append(np.concatenate(
            [np.concatenate([R, t], 1), bottom], 0))
    w2c_mats = np.stack(w2c_mats, 0)
    c2w_mats = np.linalg.inv(w2c_mats)
    poses = c2w_mats[:, :3, :4].transpose(1, 2, 0)
    poses = np.concatenate(
        [poses, np.tile(hwf[..., None], [1, 1, poses.shape[-1]]),
         np.tile(cxcys[..., None], [1, 1, poses.shape[-1]])], 1)
    # [-u, r, -t] axis flip
    poses = np.concatenate(
        [poses[:, 1:2, :], poses[:, 0:1, :], -poses[:, 2:3, :],
         poses[:, 3:4, :], poses[:, 4:5, :], poses[:, 5:6, :]], 1)
    return poses, perm, points, sorted(names)


def save_poses(basedir: str, poses: np.ndarray, perm: np.ndarray, points):
    """Write poses_bounds.npy with 0.1/99.9-pct depth bounds."""
    pts_arr = np.stack([points[k].xyz for k in points]) if points else \
        np.zeros((0, 3))
    vis_arr = []
    cams = sorted({i for k in points for i in points[k].image_ids}) if points \
        else []
    save_arr = []
    n = poses.shape[-1]
    for i in perm:
        if pts_arr.size:
            # depth of each point in this camera's frame
            zvals = np.sum(-(pts_arr - poses[:3, 3, i]) * poses[:3, 2, i],
                           axis=-1)
            close = np.percentile(zvals[zvals > 0], 0.1) if (zvals > 0).any() \
                else 0.01
            inf = np.percentile(zvals[zvals > 0], 99.9) if (zvals > 0).any() \
                else 1.0
        else:
            close, inf = 0.01, 1.0
        save_arr.append(np.concatenate(
            [poses[..., i].ravel(), np.array([close, inf])], 0))
    save_arr = np.stack(save_arr, 0)
    np.save(os.path.join(basedir, "poses_bounds.npy"), save_arr)
    return save_arr


def load_data(basedir: str, factor: Optional[int] = None):
    """Load (poses, bounds, images, depths) from a processed COLMAP dir.
    Returns NHWC float numpy arrays."""
    import imageio.v2 as io

    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    # 6 columns when the principal-point column is present; legacy
    # 5-column files load too
    ncol = (arr.shape[1] - 2) // 3
    poses = arr[:, :-2].reshape(-1, 3, ncol)
    bds = arr[:, -2:]

    imgdir = os.path.join(basedir, "images")
    img_files = sorted(f for f in os.listdir(imgdir)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
    imgs = np.stack([io.imread(os.path.join(imgdir, f)) / 255.0
                     for f in img_files]).astype(np.float32)

    depthdir = os.path.join(basedir, "stereo", "depth_maps")
    depths = None
    # name-based pairing (pair_depth_maps); the eager path stacks all
    # frames, so a partial set is an error rather than a shifted stack
    pairs = pair_depth_maps(depthdir, img_files)
    if any(p is not None for p in pairs):
        missing = [f for f, p in zip(img_files, pairs) if p is None]
        if missing:
            raise ValueError(
                f"depth maps present but missing for {missing} in "
                f"{depthdir}; a positional pairing would silently "
                f"misalign geometry")
        depths = np.stack([read_depth_bin(p) for p in pairs]
                          ).astype(np.float32)
    return poses, bds, imgs, depths


def get_camera_matrices(poses: np.ndarray):
    """Intrinsics + extrinsics from a pose vector, poses (N, 3, 5|6): the
    gather pipeline's :func:`unpack_matrices`."""
    from sin_inn_tpu_torch.scene_space.gather import unpack_matrices

    return unpack_matrices(poses)
