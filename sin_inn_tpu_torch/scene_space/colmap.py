"""COLMAP model readers: cameras / images / points3D, binary and text, and
the geometric depth maps.

A numpy copy of ``sin_inn_tpu/scene_space/colmap.py`` (struct unpacking of
COLMAP's sparse-model files, host side).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def _read(fh, n, fmt):
    return struct.unpack("<" + fmt, fh.read(n))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, 8 * nparams, "d" * nparams))
            cams[cid] = Camera(cid, name, w, h, params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.asarray(_read(f, 32, "dddd"))
            tvec = np.asarray(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            ch = f.read(1)
            while ch != b"\x00":
                name += ch
                ch = f.read(1)
            n2d = _read(f, 8, "Q")[0]
            data = np.asarray(_read(f, 24 * n2d, "ddq" * n2d)).reshape(n2d, 3) \
                if n2d else np.zeros((0, 3))
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode(),
                                data[:, :2], data[:, 2].astype(np.int64))
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            pid = _read(f, 8, "Q")[0]
            xyz = np.asarray(_read(f, 24, "ddd"))
            rgb = np.asarray(_read(f, 3, "BBB"))
            err = _read(f, 8, "d")[0]
            track_len = _read(f, 8, "Q")[0]
            track = np.asarray(_read(f, 8 * track_len, "ii" * track_len)
                               ).reshape(track_len, 2) if track_len else \
                np.zeros((0, 2))
            pts[pid] = Point3D(pid, xyz, rgb, err,
                               track[:, 0].astype(np.int64),
                               track[:, 1].astype(np.int64))
    return pts


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = Camera(cid, parts[1], int(parts[2]), int(parts[3]),
                               np.asarray([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.startswith("#")]
    for meta, pts in zip(lines[::2], lines[1::2]):
        p = meta.split()
        iid = int(p[0])
        qvec = np.asarray([float(x) for x in p[1:5]])
        tvec = np.asarray([float(x) for x in p[5:8]])
        elems = pts.split()
        xys = np.asarray([[float(x), float(y)] for x, y in
                          zip(elems[0::3], elems[1::3])]) if elems else \
            np.zeros((0, 2))
        ids = np.asarray([int(i) for i in elems[2::3]], np.int64) if elems \
            else np.zeros((0,), np.int64)
        images[iid] = Image(iid, qvec, tvec, int(p[8]), p[9], xys, ids)
    return images


def read_model(path: str, ext: str = ".bin"):
    if ext == ".bin":
        cameras = read_cameras_binary(os.path.join(path, "cameras.bin"))
        images = read_images_binary(os.path.join(path, "images.bin"))
        p3d_path = os.path.join(path, "points3D.bin")
        points = read_points3d_binary(p3d_path) if os.path.exists(p3d_path) \
            else {}
    else:
        cameras = read_cameras_text(os.path.join(path, "cameras.txt"))
        images = read_images_text(os.path.join(path, "images.txt"))
        points = {}
    return cameras, images, points


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def pair_depth_maps(depthdir: str, img_names) -> list:
    """COLMAP writes ``<image_name_with_ext>.geometric.bin`` under
    ``stereo/depth_maps``. Pairing the two sorted listings by position would
    shift every later frame's geometry after a gap in the depth maps, so
    they pair by name: one depth-map path per entry of ``img_names`` (full
    paths or bare file names), ``None`` where no map exists. A stem fallback
    covers extension-stripped exports."""
    suffix = ".geometric.bin"
    by_name: Dict[str, str] = {}
    if os.path.isdir(depthdir):
        for f in os.listdir(depthdir):
            if f.endswith(suffix):
                by_name[f[:-len(suffix)]] = os.path.join(depthdir, f)
    out = []
    for name in img_names:
        base = os.path.basename(name)
        out.append(by_name.get(base,
                               by_name.get(os.path.splitext(base)[0])))
    return out


def read_depth_bin(path: str) -> np.ndarray:
    """COLMAP's '&'-delimited geometric depth map format."""
    with open(path, "rb") as f:
        header = b""
        delim = 0
        while delim < 3:
            ch = f.read(1)
            if ch == b"&":
                delim += 1
            header += ch
        w, h, c = (int(x) for x in header.decode().split("&")[:3])
        data = np.fromfile(f, np.float32)
    return data.reshape(h, w, c).squeeze()
