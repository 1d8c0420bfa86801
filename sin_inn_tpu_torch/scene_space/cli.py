"""Scene-space command-line operations: ``read_matrices``,
``depth_information``, ``reproject`` and ``gather``.

Counterpart of ``sin_inn_tpu/scene_space/cli.py``. ``gather`` runs
:func:`~sin_inn_tpu_torch.scene_space.gather.gather_scene` on ``--device``
(``cuda`` unless the caller asks for the CPU; every operation resolves the
device first, so a CUDA request without a card raises). PNGs are written
by the port's codec (``io/png.py``).
"""

from __future__ import annotations

import os
import os.path as path

import numpy as np


def run(args):
    import torch

    from sin_inn_tpu_torch.core.device import resolve_device
    from sin_inn_tpu_torch.scene_space import gather as G
    from sin_inn_tpu_torch.scene_space import pose_utils as PU

    device = resolve_device(getattr(args, "device", "cuda"))
    os.makedirs(args.out, exist_ok=True)
    if args.operation == "read_matrices":
        poses, perm, points, names = PU.load_colmap_data(args.scene_dir)
        K, K_inv, c2w, w2c = PU.get_camera_matrices(
            poses.transpose(2, 0, 1))
        np.save(path.join(args.out, "intrinsics.npy"), K)
        np.save(path.join(args.out, "extrinsics.npy"), w2c)
        print(f"K:\n{K}\nsaved {w2c.shape[0]} extrinsics to {args.out}")
    elif args.operation == "depth_information":
        poses, bds, imgs, depths = PU.load_data(args.scene_dir)
        if depths is None:
            print("no depth maps found")
            return
        print(f"depths: {depths.shape}, range [{depths.min():.3f}, "
              f"{depths.max():.3f}], bounds {bds.min():.3f}..{bds.max():.3f}")
    elif args.operation == "reproject":
        poses, bds, imgs, depths = PU.load_data(args.scene_dir)
        out = _reproject(poses, bds, imgs, depths, args.frame)
        _imwrite(path.join(args.out, f"reproject_{args.frame:03d}.png"), out)
        print(f"wrote reprojection of frame {args.frame}")
    elif args.operation == "gather":
        poses, bds, imgs, depths = PU.load_data(args.scene_dir)
        if depths is None:
            raise FileNotFoundError("gather requires depth maps")
        res = G.gather_scene(
            torch.as_tensor(imgs, device=device),
            torch.as_tensor(depths, device=device), poses, bds,
            patch=args.patch, ref_frame=args.frame,
            window=getattr(args, "window", "auto"))
        _imwrite(path.join(args.out, f"gather_{args.frame:03d}.png"),
                 res.cpu().numpy())
        print(f"wrote gathered/denoised frame {args.frame}")


def _reproject(poses, bds, imgs, depths, frame: int):
    """Project ``frame``'s pixels into frame 0 through its depth (numpy)."""
    from sin_inn_tpu_torch.scene_space.gather import unpack_matrices

    K, K_inv, c2w, w2c = unpack_matrices(poses)
    n, h, w = depths.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = depths[frame]
    pts = np.stack([yy * d, xx * d, d, np.ones_like(d)], -1)
    scene = (c2w[frame] @ K_inv @ pts[..., None]).squeeze(-1)
    cam0 = (K @ w2c[0] @ scene[..., None]).squeeze(-1)
    cam0 = cam0 / np.maximum(np.abs(cam0[..., 2:3]), 1e-9) * np.sign(
        cam0[..., 2:3] + 1e-12)
    iy = np.clip(np.round(cam0[..., 0]), 0, h - 1).astype(np.int64)
    ix = np.clip(np.round(cam0[..., 1]), 0, w - 1).astype(np.int64)
    out = np.zeros_like(imgs[0])
    out[iy, ix] = imgs[frame][yy, xx]
    return out


def _imwrite(p: str, img: np.ndarray):
    from sin_inn_tpu_torch.io import png

    png.imwrite(p, (np.clip(img, 0, 1) * 255).astype(np.uint8))
