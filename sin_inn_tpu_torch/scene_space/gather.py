"""Scene-space multi-view gather: reproject, frustum-filter, bilateral merge.

Counterpart of ``sin_inn_tpu/scene_space/gather.py`` in PyTorch. The
pipeline:

  1. per-pixel patch-frustum corners of the reference frame (8 homogeneous
     points at near and far);
  2. lifted to scene space and projected into all N views;
  3. the candidate box around the projections, read as an m x m patch at
     its (y_min, x_min) anchor;
  4. the candidates lifted to 3D through their depth;
  5. filtered by the reference frustum's four side planes;
  6. merged by joint bilateral weights over (rgb, xyz, t) with a diagonal
     sigma: a masked weighted average.

The frames are a Python loop that sums into two accumulators, so the peak
memory is one frame's candidate set. The near candidate set is projected
from the near corners (``scene_pts[..., :4]``).

Every projection and every one-hot product runs in fp32 with TF32 off (a
context manager around the call restores the caller's flag): the windowed
read's window sizes come from a numpy mirror of the box math, and TF32
would round the candidate values of the one-hot selection.

``window`` differs from the JAX package on purpose: there, 'auto' asks a
cost model of the TPU's serialized gather whether the windowed read wins;
here 'auto' takes the exact gather (a gather of m*m points a pixel is
cheap on the card), 'on' forces the windowed read (refusing frames smaller
than a block) and 'off' is the exact gather.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sin_inn_tpu_torch.ops.subnet import _matmul_tf32

WINDOWS = ("auto", "on", "off")


def unpack_matrices(poses: np.ndarray):
    """(N, 3, 5|6) poses -> (K, K_inv, c2w, w2c), numpy float32.

    6-column poses carry COLMAP's true principal point in column 5, rows
    [cx, cy, k]. Camera coordinates here are (y, x, 1, 1/z) (see
    :func:`pack_frustum_corners`), so K[0, 2], the row offset, is cy and
    K[1, 2] is cx. 5-column poses fall back to the image center
    (h / 2, w / 2).
    """
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = poses[0, 2, 4]
    K[1, 1] = poses[0, 2, 4]
    if poses.shape[-1] >= 6:
        K[0, 2] = poses[0, 1, 5]        # cy: the y / row offset
        K[1, 2] = poses[0, 0, 5]        # cx: the x / col offset
    else:
        K[0, 2] = poses[0, 0, 4] / 2.0  # h/2
        K[1, 2] = poses[0, 1, 4] / 2.0  # w/2
    c2w = np.zeros((poses.shape[0], 4, 4), dtype=np.float32)
    c2w[:, :3, :] = poses[..., :4]
    c2w[:, 3, 3] = 1.0
    return K, np.linalg.inv(K), c2w, np.linalg.inv(c2w)


def pack_frustum_corners(h: int, w: int, near: float, far: float,
                         l: int = 3, device="cpu") -> torch.Tensor:
    """(h, w, 8, 4) per-pixel patch-frustum corners, coordinates
    (y, x, 1, 1/z): the four corners of the clamped l x l patch at 1/near,
    then at 1/far."""
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    y0 = torch.clamp(yy - l // 2, min=0)
    y1 = torch.clamp(yy + l // 2, max=h - 1)
    x0 = torch.clamp(xx - l // 2, min=0)
    x1 = torch.clamp(xx + l // 2, max=w - 1)
    ones = torch.ones_like(yy)
    corners = []
    for inv_z in (1.0 / near, 1.0 / far):
        for cy, cx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
            corners.append(torch.stack([cy, cx, ones, ones * inv_z], -1))
    return torch.stack(corners, dim=-2)


def _project(mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(4, 4) @ (..., 4) -> (..., 4)."""
    return pts @ mat.transpose(0, 1)


def _box_anchors(kw2c_f: torch.Tensor, scene_pts: torch.Tensor, h: int,
                 w: int):
    """One view's rounded, clipped projections of the 8 scene-space corners
    a pixel: (y_min, x_min, y_max, x_max), each (h, w)."""
    cam = _project(kw2c_f, scene_pts)
    cam = cam / cam[..., 2:3]
    cy = torch.clamp(torch.round(cam[..., 0]), 0, h - 1)
    cx = torch.clamp(torch.round(cam[..., 1]), 0, w - 1)
    return (cy.amin(-1), cx.amin(-1), cy.amax(-1), cx.amax(-1))


def project_bounding_boxes(poses: np.ndarray, bds: np.ndarray, h: int,
                           w: int, patch: int = 3, ref_frame: int = 0,
                           device="cpu") -> torch.Tensor:
    """2-D (depth-free) candidate boxes: the reference frame's patch-frustum
    corners lifted with their homogeneous 1/z only, projected into every
    view, rounded and clamped, and reduced to per-pixel (y_min, x_min,
    y_max, x_max). Their candidate gather is :func:`gather_scene`'s step 3,
    so the 2-D pipeline is a part of the 3-D one. Returns (N, h, w, 4)."""
    K, K_inv, c2w, w2c = unpack_matrices(poses)
    near, far = float(bds.min()), float(bds.max())
    with _matmul_tf32(False):
        corners = pack_frustum_corners(h, w, near, far, patch, device)
        c2wK = torch.as_tensor(c2w[ref_frame] @ K_inv, device=device)
        scene = _project(c2wK, corners)
        kw2c = torch.as_tensor(K[None] @ w2c, device=device)
        return torch.stack([torch.stack(_box_anchors(kw2c[f], scene, h, w),
                                        -1)
                            for f in range(poses.shape[0])])


# Slack of the windowed read's static window over the in-graph anchors, in
# px each side. The box projections run in true fp32 on both sides (numpy
# here, TF32 off on the card), so the anchors differ from this mirror's by
# summation-order ulps at most: a round() flip at an exact .5 is the worst
# case, and 3 px covers several at once.
_WINDOW_MARGIN = 3


def _host_window_geometry(poses: np.ndarray, bds: np.ndarray, h: int, w: int,
                          patch: int, ref_frame: int, row_chunk: int,
                          col_chunk: int):
    """Static window geometry of the windowed candidate read, or None when
    the frame is smaller than one block.

    A numpy mirror of :func:`gather_scene`'s box math (poses only, so it
    runs on the host before the gather): the largest spread of the clipped
    anchors (y_min, x_min) within a (row_chunk x col_chunk) block of any
    frame. The anchors are a clip of a function continuous in the pixel
    index, so a block's spread stays near the chunk plus the parallax even
    at the frame's borders. The per-block bases are exact minima on the
    device; only the window sizes come from here, widened by
    ``_WINDOW_MARGIN`` on each side. Each corner's projection is taken
    through one composed matrix in float64 (on the host's CPU threads), as
    a row term plus a column term, which differs from the device's fp32
    products by ulps (the margin's job). Keep it in step with
    gather_scene.
    """
    m = patch
    if h < row_chunk or w < col_chunk:
        return None
    K, K_inv, c2w, w2c = unpack_matrices(poses)
    near, far = float(bds.min()), float(bds.max())
    n = poses.shape[0]
    f64 = dict(dtype=torch.float64)        # on the host's CPU threads
    ys = torch.arange(h, **f64)
    xs = torch.arange(w, **f64)
    rows = (torch.clamp(ys - m // 2, min=0), torch.clamp(ys + m // 2,
                                                         max=h - 1))
    cols = (torch.clamp(xs - m // 2, min=0), torch.clamp(xs + m // 2,
                                                         max=w - 1))
    c2wK = (c2w[ref_frame] @ K_inv).astype(np.float64)
    ay = np.empty((n, h, w), np.float32)
    ax = np.empty((n, h, w), np.float32)
    for f in range(n):
        # a corner (cy, cx, 1, 1/z) maps to P (z c2wK) (cy, cx, 1, 1/z):
        # affine in cy and cx, so each coordinate is a row term plus a
        # column term on broadcast (h, w) grids
        kw2c = (K @ w2c[f]).astype(np.float64)
        lo_y = lo_x = None
        for z in (near, far):
            mat = (kw2c @ (z * c2wK)).tolist()
            for ry in rows:
                for cx in cols:
                    num = [(mat[i][0] * ry)[:, None]
                           + (mat[i][1] * cx + (mat[i][2] + mat[i][3] / z)
                              )[None, :] for i in range(3)]
                    cy_, cx_ = num[0] / num[2], num[1] / num[2]
                    lo_y = cy_ if lo_y is None else torch.minimum(lo_y, cy_)
                    lo_x = cx_ if lo_x is None else torch.minimum(lo_x, cx_)
        # round and clip are monotone: the min of the rounded corners is
        # the rounded min
        ay[f] = torch.clamp(torch.round(lo_y), 0, h - 1).numpy()
        ax[f] = torch.clamp(torch.round(lo_x), 0, w - 1).numpy()

    h_pad = (h + row_chunk - 1) // row_chunk * row_chunk
    w_pad = (w + col_chunk - 1) // col_chunk * col_chunk
    ay = np.pad(ay, ((0, 0), (0, h_pad - h), (0, w_pad - w)), mode="edge")
    ax = np.pad(ax, ((0, 0), (0, h_pad - h), (0, w_pad - w)), mode="edge")
    sr, sc = h_pad // row_chunk, w_pad // col_chunk
    ayb = ay.reshape(n, sr, row_chunk, sc, col_chunk)
    axb = ax.reshape(n, sr, row_chunk, sc, col_chunk)
    spread_y = int((ayb.max((2, 4)) - ayb.min((2, 4))).max())
    spread_x = int((axb.max((2, 4)) - axb.min((2, 4))).max())

    k0 = spread_y + 1 + 2 * _WINDOW_MARGIN
    kx0 = spread_x + 1 + 2 * _WINDOW_MARGIN
    # (kxw > w is normal: column anchors track the pixel index at slope 1,
    # so KX0 ~ col_chunk + deviation; the saving is in the rows)
    return {"row_chunk": row_chunk, "col_chunk": col_chunk,
            "h_pad": h_pad, "w_pad": w_pad,
            "K0": k0, "KW": k0 + m - 1, "KX0": kx0, "KXW": kx0 + m - 1}


def _frustum_planes(scene_pts: torch.Tensor):
    """The reference frustum's four side planes a pixel, from its (h, w, 8,
    4) scene-space corners (near 0-3, far 4-7): ((normal (h, w, 3), offset
    (h, w)), ...), each through corner a with normal (b - a) x (c - a) for
    (a, b, c) = (0, 2, 4), (1, 3, 5), (0, 1, 5), (2, 3, 6)."""
    sp = scene_pts[..., :3]
    planes = []
    for a, b, c in ((0, 2, 4), (1, 3, 5), (0, 1, 5), (2, 3, 6)):
        nrm = torch.linalg.cross(sp[..., b, :] - sp[..., a, :],
                                 sp[..., c, :] - sp[..., a, :], dim=-1)
        planes.append((nrm, -(nrm * sp[..., a, :]).sum(-1)))
    return tuple(planes)


def _outside(sc: torch.Tensor, planes) -> torch.Tensor:
    """Candidates (h, w, mm, 3) outside the frustum: on one side of both
    planes of a pair (a product of signed distances >= 0)."""
    side = lambda nrm, off: ((sc * nrm[:, :, None, :]).sum(-1)
                             + off[:, :, None])
    (n1, o1), (n2, o2), (n3, o3), (n4, o4) = planes
    return ((side(n1, o1) * side(n2, o2) >= 0)
            | (side(n3, o3) * side(n4, o4) >= 0))


# blocks of the windowed read taken in one batched product: bounds the
# (blocks, P, KW*m*4) intermediate to about this many bytes
_BLOCK_BATCH_BYTES = 1 << 28


def _pad_edge(a: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(h, w) -> (hp, wp), the last row and column repeated."""
    h, w = a.shape
    return F.pad(a[None, None], (0, wp - w, 0, hp - h),
                 mode="replicate")[0, 0]


def _to_blocks(a: torch.Tensor, geo: dict) -> torch.Tensor:
    """(h_pad, w_pad) -> (blocks, P), blocks in row-major (sr, sc) order."""
    rc, cw = geo["row_chunk"], geo["col_chunk"]
    sr, sc = geo["h_pad"] // rc, geo["w_pad"] // cw
    return a.reshape(sr, rc, sc, cw).permute(0, 2, 1, 3).reshape(sr * sc,
                                                                 rc * cw)


def _windowed_candidate_read(planes_pad: torch.Tensor, ay: torch.Tensor,
                             ax: torch.Tensor, by: torch.Tensor,
                             bx: torch.Tensor, geo: dict, m: int,
                             h: int, w: int) -> torch.Tensor:
    """All m*m candidate taps of one frame as windowed one-hot products.

    For each (row_chunk x col_chunk) block of output pixels, the (KW, KXW,
    4) source window at the block's anchor minimum (by, bx) is contracted
    with a column one-hot against an m-column-shifted stack of the window
    (one (P, KX0) @ (KX0, KW*m*4) product), and m shifted row one-hot
    contractions recover the m*m taps. The work scales with the anchors'
    spread within a block, not with the frame. Blocks are batched into
    ``torch.bmm`` calls of at most ``_BLOCK_BATCH_BYTES``; selection by a
    one-hot product in fp32 is exact.

    planes_pad: (h+KW, w+KXW, 4) zero-padded [rgb|depth] planes; ay / ax:
    (h_pad, w_pad) integer-valued fp32 anchors; by / bx: (blocks,) int64
    anchor minima. Returns (h, w, m*m, 4).
    """
    rc, cw = geo["row_chunk"], geo["col_chunk"]
    k0, kw_, kx0, kxw = geo["K0"], geo["KW"], geo["KX0"], geo["KXW"]
    p = rc * cw
    dev, dtype = planes_pad.device, planes_pad.dtype
    ayb, axb = _to_blocks(ay, geo), _to_blocks(ax, geo)
    ks = torch.arange(k0, dtype=dtype, device=dev)
    js = torch.arange(kx0, dtype=dtype, device=dev)
    wr = torch.arange(kw_, device=dev)
    wc = torch.arange(kxw, device=dev)
    group = max(1, _BLOCK_BATCH_BYTES // (p * kw_ * m * 4 * 4))
    out = []
    for s in range(0, by.shape[0], group):
        byg, bxg = by[s:s + group], bx[s:s + group]
        nb = byg.shape[0]
        win = planes_pad[(byg[:, None] + wr)[:, :, None],
                         (bxg[:, None] + wc)[:, None, :]]  # (nb, KW, KXW, 4)
        # column one-hot x m-shifted window stack: tmp[q,p,k,b,:] =
        # win[q, k, (ax - bx) + b, :]
        cx1h = (axb[s:s + nb, :, None] - bxg[:, None, None].to(dtype)
                == js).to(dtype)                              # (nb, P, KX0)
        rhs = torch.stack([win[:, :, b:b + kx0, :] for b in range(m)], 2)
        rhs = rhs.permute(0, 3, 1, 2, 4).reshape(nb, kx0, kw_ * m * 4)
        tmp = torch.bmm(cx1h, rhs).reshape(nb, p, kw_, m * 4)
        # shifted row one-hots: taps[q,p,a,b,:] = tmp[q,p,(ay - by) + a,b,:]
        ry1h = (ayb[s:s + nb, :, None] - byg[:, None, None].to(dtype)
                == ks).to(dtype)                              # (nb, P, K0)
        lhs = ry1h.reshape(nb * p, 1, k0)
        taps = torch.stack(
            [torch.bmm(lhs, tmp[:, :, a:a + k0].reshape(nb * p, k0, m * 4))
             .reshape(nb, p, m, 4) for a in range(m)], 2)    # (nb,P,m,m,4)
        out.append(taps.reshape(nb, p, m * m, 4))
    taps = torch.cat(out)
    sr, sc = geo["h_pad"] // rc, geo["w_pad"] // cw
    taps = taps.reshape(sr, sc, rc, cw, m * m, 4).permute(0, 2, 1, 3, 4, 5)
    return taps.reshape(geo["h_pad"], geo["w_pad"], m * m, 4)[:h, :w]


def gather_scene(imgs: torch.Tensor, depths: torch.Tensor, poses: np.ndarray,
                 bds: np.ndarray, patch: int = 3,
                 sigma: Tuple[float, ...] = (40, 40, 40, 10, 10, 10, 6),
                 ref_frame: int = 0, window: str = "auto",
                 row_chunk: int = 32, col_chunk: int = 112,
                 _plane_filter: bool = True) -> torch.Tensor:
    """Denoise ``ref_frame`` by gathering across all views, on the device
    of ``imgs``.

    imgs: (N, h, w, 3) float; depths: (N, h, w); poses: (N, 3, 5|6) numpy;
    bds: (N, 2) depth bounds. Returns (h, w, 3).

    ``window``: 'auto' and 'off' read each frame's candidates with one exact
    gather; 'on' takes the windowed one-hot read
    (:func:`_windowed_candidate_read`) and refuses a frame smaller than one
    (row_chunk x col_chunk) block. Both give the same candidates. With 'on'
    a drift guard reads one pair of device values after the gather and
    warns when the anchors' spread reached the static window (candidates
    beyond it would be dropped). ``_plane_filter=False`` skips the side-plane
    filter (for tests: the reference frame's own corner candidates lie on
    its side planes, a sign test at a tie).
    """
    if window not in WINDOWS:
        raise ValueError(f"window must be auto|on|off, got {window!r}")
    n_frames, h, w = depths.shape
    geo = None
    if window == "on":
        geo = _host_window_geometry(poses, bds, h, w, patch, ref_frame,
                                    row_chunk, col_chunk)
        if geo is None:
            raise ValueError("window='on' but the derived window does not "
                             f"fit the {h}x{w} frame")
    with _matmul_tf32(False):
        return _gather(imgs, depths, poses, bds, patch, sigma, ref_frame,
                       geo, _plane_filter)


def _gather(imgs, depths, poses, bds, m, sigma, ref_frame, geo, plane_filter):
    dev = imgs.device
    K, K_inv, c2w, w2c = unpack_matrices(poses)
    near, far = float(bds.min()), float(bds.max())
    n_frames, h, w = depths.shape
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # the reference frame's frustum corners in scene space
    cam_pts = pack_frustum_corners(h, w, near, far, m, dev)     # (h,w,8,4)
    c2wK = as_t(c2w[ref_frame] @ K_inv)
    scene_pts = torch.cat([near * _project(c2wK, cam_pts[..., :4, :]),
                           far * _project(c2wK, cam_pts[..., 4:, :])], -2)
    kw2c = as_t(K[None] @ w2c)                                   # (N,4,4)
    c2wK_all = as_t(c2w @ K_inv[None])                           # (N,4,4)
    sigma_inv2 = as_t(1.0 / np.asarray(sigma, np.float32)) ** 2
    gy, gx = torch.meshgrid(torch.arange(m, dtype=torch.float32, device=dev),
                            torch.arange(m, dtype=torch.float32, device=dev),
                            indexing="ij")
    mi = torch.arange(m, device=dev)

    planes = _frustum_planes(scene_pts)

    def read_exact(img_f, depth_f, ymin_f, xmin_f):
        """The m x m patch at each pixel's anchor in one gather; taps past
        the frame's edge read zeros (``in_box`` drops them)."""
        pad = m - 1
        src = F.pad(torch.cat([img_f, depth_f[..., None]], -1),
                    (0, 0, 0, pad, 0, pad))
        ay = torch.clamp(ymin_f, 0, h - 1).long()
        ax = torch.clamp(xmin_f, 0, w - 1).long()
        g = src[(ay[..., None, None] + mi[:, None]),
                (ax[..., None, None] + mi[None, :])]            # (h,w,m,m,4)
        return g.reshape(h, w, m * m, 4)

    def frame_candidates(g, ymin_f, xmin_f, ymax_f, xmax_f, c2wK_f):
        cand_y = ymin_f[..., None, None] + gy                   # (h,w,m,m)
        cand_x = xmin_f[..., None, None] + gx
        in_box = ((cand_y <= ymax_f[..., None, None] + 1e-6)
                  & (cand_x <= xmax_f[..., None, None] + 1e-6)
                  & (cand_y <= h - 1) & (cand_x <= w - 1))
        cand_y = torch.clamp(cand_y, 0, h - 1).reshape(h, w, m * m)
        cand_x = torch.clamp(cand_x, 0, w - 1).reshape(h, w, m * m)
        rgb = g[..., :3]                                        # (h,w,mm,3)
        d = g[..., 3]                                           # (h,w,mm)
        valid = in_box.reshape(h, w, m * m) & (d > 0)
        homog = torch.stack([cand_y * d, cand_x * d, d, torch.ones_like(d)],
                            -1)
        sc = _project(c2wK_f, homog)[..., :3]                   # (h,w,mm,3)
        if not plane_filter:
            return rgb, sc, valid
        return rgb, sc, valid & ~_outside(sc, planes)

    anchors = [_box_anchors(kw2c[f], scene_pts, h, w)
               for f in range(n_frames)]

    # reference features: the reference pixel's rgb, the scene point of its
    # centre candidate (read as the exact read would: zero depth past the
    # edge), t = 0
    dy0, dx0 = divmod((m * m) // 2, m)
    y_min0, x_min0 = anchors[ref_frame][0], anchors[ref_frame][1]
    ay0 = torch.clamp(y_min0, 0, h - 1).long()
    ax0 = torch.clamp(x_min0, 0, w - 1).long()
    in_pad = (ay0 + dy0 <= h - 1) & (ax0 + dx0 <= w - 1)
    d0 = torch.where(in_pad,
                     depths[ref_frame][torch.clamp(ay0 + dy0, max=h - 1),
                                       torch.clamp(ax0 + dx0, max=w - 1)],
                     torch.zeros((), device=dev))
    cy0 = torch.clamp(y_min0 + dy0, 0, h - 1)
    cx0 = torch.clamp(x_min0 + dx0, 0, w - 1)
    homog0 = torch.stack([cy0 * d0, cx0 * d0, d0, torch.ones_like(d0)], -1)
    sc0_center = _project(c2wK_all[ref_frame], homog0)[..., :3]
    ref = torch.cat([imgs[ref_frame], sc0_center,
                     torch.zeros((h, w, 1), device=dev)], -1)   # (h,w,7)

    wsum = torch.zeros((h, w), device=dev)
    rgb_accum = torch.zeros((h, w, 3), device=dev)
    spread = torch.zeros(2, device=dev)
    for t in range(n_frames):
        ymin_f, xmin_f, ymax_f, xmax_f = anchors[t]
        if geo is None:
            g = read_exact(imgs[t], depths[t], ymin_f, xmin_f)
        else:
            hp, wp = geo["h_pad"], geo["w_pad"]
            ay_pad = _pad_edge(ymin_f, hp, wp)
            ax_pad = _pad_edge(xmin_f, hp, wp)
            ayb, axb = _to_blocks(ay_pad, geo), _to_blocks(ax_pad, geo)
            by, bx = ayb.amin(1), axb.amin(1)
            spread = torch.maximum(spread, torch.stack(
                [(ayb.amax(1) - by).amax(), (axb.amax(1) - bx).amax()]))
            planes_f = F.pad(torch.cat([imgs[t], depths[t][..., None]], -1),
                             (0, 0, 0, geo["KXW"], 0, geo["KW"]))
            g = _windowed_candidate_read(planes_f, ay_pad, ax_pad,
                                         by.long(), bx.long(), geo, m, h, w)
        rgb, sc, valid = frame_candidates(g, ymin_f, xmin_f, ymax_f, xmax_f,
                                          c2wK_all[t])
        feats = torch.cat([rgb, sc, torch.full(rgb.shape[:3] + (1,),
                                               float(t), device=dev)], -1)
        diff2 = (ref[:, :, None, :] - feats) ** 2
        weights = torch.exp(-0.5 * (diff2 * sigma_inv2).sum(-1))
        weights = weights * valid.to(weights.dtype)             # (h,w,mm)
        wsum = wsum + weights.sum(-1)
        rgb_accum = rgb_accum + (weights[..., None] * rgb).sum(-2)
    if geo is not None:
        # the drift guard: one read of the device's largest block spreads
        sy, sx = (int(v) for v in spread.tolist())
        if sy >= geo["K0"] or sx >= geo["KX0"]:
            logging.getLogger(__name__).warning(
                "gather_scene: the anchors' block spread (y=%d, x=%d) "
                "reaches the static window (K0=%d, KX0=%d): host mirror "
                "drift; candidates are being dropped. Re-run with "
                "window='off'.", sy, sx, geo["K0"], geo["KX0"])
    return torch.where(wsum[..., None] > 1e-8,
                       rgb_accum / torch.clamp(wsum[..., None], min=1e-8),
                       imgs[ref_frame])
