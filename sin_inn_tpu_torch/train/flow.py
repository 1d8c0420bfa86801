"""Flow inference and frame interpolation from a fitted INR.

Counterpart of the serving half of ``sin_inn_tpu/train/flow.py``:
``pose_grid``, ``flow_forward`` (non-progressive nets: no controller
state), ``_splat_ops`` (the static routes), ``flow_infer`` (the function
``make_flow_infer`` jits), ``frame_interp`` (the function
``make_frame_interp`` jits, with the same arithmetic) and ``epe``. PyTorch
runs eagerly, so these are plain functions. The training step, the
controllers and the local-window kernels come with the training slice: a
trained net whose window sidecar names local windows is refused where the
sidecar is read (``train/loop.py`` ``_load_window_bounds``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.models.inr import INRSpec, inr_apply
from sin_inn_tpu_torch.ops.cuda.gather import resample2d_region
from sin_inn_tpu_torch.ops.cuda.splat import softsplat_region_with_coverage
from sin_inn_tpu_torch.ops.splat import softsplat_with_coverage
from sin_inn_tpu_torch.ops.warp import resample2d


def pose_grid(times: torch.Tensor, h: int, w: int,
              domain_dim: int = 3) -> torch.Tensor:
    """(B,) frame times -> (B, H, W, d) of (t, y, x) in [-1, 1]^3, or
    (y, x) for 2-D-domain nets."""
    dev = times.device
    ys = torch.linspace(-1.0, 1.0, h, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    b = times.shape[0]
    gy = gy[None].expand(b, h, w)
    gx = gx[None].expand(b, h, w)
    if domain_dim == 2:
        return torch.stack([gy, gx], dim=-1)
    t = times[:, None, None].expand(b, h, w)
    return torch.stack([t, gy, gx], dim=-1)


def flow_forward(spec: INRSpec, params, consts, times: torch.Tensor, h: int,
                 w: int, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """INR -> (flow12, flow21), each (B, H, W, 2), for a non-progressive
    net (``build_inr`` refuses the others until the controllers land)."""
    pts = pose_grid(times, h, w, spec.domain_dim).reshape(-1, spec.domain_dim)
    out = inr_apply(spec, params, consts, pts)
    flows = out.reshape(times.shape[0], h, w, 4) * scale
    return flows[..., :2].contiguous(), flows[..., 2:].contiguous()


def _splat_ops(cfg: FlowConfig) -> Tuple[Callable, Callable]:
    """(warp, splat_with_coverage) for a config with resolved bounds.

    Both bounds set: the windowed gather (K6) and splat (K5), which run
    their kernels on CUDA tensors and their plain versions on CPU tensors.
    No bounds: the exact resample2d and scatter. The row-only window (dy
    without dx) needs ``softsplat_windowed_with_coverage``, which is not
    ported, and raises."""
    if not cfg.bounds_resolved:
        raise ValueError("_splat_ops needs resolved window bounds "
                         "(FlowConfig.resolve_splat_bounds)")
    dy, dx = cfg.splat_max_dy, cfg.splat_max_dx
    if dy and dx:
        warp = lambda im, fl: resample2d_region(im, fl, dy, dx)
        splat_cov = lambda f, fl, m: softsplat_region_with_coverage(
            f, fl, m, dy, dx)
        return warp, splat_cov
    if dy:
        raise NotImplementedError(
            "a row-only splat window (splat_max_dy without splat_max_dx) "
            "needs softsplat_windowed_with_coverage, which is not ported")
    return resample2d, softsplat_with_coverage


def flow_infer(spec: INRSpec, params, consts, times: torch.Tensor,
               scale, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flow12, flow21) at the frame ``times`` (the function of
    ``make_flow_infer``)."""
    with torch.no_grad():
        return flow_forward(spec, params, consts, times, h, w, scale)


def frame_interp(spec: INRSpec, cfg: FlowConfig, params, consts, t0,
                 frames2: torch.Tensor, alpha: float,
                 scale) -> torch.Tensor:
    """One softsplat mid-frame between frames2[0] and frames2[1] (2, H, W, 3)
    at t0 + alpha (t1 - t0): both flows queried at the pair's time t0, the
    -20 L1 photometric softmax metric of each direction, each endpoint
    splatted along its alpha-scaled flow, the two blended (1 - alpha,
    alpha) where covered, the cross-fade where neither covers. alpha = 0
    and 1 reproduce the endpoint frames. Returns (H, W, 3)."""
    h, w = frames2.shape[1:3]
    warp, splat_cov = _splat_ops(cfg.resolve_splat_bounds(h, w))
    with torch.no_grad():
        t0 = torch.as_tensor(t0, dtype=torch.float32,
                             device=frames2.device).reshape(1)
        f12, f21 = flow_forward(spec, params, consts, t0, h, w, scale)
        frame0, frame1 = frames2[0:1], frames2[1:2]
        flow01, flow10 = f12[0:1], f21[0:1]
        alpha = float(alpha)
        m0 = (frame0 - warp(frame1, flow01)).abs().mean(-1, keepdim=True)
        m1 = (frame1 - warp(frame0, flow10)).abs().mean(-1, keepdim=True)
        s0, c0 = splat_cov(frame0, alpha * flow01, -20.0 * m0)
        s1, c1 = splat_cov(frame1, (1.0 - alpha) * flow10, -20.0 * m1)
        w0 = (1.0 - alpha) * (c0 > 0.0).to(frames2.dtype)
        w1 = alpha * (c1 > 0.0).to(frames2.dtype)
        den = w0 + w1
        fade = (1.0 - alpha) * frame0 + alpha * frame1
        blend = torch.where(den > 0.0,
                            (w0 * s0 + w1 * s1) / torch.clamp(den, min=1e-8),
                            fade)
    return blend[0]


def epe(flow: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """End-point error."""
    return torch.sqrt(((flow - gt) ** 2).sum(-1)).mean()
