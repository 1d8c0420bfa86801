"""Training, inference and frame interpolation of the flow INR.

Counterpart of ``sin_inn_tpu/train/flow.py`` for the non-progressive nets
on the static (global) windows: ``pose_grid``, ``flow_forward`` (no
controller state), ``_splat_ops`` (the static routes), the training side
(``FlowTrainState``, ``build_flow_model``, ``photometric_flow_loss``,
``flow_loss``, ``create_flow_state``, ``make_flow_train_step``), ``flow_infer``
(the function ``make_flow_infer`` jits), ``frame_interp`` (the function
``make_frame_interp`` jits, with the same arithmetic) and ``epe``. PyTorch
runs eagerly, so the step is a plain closure.

One train step on the kernel route runs, as the TPU package's step does
with its local windows off: the INR forward as plain PyTorch and its
backward as the fused kernel (K7 backward), two windowed warps (K6) and two
windowed splats (K5) forward, and the gather kernel's gradient mode four
times backward (the two warps' flow gradients, the two splats' backward).
The frames need no gradient, so the backward launches no K5.

The progressive nets with their controllers and the local-window kernels
are not ported yet: a trained net whose window sidecar names local windows
is refused where the sidecar is read (``train/loop.py``
``_load_window_bounds``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.models.inr import (INRSpec, build_inr, flat_leaves,
                                          inr_apply)
from sin_inn_tpu_torch.ops import losses as L
from sin_inn_tpu_torch.ops.cuda.gather import resample2d_region
from sin_inn_tpu_torch.ops.cuda.splat import softsplat_region_with_coverage
from sin_inn_tpu_torch.ops.occlusion import occlusion_brox
from sin_inn_tpu_torch.ops.photometric import (bilateral_smooth, census_loss,
                                               masked_l1, ssim_loss)
from sin_inn_tpu_torch.ops.splat import softsplat, softsplat_with_coverage
from sin_inn_tpu_torch.ops.warp import resample2d
from sin_inn_tpu_torch.train.optim import lamb


@dataclass
class FlowTrainState:
    """Params (leaves that require grad), their LAMB optimizer, the step.
    The controller state joins with the progressive nets."""
    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def build_flow_model(gen: torch.Generator, cfg: FlowConfig, device="cpu"):
    """(spec, params, consts) of the config's net (non-progressive: no
    controller to wire)."""
    return build_inr(gen, cfg.net, cfg, device)


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


def photometric_flow_loss(cfg: FlowConfig, frame1: torch.Tensor,
                          frame2: torch.Tensor, flow12: torch.Tensor,
                          flow21: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """The model-free part of the training loss: occlusion masks, the
    backward-warp metric, the softmax splat of each frame toward the other,
    then L1, census, SSIM and the edge-aware smoothness. Returns (loss,
    aux); aux's values are detached."""
    b, h, w, _ = frame1.shape
    if not cfg.bounds_resolved:
        cfg = cfg.resolve_splat_bounds(h, w)
    warp, splat_cov = _splat_ops(cfg)
    warped2 = warp(frame1, flow21)
    metric = (frame2 - warped2).abs().mean(-1, keepdim=True)
    warped1 = warp(frame2, flow12)
    metric2 = (frame1 - warped1).abs().mean(-1, keepdim=True)

    if cfg.occl == "wang":
        # the range map (a splat of ones along the same flow) shares one
        # pass with the softmax splat
        softmax1, cover1 = splat_cov(frame2, flow21, -20.0 * metric)
        softmax2, cover2 = splat_cov(frame1, flow12, -20.0 * metric2)
        mask1 = (cover1 > cfg.occl_thresh).to(frame1.dtype)
        mask2 = (cover2 > cfg.occl_thresh).to(frame1.dtype)
    else:
        softmax1 = softsplat(frame2, flow21, -20.0 * metric, "softmax")
        softmax2 = softsplat(frame1, flow12, -20.0 * metric2, "softmax")
        if cfg.occl == "brox":
            with torch.no_grad():
                mask1 = occlusion_brox(flow12, flow21, cfg.occl_thresh)
                mask2 = occlusion_brox(flow21, flow12, cfg.occl_thresh)
        else:
            mask1 = torch.ones((b, h, w, 1), dtype=frame1.dtype,
                               device=frame1.device)
            mask2 = torch.ones_like(mask1)

    mask1 = mask1 * (softmax1 != 0.0).to(frame1.dtype)
    mask2 = mask2 * (softmax2 != 0.0).to(frame1.dtype)

    l1 = (masked_l1(softmax1, frame1, mask1, cfg.loss_l1)
          + masked_l1(softmax2, frame2, mask2, cfg.loss_l1))
    census = (census_loss(softmax1, frame1, mask1, cfg.loss_census,
                          cfg.census_width)
              + census_loss(softmax2, frame2, mask2, cfg.loss_census,
                            cfg.census_width))
    ssim = (ssim_loss(softmax1, frame1, mask1, cfg.loss_ssim)
            + ssim_loss(softmax2, frame2, mask2, cfg.loss_ssim))
    smooth = (bilateral_smooth(frame1, flow12, cfg.loss_smooth1,
                               cfg.edge_func, cfg.edge_constant, 1)
              + bilateral_smooth(frame2, flow21, cfg.loss_smooth1,
                                 cfg.edge_func, cfg.edge_constant, 1))
    loss = l1 + census + ssim + smooth

    with torch.no_grad():
        aux = {"loss": loss.detach(), "l1": l1.detach(),
               "census": census.detach(), "ssim": ssim.detach(),
               "smooth": smooth.detach(),
               "psnr": L.psnr(torch.clamp(softmax2, 0, 1), frame2)}
        if cfg.splat_max_dy:
            # window monitor: taps beyond the window are dropped, so the
            # train loop warns when the flow outgrows the bound
            af = torch.maximum(flow12.abs(), flow21.abs())
            aux["flow_max_x"] = af[..., 0].max()
            aux["flow_max_y"] = af[..., 1].max()
        # the per-point photometric error map (the spatial controller's
        # signal in the reference)
        err = (((softmax1 - frame1).abs() * mask1).mean(-1)
               + ((softmax2 - frame2).abs() * mask2).mean(-1))
        aux["point_loss"] = (err / 2.0).reshape(-1)
    return loss, aux


def flow_loss(spec: INRSpec, cfg: FlowConfig, params, consts,
              batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Bidirectional photometric training loss of one batch
    ({frame1, frame2 (B, H, W, 3), times (B,), scale[, gt_flow]})."""
    frame1, frame2 = batch["frame1"], batch["frame2"]
    _, h, w, _ = frame1.shape
    flow12, flow21 = flow_forward(spec, params, consts, batch["times"], h, w,
                                  batch["scale"])
    loss, aux = photometric_flow_loss(cfg, frame1, frame2, flow12, flow21)
    if "gt_flow" in batch:
        aux["epe"] = epe(flow12.detach(), batch["gt_flow"])
    return loss, aux


def train_state(params, cfg: FlowConfig, opt_state=None,
                step: int = 0) -> FlowTrainState:
    """Make ``params`` trainable leaves and build their LAMB optimizer
    (restoring its state from ``opt_state`` when given)."""
    leaves = [t for _, t in flat_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    opt = lamb(leaves, cfg.lr)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    return FlowTrainState(params=params, optimizer=opt, step=step)


def create_flow_state(gen: torch.Generator, cfg: FlowConfig):
    """(spec, FlowTrainState, consts): the config's net, drawn from ``gen``
    (a CPU generator) and placed on ``cfg.device``, with LAMB."""
    spec, params, consts = build_flow_model(gen, cfg,
                                            resolve_device(cfg.device))
    return spec, train_state(params, cfg), consts


def make_flow_train_step(spec: INRSpec, cfg: FlowConfig):
    """Returns fn(state, consts, batch) -> metrics: one gradient of
    :func:`flow_loss` and one LAMB update, in place. The metrics stay
    tensors on the device (the loop reads them at its own cadence)."""

    def step(state: FlowTrainState, consts, batch) -> Dict:
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = flow_loss(spec, cfg, state.params, consts, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v for k, v in aux.items() if k != "point_loss"}

    return step


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
