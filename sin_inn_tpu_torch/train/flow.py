"""Training, inference and frame interpolation of the flow INR.

Counterpart of ``sin_inn_tpu/train/flow.py``: ``pose_grid``,
``flow_forward`` (with the controller's mask for a progressive net),
``_splat_ops`` and ``_flow_offsets`` (the routes of the warps and splats),
the training side (``FlowTrainState``, ``build_flow_model`` with the
``--import-torch`` branch of ``create_flow_state``,
``photometric_flow_loss`` with the window monitors, ``flow_loss``,
``create_flow_state``, ``make_flow_train_step`` with the controller's
transition), ``flow_infer`` (the function ``make_flow_infer`` jits),
``frame_interp`` (the function ``make_frame_interp`` jits, with the same
arithmetic) and ``epe``. PyTorch runs eagerly, so the step is a plain
closure.

One train step at the defaults runs, as the TPU package's step does: the
INR forward (plain PyTorch for a constant mask, the fused kernel K7 forward
under the spatial controller, whose mask reaches it as row slabs) and its
backward as the fused kernel (K7 backward), the window offsets of both
flows (``ops/offsets.py``, plain PyTorch on the device), two local-window
warps (K6 local) and two local-window splats (K5 local) forward, and K6
local's gradient mode four times backward (the two warps' flow gradients,
the two splats' backward). The frames need no gradient, so the backward
launches no K5 local. The controller's transition follows the optimizer
step and reads nothing back from the device; nor do the offsets and the
window monitors, which stay on the device.

On a mesh (``parallel/``) the frame-pair batch is sharded over the data
group: the mask-normalised losses and the PSNR are taken over the whole
batch, the window monitors are maxima over the group, the spatial
controller's cell sums are summed over it, and the step averages the
gradients before the LAMB update, so every rank takes the single-process
step and launches the same windows. A batch the data axis does not divide
is computed whole on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.core.profiler import span
from sin_inn_tpu_torch.models import controllers as ctrl
from sin_inn_tpu_torch.models.inr import (INRSpec, build_inr, flat_leaves,
                                          fused_spatial_mask_format,
                                          inr_apply)
from sin_inn_tpu_torch.ops import losses as L
from sin_inn_tpu_torch.ops.cuda.gather import (resample2d_region,
                                               resample2d_region_local)
from sin_inn_tpu_torch.ops.cuda.splat import (
    softsplat_region_local_with_coverage, softsplat_region_with_coverage)
from sin_inn_tpu_torch.ops.occlusion import occlusion_brox
from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets
from sin_inn_tpu_torch.ops.photometric import (bilateral_smooth, census_loss,
                                               masked_l1, ssim_loss)
from sin_inn_tpu_torch.ops.splat import (softsplat,
                                         softsplat_windowed_with_coverage,
                                         softsplat_with_coverage)
from sin_inn_tpu_torch.ops.warp import resample2d, resample2d_windowed
from sin_inn_tpu_torch.train.optim import lamb


@dataclass
class FlowTrainState:
    """Params (leaves that require grad), their LAMB optimizer, the step,
    and for a progressive net its controller's config and state (None, a
    ``LinearState`` or a ``SpatialState``)."""
    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0
    ctrl_cfg: Any = None
    ctrl_state: Any = None


def controller_config(spec: INRSpec, cfg: FlowConfig):
    """The config of the net's controller: None for a non-progressive net,
    the spatial controller with ``cfg.spatially_adaptive`` (a block every
    3/4 of the epochs over the number of blocks), else the linear ramp."""
    if not spec.is_progressive:
        return None
    if cfg.spatially_adaptive:
        blocks = max((spec.encoding_dim - spec.domain_dim * 2)
                     // (spec.domain_dim * 2), 1)
        return ctrl.SpatialConfig.create(
            spec, cfg.spatial_res,
            block_iterations=max(3 * cfg.epochs // (4 * blocks), 1),
            epsilon=cfg.controller_epsilon)
    return ctrl.LinearConfig.create(spec, cfg.epochs,
                                    epsilon=cfg.controller_epsilon)


def controller_init(ctrl_cfg, device="cpu"):
    """The controller's initial state on ``device`` (None without one)."""
    if ctrl_cfg is None:
        return None
    init = (ctrl.spatial_init if isinstance(ctrl_cfg, ctrl.SpatialConfig)
            else ctrl.linear_init)
    return init(ctrl_cfg, device)


def build_flow_model(gen: torch.Generator, cfg: FlowConfig, device="cpu"):
    """(spec, params, consts, ctrl_cfg, ctrl_state): the config's net and,
    for a progressive one, its controller. With ``cfg.import_torch`` the
    weights, encoding buffers and controller mask come from that reference
    checkpoint, every tensor shape-checked against the config's."""
    spec, params, consts = build_inr(gen, cfg.net, cfg, device)
    ctrl_cfg = controller_config(spec, cfg)
    ctrl_state = controller_init(ctrl_cfg, device)
    if cfg.import_torch:
        from sin_inn_tpu_torch.models.torch_import import \
            load_flow_reference_checkpoint
        params, consts, ctrl_state = load_flow_reference_checkpoint(
            cfg.import_torch, spec, ctrl_cfg, ctrl_state, params, consts)
    return spec, params, consts, ctrl_cfg, ctrl_state


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


def controller_mask(spec: INRSpec, params, consts, ctrl_cfg, ctrl_state,
                    times: torch.Tensor, h: int, w: int, pts: torch.Tensor):
    """(mask, stash): the controller's mask for the pose grid ``pts`` in the
    format the INR's route takes, detached. The spatial controller on a
    (t, y, x) grid emits, by :func:`fused_spatial_mask_format` (the gate
    ``inr_apply`` dispatches by): row slabs for the fused kernels, the split
    per-point pair where the width is no multiple of their tile, the dense
    (n, E) mask for the plain route; in bfloat16 the slabs and per-point
    masks are emitted in bf16. A 2-D cell grid takes the generic point
    lookup, whose indices and weights come back in ``stash`` for the
    update."""
    if ctrl_state is None:
        return None, {}
    if not isinstance(ctrl_state, ctrl.SpatialState):
        return ctrl.linear_mask(ctrl_state).detach(), {}
    if ctrl_cfg.mask_dim != 3:
        mask, inds, alphas = ctrl.spatial_point_mask(ctrl_cfg, ctrl_state, pts)
        return mask.detach(), {"inds": inds, "alphas": alphas}
    mdt = torch.bfloat16 if spec.compute_dtype == "bfloat16" else None
    fmt = fused_spatial_mask_format(spec, params, consts, pts, w)
    make = {"slabs": ctrl.spatial_grid_mask_slabs,
            "split": ctrl.spatial_grid_mask_split,
            "dense": ctrl.spatial_grid_mask}[fmt]
    mask = make(ctrl_cfg, ctrl_state, times, h, w, dtype=mdt)
    if isinstance(mask, tuple):
        return tuple(t.detach() for t in mask), {}
    return mask.detach(), {}


def flow_forward(spec: INRSpec, params, consts, times: torch.Tensor, h: int,
                 w: int, scale, ctrl_cfg=None, ctrl_state=None,
                 stash: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """INR -> (flow12, flow21), each (B, H, W, 2), under the controller's
    mask when there is a controller state. ``stash`` (a dict) receives what
    the controller's update reuses of the mask lookup."""
    pts = pose_grid(times, h, w, spec.domain_dim).reshape(-1, spec.domain_dim)
    with torch.no_grad():
        mask, kept = controller_mask(spec, params, consts, ctrl_cfg,
                                     ctrl_state, times, h, w, pts)
    if stash is not None:
        stash.update(kept)
    with span("model.inr"):
        out = inr_apply(spec, params, consts, pts, mask=mask)
    flows = out.reshape(times.shape[0], h, w, 4) * scale
    return flows[..., :2].contiguous(), flows[..., 2:].contiguous()


_TILE = 128    # the local-window kernels' tile rows and columns


def _splat_ops(cfg: FlowConfig) -> Tuple[Callable, Callable, Optional[Tuple]]:
    """(warp, splat_with_coverage, local_spec) for a config with resolved
    bounds. Both closures take a trailing ``offs``: the ``TileOffsets`` of
    their flow (:func:`_flow_offsets`) when ``local_spec`` is not None,
    ignored otherwise.

    - both bounds, ``use_kernel="auto"`` and the local row bound: the
      local-window kernels (K6 local, K5 local), local_spec = (ldy, ldx,
      capy, capx) with capy = dy rounded up to 8 and, without a local column
      bound, ldx = dx and capx = 0 (no column offsets);
    - both bounds and ``auto``: the static windowed kernels (K6, K5);
    - both bounds and ``off``: the windowed forms, ``resample2d_windowed``
      and the row-windowed ``softsplat_windowed_with_coverage``;
    - dy alone: the exact warp and the row-windowed splat;
    - no bounds: the exact warp and scatter.
    The kernels run their plain versions on CPU tensors."""
    if not cfg.bounds_resolved:
        raise ValueError("_splat_ops needs resolved window bounds "
                         "(FlowConfig.resolve_splat_bounds)")
    dy, dx = cfg.splat_max_dy, cfg.splat_max_dx
    kernels = cfg.use_kernel == "auto"
    if dy and dx and kernels and cfg.splat_local_dy:
        ldy = cfg.splat_local_dy
        capy = -(-dy // 8) * 8
        if cfg.splat_local_dx:
            ldx, capx = cfg.splat_local_dx, -(-dx // 128) * 128
        else:
            ldx, capx = dx, 0
        warp = lambda im, fl, offs: resample2d_region_local(
            im, fl, offs.off_src, ldy, ldx, capy, capx)
        splat_cov = lambda f, fl, m, offs: (
            softsplat_region_local_with_coverage(
                f, fl, m, ldy, ldx, offs.off_out, offs.off_src))
        return warp, splat_cov, (ldy, ldx, capy, capx)
    if dy and dx and kernels:
        warp = lambda im, fl, offs=None: resample2d_region(im, fl, dy, dx)
        splat_cov = lambda f, fl, m, offs=None: softsplat_region_with_coverage(
            f, fl, m, dy, dx)
        return warp, splat_cov, None
    if dy and dx:
        warp = lambda im, fl, offs=None: resample2d_windowed(
            im, fl, dy, cfg.resample_chunk, dx, cfg.splat_col_chunk)
    else:
        warp = lambda im, fl, offs=None: resample2d(im, fl)
    if dy:
        splat_cov = lambda f, fl, m, offs=None: (
            softsplat_windowed_with_coverage(f, fl, m, dy, cfg.splat_chunk))
    else:
        splat_cov = lambda f, fl, m, offs=None: softsplat_with_coverage(
            f, fl, m)
    return warp, splat_cov, None


def _flow_offsets(flow: torch.Tensor, local_spec):
    """The window offsets of one flow (None without a local spec)."""
    if local_spec is None:
        return None
    _, _, capy, capx = local_spec
    return tile_flow_offsets(flow, _TILE, _TILE, capy, capx)


def photometric_flow_loss(cfg: FlowConfig, frame1: torch.Tensor,
                          frame2: torch.Tensor, flow12: torch.Tensor,
                          flow21: torch.Tensor,
                          group=None) -> Tuple[torch.Tensor, Dict]:
    """The model-free part of the training loss: occlusion masks, the
    backward-warp metric, the softmax splat of each frame toward the other,
    then L1, census, SSIM and the edge-aware smoothness. Returns (loss,
    aux); aux's values are detached. With ``group`` (the data group of a
    sharded batch) the masked losses and the PSNR span the whole batch; the
    smoothness is this rank's mean, and the monitors this rank's maxima."""
    b, h, w, _ = frame1.shape
    if not cfg.bounds_resolved:
        cfg = cfg.resolve_splat_bounds(h, w)
    warp, splat_cov, local = _splat_ops(cfg)
    offs21 = _flow_offsets(flow21, local)
    offs12 = _flow_offsets(flow12, local)
    warped2 = warp(frame1, flow21, offs21)
    metric = (frame2 - warped2).abs().mean(-1, keepdim=True)
    warped1 = warp(frame2, flow12, offs12)
    metric2 = (frame1 - warped1).abs().mean(-1, keepdim=True)

    if cfg.occl == "wang":
        # the range map (a splat of ones along the same flow) shares one
        # pass with the softmax splat
        softmax1, cover1 = splat_cov(frame2, flow21, -20.0 * metric, offs21)
        softmax2, cover2 = splat_cov(frame1, flow12, -20.0 * metric2, offs12)
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

    l1 = (masked_l1(softmax1, frame1, mask1, cfg.loss_l1, group)
          + masked_l1(softmax2, frame2, mask2, cfg.loss_l1, group))
    census = (census_loss(softmax1, frame1, mask1, cfg.loss_census,
                          cfg.census_width, group)
              + census_loss(softmax2, frame2, mask2, cfg.loss_census,
                            cfg.census_width, group))
    ssim = (ssim_loss(softmax1, frame1, mask1, cfg.loss_ssim, group=group)
            + ssim_loss(softmax2, frame2, mask2, cfg.loss_ssim,
                        group=group))
    smooth = (bilateral_smooth(frame1, flow12, cfg.loss_smooth1,
                               cfg.edge_func, cfg.edge_constant, 1)
              + bilateral_smooth(frame2, flow21, cfg.loss_smooth1,
                                 cfg.edge_func, cfg.edge_constant, 1))
    loss = l1 + census + ssim + smooth

    with torch.no_grad():
        aux = {"loss": loss.detach(), "l1": l1.detach(),
               "census": census.detach(), "ssim": ssim.detach(),
               "smooth": smooth.detach(),
               "psnr": _batch_psnr(torch.clamp(softmax2, 0, 1), frame2,
                                   group)}
        if cfg.splat_max_dy:
            # window monitor: taps beyond the window are dropped, so the
            # train loop warns when the flow outgrows the bound
            af = torch.maximum(flow12.abs(), flow21.abs())
            aux["flow_max_x"] = af[..., 0].max()
            aux["flow_max_y"] = af[..., 1].max()
        if local is not None:
            # local-window monitor: the drop criterion is the deviation from
            # the tile offsets (both criteria, both directions)
            dev = torch.maximum(
                torch.maximum(offs12.dev_src, offs12.dev_out),
                torch.maximum(offs21.dev_src, offs21.dev_out))
            aux["flow_dev_x"] = dev[0]
            aux["flow_dev_y"] = dev[1]
        # the per-point photometric error map (the spatial controller's
        # signal in the reference)
        err = (((softmax1 - frame1).abs() * mask1).mean(-1)
               + ((softmax2 - frame2).abs() * mask2).mean(-1))
        aux["point_loss"] = (err / 2.0).reshape(-1)
    return loss, aux


def _batch_psnr(x: torch.Tensor, y: torch.Tensor, group) -> torch.Tensor:
    """PSNR of the whole batch (its MSE summed over ``group``'s shards)."""
    if group is None:
        return L.psnr(x, y)
    import torch.distributed as dist
    sq = ((x - y) ** 2).sum()
    dist.all_reduce(sq, group=group)
    mse = sq / (x.numel() * dist.get_world_size(group))
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def flow_loss(spec: INRSpec, cfg: FlowConfig, params, consts, batch: Dict,
              ctrl_cfg=None, ctrl_state=None,
              group=None) -> Tuple[torch.Tensor, Dict]:
    """Bidirectional photometric training loss of one batch
    ({frame1, frame2 (B, H, W, 3), times (B,), scale[, gt_flow]}), under the
    controller's mask. aux["stash"] holds what the controller's update
    reuses. ``group``: the data group of a sharded batch
    (:func:`photometric_flow_loss`)."""
    frame1, frame2 = batch["frame1"], batch["frame2"]
    _, h, w, _ = frame1.shape
    stash: Dict = {}
    flow12, flow21 = flow_forward(spec, params, consts, batch["times"], h, w,
                                  batch["scale"], ctrl_cfg, ctrl_state, stash)
    with span("flow_ops.photometric"):
        loss, aux = photometric_flow_loss(cfg, frame1, frame2, flow12,
                                          flow21, group)
    aux["stash"] = stash
    if "gt_flow" in batch:
        aux["epe"] = epe(flow12.detach(), batch["gt_flow"])
    return loss, aux


def train_state(params, cfg: FlowConfig, opt_state=None, step: int = 0,
                ctrl_cfg=None, ctrl_state=None) -> FlowTrainState:
    """Make ``params`` trainable leaves and build their LAMB optimizer
    (restoring its state from ``opt_state`` when given)."""
    leaves = [t for _, t in flat_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    opt = lamb(leaves, cfg.lr)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    return FlowTrainState(params=params, optimizer=opt, step=step,
                          ctrl_cfg=ctrl_cfg, ctrl_state=ctrl_state)


def create_flow_state(gen: torch.Generator, cfg: FlowConfig):
    """(spec, FlowTrainState, consts): the config's net, drawn from ``gen``
    (a CPU generator) and placed on ``cfg.device``, with LAMB and, for a
    progressive net, its controller's config and initial state."""
    spec, params, consts, ctrl_cfg, ctrl_state = build_flow_model(
        gen, cfg, resolve_device(cfg.device))
    return (spec, train_state(params, cfg, ctrl_cfg=ctrl_cfg,
                              ctrl_state=ctrl_state), consts)


def controller_step(ctrl_cfg, ctrl_state, aux: Dict, batch: Dict,
                    group=None):
    """The controller's transition after one train step: the spatial
    controller takes the per-point photometric error (the scatter-free grid
    form on a (t, y, x) cell grid), the linear one the scalar loss (the
    whole batch's, on a mesh). Its counters live on the host and the loss
    stays on the device, so nothing here waits for the card. ``group``: the
    data group of a sharded batch, over which the cell sums are summed."""
    if ctrl_state is None:
        return None
    if isinstance(ctrl_state, ctrl.SpatialState):
        if ctrl_cfg.mask_dim == 3:
            _, h, w, _ = batch["frame1"].shape
            return ctrl.spatial_grid_update(ctrl_cfg, ctrl_state,
                                            aux["point_loss"],
                                            batch["times"], h, w, group)
        return ctrl.spatial_update(ctrl_cfg, ctrl_state, aux["point_loss"],
                                   aux["stash"]["inds"],
                                   aux["stash"]["alphas"], group)
    return ctrl.linear_update(ctrl_cfg, ctrl_state, aux["loss"])


MONITOR_KEYS = ("flow_max_x", "flow_max_y", "flow_dev_x", "flow_dev_y")


def make_flow_train_step(spec: INRSpec, cfg: FlowConfig, mesh=None):
    """Returns fn(state, consts, batch) -> metrics: one gradient of
    :func:`flow_loss` under the state's controller mask, one LAMB update in
    place, then the controller's transition. The metrics stay tensors on
    the device (the loop reads them at its own cadence). With ``mesh`` the
    batch is a placed one; the gradients are averaged over the data group
    and the metrics are the whole batch's (the monitors its maxima)."""
    from sin_inn_tpu_torch.parallel.sharding import (data_group,
                                                     reduce_metrics,
                                                     sync_grads)

    def step(state: FlowTrainState, consts, batch) -> Dict:
        group = data_group(mesh, batch)
        with span("step.loss"):
            state.optimizer.zero_grad(set_to_none=True)
            loss, aux = flow_loss(spec, cfg, state.params, consts, batch,
                                  state.ctrl_cfg, state.ctrl_state, group)
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            sync_grads(mesh, state.optimizer.param_groups[0]["params"])
            state.optimizer.step()
        with span("step.controller"), torch.no_grad():
            metrics = reduce_metrics(
                mesh, {k: v for k, v in aux.items()
                       if k not in ("stash", "point_loss")}, MONITOR_KEYS)
            state.ctrl_state = controller_step(
                state.ctrl_cfg, state.ctrl_state,
                dict(aux, loss=metrics["loss"]), batch, group)
        state.step += 1
        return metrics

    return step


def flow_infer(spec: INRSpec, params, consts, times: torch.Tensor,
               scale, h: int, w: int, ctrl_cfg=None, ctrl_state=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flow12, flow21) at the frame ``times`` under the controller's mask
    (the function of ``make_flow_infer``)."""
    with torch.no_grad():
        return flow_forward(spec, params, consts, times, h, w, scale,
                            ctrl_cfg, ctrl_state)


def frame_interp(spec: INRSpec, cfg: FlowConfig, params, consts, t0,
                 frames2: torch.Tensor, alpha: float, scale,
                 ctrl_cfg=None, ctrl_state=None) -> torch.Tensor:
    """One softsplat mid-frame between frames2[0] and frames2[1] (2, H, W, 3)
    at t0 + alpha (t1 - t0): both flows queried at the pair's time t0, the
    -20 L1 photometric softmax metric of each direction, each endpoint
    splatted along its alpha-scaled flow, the two blended (1 - alpha,
    alpha) where covered, the cross-fade where neither covers. alpha = 0
    and 1 reproduce the endpoint frames. Returns (H, W, 3).

    A config whose local bound is still 'auto' (no training evidence: the
    entry points apply the training run's bounds from its sidecar first)
    serves on the static windows; each splat flow gets its own offsets."""
    h, w = frames2.shape[1:3]
    if not cfg.bounds_resolved:
        if cfg.splat_local_dy == "auto":
            cfg = cfg.replace(splat_local_dy="off", splat_local_dx="off")
        cfg = cfg.resolve_splat_bounds(h, w)
    warp, splat_cov, local = _splat_ops(cfg)
    offs = lambda fl: _flow_offsets(fl, local)
    with torch.no_grad():
        t0 = torch.as_tensor(t0, dtype=torch.float32,
                             device=frames2.device).reshape(1)
        f12, f21 = flow_forward(spec, params, consts, t0, h, w, scale,
                                ctrl_cfg, ctrl_state)
        frame0, frame1 = frames2[0:1], frames2[1:2]
        flow01, flow10 = f12[0:1], f21[0:1]
        alpha = float(alpha)
        m0 = (frame0 - warp(frame1, flow01, offs(flow01))
              ).abs().mean(-1, keepdim=True)
        m1 = (frame1 - warp(frame0, flow10, offs(flow10))
              ).abs().mean(-1, keepdim=True)
        f0, f1 = alpha * flow01, (1.0 - alpha) * flow10
        s0, c0 = splat_cov(frame0, f0, -20.0 * m0, offs(f0))
        s1, c1 = splat_cov(frame1, f1, -20.0 * m1, offs(f1))
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
