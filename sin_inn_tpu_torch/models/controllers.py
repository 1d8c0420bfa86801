"""Progressive frequency-encoding controllers as plain functions on explicit
state.

Counterpart of ``sin_inn_tpu/models/controllers.py``: every controller is a
frozen config, a NamedTuple state and pure functions ``init`` / ``update`` /
``mask`` that return a new state (no tensor of the old state is written).
Five controllers:

* ``LinearState``: the global coarse-to-fine ramp, frozen early once the
  best loss drops under ``epsilon`` (``epsilon = 0``: never);
* ``SpatialState``: spatially adaptive: per-point losses accumulated on a
  ``res^d`` cell grid, a per-cell progress gate every ``block_iterations``
  steps, the mask looked up by multilinear interpolation of the box-blurred
  cell mask; with the regular-grid forms the flow trainer uses for its dense
  (t, y, x) pose grid, where the interpolation factors per axis;
* ``AdaptiveState``: a block unlocks when the loss curve flattens;
* ``FixedSpatialState``: a per-sample mask over a fixed input grid.

What lives where. A counter that follows the step count alone (every
``iteration``; the spatial controller's ``cur_block`` and ``next_block``) is
a Python int on the host, so a transition reads nothing back from the
device. Whatever depends on a loss (masks, gates, the linear controller's
block pointers behind its early freeze, the adaptive controller's status)
is a tensor on the state's device, updated behind ``torch.where``.

The arithmetic follows the JAX package operation by operation in float32
(the same order of sums in the box blur, ``ceil(xs + 1e-6)`` in the hat
weights), so that the thresholds fall on the same side in both.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sin_inn_tpu_torch.models.inr import INRSpec


def _ramp_alpha(it: int, block_iterations: int) -> float:
    """min(1, 2 (it mod B) / B), rounded as float32 arithmetic rounds it."""
    return float(min(np.float32(1.0),
                     np.float32(2.0 * (it % block_iterations))
                     / np.float32(block_iterations)))


def _next_block(next_block, block_size: int, encoding_dim: int):
    """The block pointer after ``next_block`` (an int or an int tensor): the
    last, short block is merged into the one before it."""
    nb = next_block + block_size
    if isinstance(nb, torch.Tensor):
        return torch.where(encoding_dim - nb < block_size,
                           torch.full_like(nb, encoding_dim), nb)
    return encoding_dim if encoding_dim - nb < block_size else nb


def _first_block_mask(rows: Tuple[int, ...], block_size: int,
                      encoding_dim: int, device) -> torch.Tensor:
    mask = torch.zeros((*rows, encoding_dim), dtype=torch.float32,
                       device=device)
    mask[..., :block_size] = 1.0
    return mask


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


# ===========================================================================
# Linear controller (global ramp, optional early freeze)
# ===========================================================================

@dataclass(frozen=True)
class LinearConfig:
    encoding_dim: int
    block_size: int
    num_blocks: int
    block_iterations: int
    progress_iterations: int
    epsilon: float = 0.0          # 0: no early freeze

    @classmethod
    def create(cls, spec: INRSpec, max_iteration: int, epsilon: float = 0.0,
               num_blocks: Optional[int] = None) -> "LinearConfig":
        e = spec.encoding_dim
        if num_blocks is None:
            block_size = spec.domain_dim * 2
            num_blocks = (e - block_size) // block_size
        else:
            block_size = e // num_blocks
        block_iterations = max(3 * max_iteration // (4 * num_blocks), 1)
        return cls(encoding_dim=e, block_size=block_size,
                   num_blocks=num_blocks, block_iterations=block_iterations,
                   progress_iterations=block_iterations * num_blocks,
                   epsilon=epsilon)


class LinearState(NamedTuple):
    mask: torch.Tensor         # (encoding_dim,)
    iteration: int             # host counter
    cur_block: torch.Tensor    # i32 scalar
    next_block: torch.Tensor   # i32 scalar
    best_score: torch.Tensor   # f32 scalar


def linear_init(cfg: LinearConfig, device="cpu") -> LinearState:
    return LinearState(
        mask=_first_block_mask((), cfg.block_size, cfg.encoding_dim, device),
        iteration=0,
        cur_block=_i32(cfg.block_size, device),
        next_block=_i32(2 * cfg.block_size, device),
        best_score=torch.tensor(1e4, dtype=torch.float32, device=device))


def linear_update(cfg: LinearConfig, state: LinearState,
                  loss: torch.Tensor) -> LinearState:
    """One step: ramp the current block, advance the pointers on a block
    boundary, and freeze everything past the schedule or, with ``epsilon``,
    once the best loss is under it. ``loss`` stays on the device."""
    loss = loss.detach().to(state.best_score.dtype)
    best = torch.minimum(state.best_score, loss)
    it = state.iteration + 1
    if it > cfg.progress_iterations:             # past the schedule: frozen
        return state._replace(iteration=it, best_score=best)
    idx = torch.arange(cfg.encoding_dim, device=state.mask.device)
    in_window = (idx >= state.cur_block) & (idx < state.next_block)
    if it % cfg.block_iterations == 0:           # a block boundary
        mask_new = torch.where(in_window, 1.0, state.mask)
        cur_new = state.next_block
        next_new = _next_block(state.next_block, cfg.block_size,
                               cfg.encoding_dim)
    else:
        mask_new = torch.where(
            in_window, _ramp_alpha(it, cfg.block_iterations), state.mask)
        cur_new, next_new = state.cur_block, state.next_block
    if cfg.epsilon > 0:
        frozen = best < cfg.epsilon
        mask_new = torch.where(frozen, state.mask, mask_new)
        cur_new = torch.where(frozen, state.cur_block, cur_new)
        next_new = torch.where(frozen, state.next_block, next_new)
    return LinearState(mask=mask_new, iteration=it,
                       cur_block=cur_new.to(torch.int32),
                       next_block=next_new.to(torch.int32), best_score=best)


def linear_mask(state: LinearState) -> torch.Tensor:
    return state.mask


# ===========================================================================
# Stashed spatial controller (per-cell progress on a res^d grid)
# ===========================================================================

@dataclass(frozen=True)
class SpatialConfig:
    encoding_dim: int
    domain_dim: int            # of the input coordinates
    mask_dim: int              # dimensions of the cell grid
    res: int
    cells: int
    block_size: int
    num_blocks: int
    block_iterations: int
    epsilon: float
    k: int                     # box-blur width

    @classmethod
    def create(cls, spec: INRSpec, res: int, block_iterations: int = 20,
               epsilon: float = 1e-3,
               mask_dim: Optional[int] = None) -> "SpatialConfig":
        res = max(res, 3)
        mask_dim = spec.domain_dim if mask_dim is None else mask_dim
        cells = res ** mask_dim
        block_size = spec.domain_dim * 2
        num_blocks = (spec.encoding_dim - block_size) // block_size
        return cls(encoding_dim=spec.encoding_dim, domain_dim=spec.domain_dim,
                   mask_dim=mask_dim, res=res, cells=cells,
                   block_size=block_size, num_blocks=num_blocks,
                   block_iterations=max(block_iterations, 1),
                   epsilon=epsilon, k=5 if cells > 100 else 3)


class SpatialState(NamedTuple):
    mask: torch.Tensor         # (cells, encoding_dim)
    in_progress: torch.Tensor  # (cells,) bool
    log_buffer: torch.Tensor   # (cells,) f32 accumulated loss
    log_counter: torch.Tensor  # (cells,) f32 accumulated weights
    iteration: int             # host counter, reset at each block advance
    cur_block: int             # host
    next_block: int            # host


def spatial_init(cfg: SpatialConfig, device="cpu") -> SpatialState:
    return SpatialState(
        mask=_first_block_mask((cfg.cells,), cfg.block_size,
                               cfg.encoding_dim, device),
        in_progress=torch.ones(cfg.cells, dtype=torch.bool, device=device),
        log_buffer=torch.zeros(cfg.cells, device=device),
        log_counter=torch.zeros(cfg.cells, device=device),
        iteration=0, cur_block=cfg.block_size,
        next_block=2 * cfg.block_size)


def _hat_coords(cfg, coords: torch.Tensor):
    """(xs, lo, hi) of coordinates in [-1, 1] on the cell axis. In float32,
    for an integer xs >= 32 the 1e-6 is under half an ulp, so hi == lo and
    both hat weights are 0: kept, the reference does the same."""
    xs = ((coords + 1.0) / 2.0) * max(cfg.res - 2, 1) + 0.5
    return xs, torch.floor(xs), torch.ceil(xs + 1e-6)


def _cell_interp(cfg: SpatialConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multilinear cell indices and weights of points in [-1, 1]^d.
    x: (n, d). Returns inds (n, 2^d) int64 and alphas (n, 2^d). Bit
    (d - 1 - j) of a corner's number selects lo or hi for coordinate j."""
    d = cfg.mask_dim
    xs, lo, hi = _hat_coords(cfg, x[:, :d])
    a_lo, a_hi = hi - xs, xs - lo
    inds, alphas = [], []
    for corner in range(2 ** d):
        idx = torch.zeros_like(xs[:, 0])
        alpha = torch.ones_like(xs[:, 0])
        for j in range(d):
            sel = (corner >> (d - 1 - j)) & 1
            comp = hi[:, j] if sel else lo[:, j]
            idx = idx + torch.clamp(comp, 0, cfg.res - 1) * (cfg.res ** j)
            alpha = alpha * (a_hi[:, j] if sel else a_lo[:, j])
        inds.append(idx.to(torch.int64))
        alphas.append(alpha)
    return torch.stack(inds, 1), torch.stack(alphas, 1)


def _pad_edge(g: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    first = g.narrow(axis, 0, 1)
    last = g.narrow(axis, g.shape[axis] - 1, 1)
    reps = [1] * g.dim()
    reps[axis] = n
    return torch.cat([first.repeat(reps), g, last.repeat(reps)], dim=axis)


def _box_blur_cells(cfg: SpatialConfig, v: torch.Tensor) -> torch.Tensor:
    """Box-blur a per-cell field (cells, E) or (cells,) over the res^d grid
    with replicate padding: per axis, k shifted slices summed in order and
    divided by k."""
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    e = v.shape[1]
    grid = v.reshape(*([cfg.res] * cfg.mask_dim), e)
    half = cfg.k // 2
    for axis in range(cfg.mask_dim):
        padded = _pad_edge(grid, axis, half)
        acc = torch.zeros_like(grid)
        for s in range(cfg.k):
            acc = acc + padded.narrow(axis, s, grid.shape[axis])
        grid = acc / cfg.k
    out = grid.reshape(cfg.cells, e)
    return out[:, 0] if squeeze else out


def spatial_point_mask(cfg: SpatialConfig, state: SpatialState,
                       x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-point mask of arbitrary points by multilinear interpolation
    of the blurred cell mask. Returns (mask (n, E), inds, alphas); inds and
    alphas are the stash the loss scatter reuses. One corner at a time: the
    (n, 2^d, E) gather is never built (22 GB at 436 x 1024 x 3 points)."""
    inds, alphas = _cell_interp(cfg, x)
    blurred = _box_blur_cells(cfg, state.mask)
    mask = torch.zeros((x.shape[0], cfg.encoding_dim), dtype=blurred.dtype,
                       device=blurred.device)
    for c in range(inds.shape[1]):
        mask = mask + blurred[inds[:, c]] * alphas[:, c:c + 1]
    return mask, inds, alphas


def _stash_ramp(cfg: SpatialConfig, state: SpatialState,
                log_buffer: torch.Tensor,
                log_counter: torch.Tensor) -> SpatialState:
    """Store the accumulated buffers and ramp the current block of the
    cells still in progress."""
    it = state.iteration + 1
    mask = state.mask
    if it < cfg.block_iterations * (cfg.num_blocks + 1):
        alpha = _ramp_alpha(it, cfg.block_iterations)
        mask = mask.clone()
        win = mask[:, state.cur_block:state.next_block]
        win.copy_(torch.where(state.in_progress[:, None],
                              torch.clamp(win, min=alpha), win))
    return state._replace(mask=mask, log_buffer=log_buffer,
                          log_counter=log_counter, iteration=it)


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over a data group's shards (itself without one)."""
    if group is not None:
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


def spatial_stash(cfg: SpatialConfig, state: SpatialState,
                  point_loss: torch.Tensor, inds: torch.Tensor,
                  alphas: torch.Tensor, group=None) -> SpatialState:
    """Accumulate per-point losses into their cells and ramp the block
    (over every shard of ``group``'s batch, with one)."""
    w = (point_loss.detach()[:, None] * alphas).reshape(-1)
    flat = inds.reshape(-1)
    if group is None:
        return _stash_ramp(cfg, state,
                           state.log_buffer.index_add(0, flat, w),
                           state.log_counter.index_add(0, flat,
                                                       alphas.reshape(-1)))
    zero = torch.zeros_like(state.log_buffer)
    return _stash_ramp(
        cfg, state,
        state.log_buffer + _group_sum(zero.index_add(0, flat, w), group),
        state.log_counter + _group_sum(
            torch.zeros_like(state.log_counter).index_add(
                0, flat, alphas.reshape(-1)), group))


# --------------------------------------------------------------------------
# Regular-grid forms: the flow trainer's points are the dense (t, y, x) pose
# grid, so the multilinear weights factor per axis and the per-point gathers
# and scatters become three small contractions
# --------------------------------------------------------------------------

def grid_axis_weights(cfg: SpatialConfig, coords: torch.Tensor) -> torch.Tensor:
    """(n, res) dense multilinear weights of one axis: the separable factor
    of :func:`_cell_interp`'s corner weights."""
    xs, lo, hi = _hat_coords(cfg, coords)
    r = torch.arange(cfg.res, dtype=xs.dtype, device=xs.device)[None, :]
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    return (torch.where(r == torch.clamp(lo, 0, cfg.res - 1)[:, None],
                        (hi - xs)[:, None], zero)
            + torch.where(r == torch.clamp(hi, 0, cfg.res - 1)[:, None],
                          (xs - lo)[:, None], zero))


def _blur_axis_matrix(cfg: SpatialConfig, device="cpu") -> torch.Tensor:
    """(res, res) operator of one axis of :func:`_box_blur_cells`. Blur and
    contraction commute per axis, so folding it into the (n, res) hat
    weights (``w @ B``) blurs without ever building the blurred (cells, E)
    grid. Built on ``device`` once per (res, k) and kept: a copy from the
    host each step would make the host wait for the card."""
    return _blur_matrix(cfg.res, cfg.k, str(device))


@functools.lru_cache(maxsize=None)
def _blur_matrix(res: int, k: int, device: str) -> torch.Tensor:
    half = k // 2
    b = torch.zeros((res, res), dtype=torch.float32, device=device)
    i = torch.arange(res, device=device)
    for s in range(k):
        b.index_put_((i, torch.clamp(i + s - half, 0, res - 1)),
                     torch.full((res,), 1.0 / k, device=device),
                     accumulate=True)
    return b


def _grid_mask_operands(cfg: SpatialConfig, state: SpatialState,
                        times: torch.Tensor, h: int, w: int, what: str):
    """The (res, res, res, E) cell grid, dims [x, y, t] (a cell's flat index
    is t + y res + x res^2), and the blur-folded hat weights (wt, wy, wx)."""
    if cfg.mask_dim != 3:
        raise ValueError(f"{what} expects a (t, y, x) cell grid")
    res, e = cfg.res, cfg.encoding_dim
    dev = state.mask.device
    cells = state.mask.reshape(res, res, res, e)
    bm = _blur_axis_matrix(cfg, dev)
    wt = grid_axis_weights(cfg, times.to(dev)) @ bm
    wy = grid_axis_weights(cfg, torch.linspace(-1.0, 1.0, h, device=dev)) @ bm
    wx = grid_axis_weights(cfg, torch.linspace(-1.0, 1.0, w, device=dev)) @ bm
    return cells, wt, wy, wx


def _contract_t(wt: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """sum_t wt[b, t] cells[x, y, t, E] -> (B, res, res, E)."""
    return torch.einsum("bt,xytE->bxyE", wt, cells)


def spatial_grid_mask(cfg: SpatialConfig, state: SpatialState,
                      times: torch.Tensor, h: int, w: int,
                      dtype=None) -> torch.Tensor:
    """:func:`spatial_point_mask` for the dense pose grid, gather-free: the
    (B H W, E) mask in pose-grid row-major order. ``dtype`` (bfloat16 when
    the INR runs bf16) applies to the last contraction only, whose output is
    the one large tensor built here."""
    blurred, wt, wy, wx = _grid_mask_operands(cfg, state, times, h, w,
                                              "spatial_grid_mask")
    g = torch.einsum("hy,bxyE->bxhE", wy, _contract_t(wt, blurred))
    if dtype is not None:
        g, wx = g.to(dtype), wx.to(dtype)
    m = torch.einsum("wx,bxhE->bhwE", wx, g)
    return m.reshape(-1, cfg.encoding_dim)


def spatial_grid_mask_split(cfg: SpatialConfig, state: SpatialState,
                            times: torch.Tensor, h: int, w: int, dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`spatial_grid_mask` split for the fused INR kernel's ``point``
    mode: ``(mc, me)`` with ``mc`` the coordinate channels as (d, B H W) and
    ``me`` the encoding channels as (B H W, E - d), in the encoding's own
    channel order."""
    blurred, wt, wy, wx = _grid_mask_operands(cfg, state, times, h, w,
                                              "spatial_grid_mask_split")
    e, d = cfg.encoding_dim, cfg.mask_dim
    g = torch.einsum("hy,bxyE->bxhE", wy, _contract_t(wt, blurred[..., d:]))
    wx_e = wx
    if dtype is not None:
        g, wx_e = g.to(dtype), wx.to(dtype)
    me = torch.einsum("wx,bxhE->bhwE", wx_e, g).reshape(-1, e - d)
    gc = torch.einsum("hy,bxyE->bxhE", wy, _contract_t(wt, blurred[..., :d]))
    mc = torch.einsum("wx,bxhE->Ebhw", wx, gc).reshape(d, -1)
    if dtype is not None:
        mc = mc.to(dtype)
    return mc, me


class SpatialSlabMask(NamedTuple):
    """The per-point spatial mask factored into row slabs, for the fused INR
    kernel's ``slab`` mode. Contracting the blurred cell grid over t and y
    leaves one small (res, E) slab per image row; the kernel rebuilds the
    mask of a tile of that row's points on chip from the slab and the
    constant x-axis hat weights, so the (n, E) mask is never built."""
    enc: torch.Tensor     # (B H, res, E - d) t/y-contracted encoding channels
    coord: torch.Tensor   # (B H, res, d) t/y-contracted coordinate channels
    wx: torch.Tensor      # (W, res) x-axis hat weights, blur folded in, f32


def spatial_grid_mask_slabs(cfg: SpatialConfig, state: SpatialState,
                            times: torch.Tensor, h: int, w: int,
                            dtype=None) -> SpatialSlabMask:
    """:func:`spatial_grid_mask` factored into per-row slabs. ``dtype``
    casts the slabs; the x contraction happens in the kernel."""
    blurred, wt, wy, wx = _grid_mask_operands(cfg, state, times, h, w,
                                              "spatial_grid_mask_slabs")
    res, e, d = cfg.res, cfg.encoding_dim, cfg.mask_dim
    g = _contract_t(wt, blurred)                    # (B, res, res, E), small
    enc = torch.einsum("hy,bxyE->bhxE", wy, g[..., d:])
    coord = torch.einsum("hy,bxyE->bhxE", wy, g[..., :d])
    if dtype is not None:
        enc, coord = enc.to(dtype), coord.to(dtype)
    return SpatialSlabMask(enc=enc.reshape(-1, res, e - d).contiguous(),
                           coord=coord.reshape(-1, res, d).contiguous(),
                           wx=wx.contiguous())


def spatial_grid_update(cfg: SpatialConfig, state: SpatialState,
                        point_loss: torch.Tensor, times: torch.Tensor,
                        h: int, w: int, group=None) -> SpatialState:
    """:func:`spatial_update` for the dense pose grid, scatter-free: the
    cell accumulation of the per-point losses is the adjoint of the
    separable interpolation (three small contractions), the visit counter
    an outer product of the per-axis weight sums; both summed over the
    shards of ``group``'s batch, with one."""
    dev = state.mask.device
    b = times.shape[0]
    loss = point_loss.detach().reshape(b, h, w).to(dev)
    wt = grid_axis_weights(cfg, times.to(dev)).to(loss.dtype)
    wy = grid_axis_weights(cfg, torch.linspace(-1.0, 1.0, h, device=dev)
                           ).to(loss.dtype)
    wx = grid_axis_weights(cfg, torch.linspace(-1.0, 1.0, w, device=dev)
                           ).to(loss.dtype)
    l1 = torch.einsum("bhw,hy->bwy", loss, wy)
    l2 = torch.einsum("bwy,wx->bxy", l1, wx)
    buf_add = torch.einsum("bxy,bt->xyt", l2, wt).reshape(-1)
    cnt_add = torch.einsum("x,y,t->xyt", wx.sum(0), wy.sum(0),
                           wt.sum(0)).reshape(-1)
    buf_add, cnt_add = _group_sum(buf_add, group), _group_sum(cnt_add, group)
    state = _stash_ramp(cfg, state, state.log_buffer + buf_add,
                        state.log_counter + cnt_add)
    if state.iteration % cfg.block_iterations == 0:
        return spatial_progress(cfg, state)
    return state


def spatial_progress(cfg: SpatialConfig, state: SpatialState) -> SpatialState:
    """The per-cell gate, the block advance and the buffer reset; runs every
    ``block_iterations`` steps."""
    empty = state.log_counter == 0
    counter = torch.where(empty, 1.0, state.log_counter)
    cell_loss = state.log_buffer / counter
    # fill unvisited cells from their neighbours, then blur
    neigh = _box_blur_cells(cfg, torch.where(empty, 0.0, cell_loss))
    neigh_cnt = _box_blur_cells(cfg, torch.where(empty, 0.0, 1.0))
    filled = torch.where(empty, neigh / torch.clamp(neigh_cnt, min=1e-12),
                         cell_loss)
    smoothed = _box_blur_cells(cfg, filled)
    in_progress = state.in_progress & (smoothed > cfg.epsilon)

    mask = state.mask.clone()
    win = mask[:, state.cur_block:state.next_block]
    win.copy_(torch.where(in_progress[:, None], 1.0, win))
    return SpatialState(
        mask=mask, in_progress=in_progress,
        log_buffer=torch.zeros_like(state.log_buffer),
        log_counter=torch.zeros_like(state.log_counter),
        iteration=0, cur_block=state.next_block,
        next_block=_next_block(state.next_block, cfg.block_size,
                               cfg.encoding_dim))


def spatial_update(cfg: SpatialConfig, state: SpatialState,
                   point_loss: torch.Tensor, inds: torch.Tensor,
                   alphas: torch.Tensor, group=None) -> SpatialState:
    """Stash, then the progress step when its turn has come."""
    state = spatial_stash(cfg, state, point_loss, inds, alphas, group)
    if state.iteration % cfg.block_iterations == 0:
        return spatial_progress(cfg, state)
    return state


# ===========================================================================
# Adaptive controller (a block unlocks when the loss curve flattens)
# ===========================================================================

@dataclass(frozen=True)
class AdaptiveConfig:
    encoding_dim: int
    block_size: int
    num_blocks: int
    block_iterations: int
    max_iteration: int
    epsilon: float = 1e-5
    grad_epsilon: float = 5e-4

    # status codes
    WAITING = 0
    STABILIZING = 1
    INCREASING = 2

    @classmethod
    def create(cls, spec: INRSpec,
               max_iteration: int = 1000) -> "AdaptiveConfig":
        e = spec.encoding_dim
        block_size = spec.domain_dim * 2
        num_blocks = (e - block_size) // block_size
        return cls(encoding_dim=e, block_size=block_size,
                   num_blocks=num_blocks,
                   block_iterations=max(
                       3 * max_iteration // (4 * num_blocks), 2),
                   max_iteration=max_iteration)


class AdaptiveState(NamedTuple):
    mask: torch.Tensor          # (encoding_dim,)
    iteration: int              # host counter
    cur_block: torch.Tensor     # i32
    next_block: torch.Tensor    # i32
    status: torch.Tensor        # i32 (waiting / stabilizing / increasing)
    in_iteration: torch.Tensor  # i32
    log: torch.Tensor           # (max_iteration,) loss history
    best_score: torch.Tensor    # f32


def adaptive_init(cfg: AdaptiveConfig, device="cpu") -> AdaptiveState:
    return AdaptiveState(
        mask=_first_block_mask((), cfg.block_size, cfg.encoding_dim, device),
        iteration=0,
        cur_block=_i32(cfg.block_size, device),
        next_block=_i32(2 * cfg.block_size, device),
        status=_i32(cfg.STABILIZING, device),
        in_iteration=_i32(0, device),
        log=torch.zeros(cfg.max_iteration, device=device),
        best_score=torch.tensor(1e4, dtype=torch.float32, device=device))


def _loss_slope(cfg: AdaptiveConfig, log: torch.Tensor,
                end: int) -> torch.Tensor:
    """Least-squares slope through the origin of log(loss) over the trailing
    half-block window. The window's start is clamped so that it fits the
    history, as ``jax.lax.dynamic_slice`` clamps it."""
    win = cfg.block_iterations // 2
    start = min(max(end - win, 0), log.shape[0] - win)
    y = torch.log(torch.clamp(log[start:start + win], min=1e-12))
    y = y - y[0]
    t = torch.arange(win, dtype=torch.float32, device=log.device)
    return (t * y).sum() / torch.clamp((t * t).sum(), min=1e-12)


def adaptive_update(cfg: AdaptiveConfig, state: AdaptiveState,
                    loss: torch.Tensor) -> AdaptiveState:
    """Log the loss, move the status machine, advance or ramp the block."""
    loss = loss.detach().to(state.log.dtype)
    best = torch.minimum(state.best_score, loss)
    last = cfg.max_iteration - 1
    log = state.log.clone()
    log[min(max(state.iteration, 0), last)] = loss
    it = state.iteration + 1
    done = state.cur_block >= cfg.encoding_dim
    bi = cfg.block_iterations

    inc_full = (state.status == cfg.INCREASING) & (state.in_iteration == bi)
    stab_full = (state.status == cfg.STABILIZING) & (state.in_iteration == bi)
    stab_cont = (state.status == cfg.STABILIZING) & (state.in_iteration < bi)
    low_loss = log[min(max(it - 1, 0), last)] < cfg.epsilon
    slope = _loss_slope(cfg, log, it)
    trigger = ((state.status == cfg.WAITING) & ~low_loss
               & (slope > -cfg.grad_epsilon))

    status = state.status
    status = torch.where(inc_full, cfg.STABILIZING, status)
    status = torch.where(stab_full, cfg.WAITING, status)
    status = torch.where(trigger, cfg.INCREASING, status)

    in_it = state.in_iteration
    in_it = torch.where(inc_full | stab_full, 0, in_it)
    in_it = torch.where(stab_cont & ~stab_full, state.in_iteration + 1, in_it)

    # the block advances when an increasing phase completes
    idx = torch.arange(cfg.encoding_dim, device=state.mask.device)
    in_window = (idx >= state.cur_block) & (idx < state.next_block)
    advance = inc_full & ~done
    mask = torch.where(advance & in_window, 1.0, state.mask)
    nb = _next_block(state.next_block, cfg.block_size, cfg.encoding_dim)
    cur = torch.where(advance, state.next_block, state.cur_block)
    nxt = torch.where(advance, nb, state.next_block)

    # the ramp while increasing
    ramping = (status == cfg.INCREASING) & ~done
    alpha = (in_it % bi).to(mask.dtype) / bi
    in_window_new = (idx >= cur) & (idx < nxt)
    mask = torch.where(ramping & in_window_new, torch.maximum(mask, alpha),
                       mask)
    in_it = torch.where(ramping, in_it + 1, in_it)

    return AdaptiveState(mask=mask, iteration=it,
                         cur_block=cur.to(torch.int32),
                         next_block=nxt.to(torch.int32),
                         status=status.to(torch.int32),
                         in_iteration=in_it.to(torch.int32),
                         log=log, best_score=best)


# ===========================================================================
# Fixed spatial controller (a per-sample mask over a fixed input grid)
# ===========================================================================

@dataclass(frozen=True)
class FixedSpatialConfig:
    encoding_dim: int
    domain_dim: int            # 1 or 2
    num_samples: int           # size of the fixed training grid
    block_size: int
    num_blocks: int
    block_iterations: int
    progress_iterations: int
    buffer_size: int
    epsilon: float

    @classmethod
    def create(cls, spec: INRSpec, num_samples: int,
               max_iteration: int = 1000, epsilon: float = 1e-3,
               num_blocks: Optional[int] = None) -> "FixedSpatialConfig":
        e = spec.encoding_dim
        if num_blocks is None:
            block_size = spec.domain_dim * 2
            num_blocks = (e - block_size) // block_size
        else:
            block_size = e // num_blocks
        bi = max(3 * max_iteration // (4 * num_blocks), 2)
        return cls(encoding_dim=e, domain_dim=spec.domain_dim,
                   num_samples=num_samples, block_size=block_size,
                   num_blocks=num_blocks, block_iterations=bi,
                   progress_iterations=bi * num_blocks,
                   buffer_size=max(bi // 2, 1), epsilon=epsilon)


class FixedSpatialState(NamedTuple):
    mask: torch.Tensor          # (num_samples, encoding_dim)
    in_progress: torch.Tensor   # (num_samples,) bool
    log_buffer: torch.Tensor    # (buffer_size, num_samples) bool ring
    iteration: int              # host counter
    cur_block: torch.Tensor     # i32
    next_block: torch.Tensor    # i32


def fixed_spatial_init(cfg: FixedSpatialConfig,
                       device="cpu") -> FixedSpatialState:
    return FixedSpatialState(
        mask=_first_block_mask((cfg.num_samples,), cfg.block_size,
                               cfg.encoding_dim, device),
        in_progress=torch.ones(cfg.num_samples, dtype=torch.bool,
                               device=device),
        log_buffer=torch.ones((cfg.buffer_size, cfg.num_samples),
                              dtype=torch.bool, device=device),
        iteration=0,
        cur_block=_i32(cfg.block_size, device),
        next_block=_i32(2 * cfg.block_size, device))


def _blur_1d2d(cfg: FixedSpatialConfig, v: torch.Tensor) -> torch.Tensor:
    """3-tap box blur over the fixed sample grid, replicate padding.
    v: (num_samples, ...)."""
    if cfg.domain_dim == 1:
        pad = torch.cat([v[:1], v, v[-1:]], 0)
        return (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0
    if cfg.domain_dim == 2:
        side = int(math.isqrt(cfg.num_samples))
        g = v.reshape(side, side, *v.shape[1:])
        for ax in (0, 1):
            p = _pad_edge(g, ax, 1)
            g = (p.narrow(ax, 0, side) + p.narrow(ax, 1, side)
                 + p.narrow(ax, 2, side)) / 3.0
        return g.reshape(v.shape)
    return v


def fixed_spatial_mask(cfg: FixedSpatialConfig,
                       state: FixedSpatialState) -> torch.Tensor:
    """The blurred per-sample mask of the whole fixed grid."""
    return _blur_1d2d(cfg, state.mask)


def fixed_spatial_update(cfg: FixedSpatialConfig, state: FixedSpatialState,
                         sample_loss: torch.Tensor) -> FixedSpatialState:
    """One step. sample_loss: (num_samples,) loss per grid point. A sample
    leaves progress when none of its recent losses exceeded ``epsilon``."""
    blurred = _blur_1d2d(cfg, sample_loss.detach())
    log_buffer = state.log_buffer.clone()
    log_buffer[state.iteration % cfg.buffer_size] = blurred > cfg.epsilon
    in_progress = state.in_progress & log_buffer.any(dim=0)
    it = state.iteration + 1

    idx = torch.arange(cfg.encoding_dim, device=state.mask.device)[None, :]
    in_window = (idx >= state.cur_block) & (idx < state.next_block)
    boundary = it % cfg.block_iterations == 0
    active = in_progress[:, None] & in_window
    frozen = ~in_progress.any()
    if it > cfg.progress_iterations:
        frozen = torch.ones_like(frozen)

    if boundary:
        mask_new = torch.where(active, 1.0, state.mask)
        cur_new = state.next_block
        next_new = _next_block(state.next_block, cfg.block_size,
                               cfg.encoding_dim)
    else:
        alpha = _ramp_alpha(it, cfg.block_iterations)
        mask_new = torch.where(active, torch.clamp(state.mask, min=alpha),
                               state.mask)
        cur_new, next_new = state.cur_block, state.next_block
    return FixedSpatialState(
        mask=torch.where(frozen, state.mask, mask_new),
        in_progress=in_progress, log_buffer=log_buffer, iteration=it,
        cur_block=torch.where(frozen, state.cur_block,
                              cur_new).to(torch.int32),
        next_block=torch.where(frozen, state.next_block,
                               next_new).to(torch.int32))


# ===========================================================================
# States as checkpoint trees
# ===========================================================================

STATE_TYPES = {"linear": LinearState, "spatial": SpatialState,
               "adaptive": AdaptiveState, "fixed_spatial": FixedSpatialState}
# The fields that are Python ints on the host; every other field is a tensor
HOST_FIELDS = {"linear": ("iteration",),
               "spatial": ("iteration", "cur_block", "next_block"),
               "adaptive": ("iteration",),
               "fixed_spatial": ("iteration",)}


def state_kind(state) -> str:
    for kind, cls in STATE_TYPES.items():
        if isinstance(state, cls):
            return kind
    raise TypeError(f"not a controller state: {type(state).__name__}")


def state_to_dict(state) -> dict:
    """A state as a dict of tensors and ints with its ``kind``: what a
    checkpoint holds."""
    return {"kind": state_kind(state), **state._asdict()}


def state_from_dict(tree: dict, device="cpu"):
    """The state of ``state_to_dict``'s dict, its tensors on ``device`` and
    its host counters as ints."""
    kind = tree["kind"]
    cls = STATE_TYPES[kind]
    return cls(**{name: (int(tree[name]) if name in HOST_FIELDS[kind]
                         else torch.as_tensor(tree[name]).to(device))
                  for name in cls._fields})
