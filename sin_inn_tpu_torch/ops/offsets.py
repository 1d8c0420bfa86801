"""Per-tile window offsets of the local-window kernels, in plain PyTorch.

Counterpart of ``sin_inn_tpu/ops/pallas/offsets.py`` (``TileOffsets``,
``_tile_counts``, ``_source_tile_stats``, ``_masked_max_dev``,
``tile_flow_offsets``, ``tile_deviation_fine``), which the reference
computes as plain XLA outside any kernel. Given a flow (N, H, W, 2) of
(dx, dy) it computes, per image and per 128 x 128 tile:

* ``off_src``: the rounded mean flow over the tile's own pixels. The gather
  (K6 local: the warp, and the splat's backward) reads taps at s + f(s), so
  its window shifts by this offset of the pixel's tile;
* ``off_out``: the rounded mean flow over the pixels whose taps land in the
  tile. The splat (K5 local) gathers the contributors of an output tile, so
  its window shifts by minus this offset;
* ``dev_src``, ``dev_out``: the largest per-axis |f - off| under each
  criterion, the quantity the train loop monitors, since a tap whose
  deviation exceeds the local half-width is dropped.

The offsets keep the TPU's quantization (rows to multiples of 8, columns to
multiples of 128, rounding half to even as ``jnp.rint``) and its caps: they
decide which taps survive, so they are part of the function. They stay fp32
tensors on the flow's device, read by the kernels through a pointer: nothing
here reads a value back to the host. The contributor sums are masked sums
over a one-hot tile index (no atomics, no matmul), so they are deterministic
and do not depend on the TF32 flags.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class TileOffsets(NamedTuple):
    """``off_src``, ``off_out``: (N, HB, WB, 2) fp32, integer-valued, in the
    flow's (ox, oy) order. ``dev_src``, ``dev_out``: (2,) fp32, the largest
    |f - off| per axis over the live pixels."""

    off_src: torch.Tensor
    off_out: torch.Tensor
    dev_src: torch.Tensor
    dev_out: torch.Tensor


def _tile_counts(dim: int, tile: int, nblk: int,
                 device=None) -> torch.Tensor:
    """The in-image pixel count of each tile along one axis, built on the
    device (an item assignment would copy from the host and wait)."""
    start = torch.arange(nblk, device=device) * tile
    return torch.clamp(dim - start, max=tile).float()


def _source_tile_stats(flow: torch.Tensor, tile_b: int, tile_cb: int):
    """(blocks, validb, mean, hb, wb): ``flow`` padded to whole tiles as
    blocks (N, HB, tile_b, WB, tile_cb, 2), the in-image mask broadcastable
    to them, and each tile's mean over its in-image pixels. Shared by
    :func:`tile_flow_offsets` and :func:`tile_deviation_fine`, so that the
    probe's criterion is the offsets' own."""
    n, h, w, _ = flow.shape
    hb = -(-h // tile_b)
    wb = -(-w // tile_cb)
    fp = F.pad(flow, (0, 0, 0, wb * tile_cb - w, 0, hb * tile_b - h))
    blocks = fp.reshape(n, hb, tile_b, wb, tile_cb, 2)
    dev = flow.device
    cnt = (_tile_counts(h, tile_b, hb, dev)[:, None]
           * _tile_counts(w, tile_cb, wb, dev)[None, :])
    valid = ((torch.arange(hb * tile_b, device=dev) < h)[:, None]
             & (torch.arange(wb * tile_cb, device=dev) < w)[None, :]).float()
    validb = valid.reshape(1, hb, tile_b, wb, tile_cb, 1)
    mean = blocks.sum(dim=(2, 4)) / cnt[None, :, :, None]
    return blocks, validb, mean, hb, wb


def _masked_max_dev(blocks: torch.Tensor, ref: torch.Tensor,
                    validb: torch.Tensor) -> torch.Tensor:
    """The largest per-axis |blocks - ref(tile)| over valid pixels, (2,)."""
    dev = (blocks - ref[:, :, None, :, None, :]).abs() * validb
    return dev.amax(dim=(0, 1, 2, 3, 4))


def tile_flow_offsets(flow: torch.Tensor, tile_b: int, tile_cb: int,
                      cap_y: int, cap_x: int, quant_y: int = 8,
                      quant_x: int = 128) -> TileOffsets:
    """The window offsets of every tile of ``flow`` (N, H, W, 2) and the
    deviation monitors. tile_b, tile_cb: the kernels' tile rows and columns;
    cap_y, cap_x: the offsets' clip (cap_x = 0 turns the column offsets
    off). Row offsets are multiples of ``quant_y``, column offsets of
    ``quant_x``; the deviations are measured against the offsets used."""
    if cap_x % quant_x:
        raise ValueError(f"cap_x {cap_x} is not a multiple of {quant_x}")
    with torch.no_grad():
        flow = flow.detach().float()
        n, h, w, _ = flow.shape
        blocks, validb, mean_src, hb, wb = _source_tile_stats(flow, tile_b,
                                                              tile_cb)

        def round_clip(mean):
            return torch.stack([
                torch.clamp(torch.round(mean[..., 0] / quant_x) * quant_x,
                            -float(cap_x), float(cap_x)),
                torch.clamp(torch.round(mean[..., 1] / quant_y) * quant_y,
                            -float(cap_y), float(cap_y))], dim=-1)

        off_src = round_clip(mean_src)
        dev_src = _masked_max_dev(blocks, off_src, validb)

        # the contributors of each output tile: every pixel binned by the
        # tile its target lands in, if any of its taps can land in the image
        dev = flow.device
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        oy = ys + flow[..., 1]
        ox = xs + flow[..., 0]
        live = ((oy > -1.0) & (oy < float(h))
                & (ox > -1.0) & (ox < float(w))).float()
        ty = torch.clamp(torch.floor((oy + 0.5) / tile_b), 0, hb - 1)
        tx = torch.clamp(torch.floor((ox + 0.5) / tile_cb), 0, wb - 1)
        onehot = ((ty * wb + tx)[..., None]
                  == torch.arange(hb * wb, dtype=torch.float32, device=dev))
        payload = torch.cat([flow, torch.ones_like(flow[..., :1])], -1)
        payload = payload * live[..., None]
        sums = (onehot[..., None] * payload[..., None, :]).sum(dim=(1, 2))
        sums = sums.reshape(n, hb, wb, 3)
        count = sums[..., 2:3]
        mean_out = torch.where(count > 0.0,
                               sums[..., :2] / torch.clamp(count, min=1.0),
                               0.0)
        off_out = round_clip(mean_out)

        # per pixel, |f - off_out| of the tiles of its floor and floor + 1
        # taps on each axis, so that a tap straddling into a neighbour with
        # another offset is monitored too
        nidx = torch.arange(n, device=dev)[:, None, None]
        devs = []
        for dy_tap in (0.0, 1.0):
            tyc = torch.clamp(torch.floor((torch.floor(oy) + dy_tap) / tile_b),
                              0, hb - 1).long()
            for dx_tap in (0.0, 1.0):
                txc = torch.clamp(
                    torch.floor((torch.floor(ox) + dx_tap) / tile_cb),
                    0, wb - 1).long()
                per_px = off_out[nidx, tyc, txc]
                devs.append(((flow - per_px).abs()
                             * live[..., None]).amax(dim=(0, 1, 2)))
        dev_out = torch.stack(devs).amax(dim=0)
    return TileOffsets(off_src=off_src, off_out=off_out, dev_src=dev_src,
                       dev_out=dev_out)


def tile_deviation_fine(flow: torch.Tensor, tile_b: int,
                        tile_cb: int) -> torch.Tensor:
    """The largest per-axis |flow - the tile's unquantized mean| (source-tile
    criterion): the GT probe's estimate of the deviation training flows will
    show. Returns (2,) [dev_x, dev_y]."""
    with torch.no_grad():
        blocks, validb, mean, _, _ = _source_tile_stats(
            flow.detach().float(), tile_b, tile_cb)
        return _masked_max_dev(blocks, mean, validb)
