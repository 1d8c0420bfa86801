"""Forward (softmax) splatting in plain PyTorch (NHWC).

Counterpart of ``sin_inn_tpu/ops/splat.py`` (``splat_scatter``,
``softsplat``, ``softmax_coverage_via``, ``softsplat_with_coverage``,
``splat_windowed``, ``softsplat_windowed_with_coverage``). The scatter is
``index_add_`` over the four bilinear taps; a tap outside the image is
dropped, as the reference drops it. With a rule that keeps or drops each tap
pair it is also the plain version of the region splat kernels
(``ops/cuda/splat.py``) and the windowed form ``splat_windowed``, whose
window is anchored at the source pixel's row chunk. That form was dense
matmuls on the TPU (XLA, no kernel), so here it is the scatter with its
rule, differentiated by autograd.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# keep(r, k) -> bool (N, H, W): whether the tap (r, k) of each source pixel
# (r, k: (N, H, W) int64, in the image) is kept
TapRule = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _hat(d: torch.Tensor) -> torch.Tensor:
    """max(1 - |d|, 0). |d| is written as a select so that its derivative at
    d = 0 is +1, as JAX's ``abs`` has it (``torch.abs`` gives 0 there): a
    target on a pixel centre then has the same flow gradient, the right
    derivative, in both packages."""
    return torch.clamp(1.0 - torch.where(d >= 0, d, -d), min=0.0)


def splat_scatter(values: torch.Tensor, flow: torch.Tensor,
                  keep: Optional[TapRule] = None) -> torch.Tensor:
    """Bilinear scatter-add of ``values`` (N, H, W, C) along ``flow``
    (N, H, W, 2) pixel displacements (dx, dy). Returns (N, H, W, C).

    Source pixel s adds value hat(ty - r) hat(tx - k) to each of the four
    taps (r, k) of its target t = s + flow(s) that lies in the image and,
    when ``keep`` is given, that ``keep(r, k)`` keeps: the window rules of
    the region splats and of :func:`splat_windowed`."""
    n, h, w, c = values.shape
    dev = values.device
    ys = torch.arange(h, dtype=values.dtype, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=values.dtype, device=dev)[None, None, :]

    def taps(t, size):
        """[(weight, index)] of the floor and ceil taps; a tap outside the
        image has weight 0 and index 0."""
        t0 = torch.floor(t)
        out = []
        for tap in (t0, t0 + 1.0):
            ok = (tap >= 0) & (tap <= size - 1)
            out.append((torch.where(ok, _hat(t - tap), 0.0),
                        torch.where(ok, tap, 0.0).long()))
        return out

    rows = taps(ys + flow[..., 1], h)
    cols = taps(xs + flow[..., 0], w)
    base = torch.arange(n, device=dev)[:, None, None] * (h * w)
    out = torch.zeros((n * h * w, c), dtype=values.dtype, device=dev)
    for wy, ri in rows:
        vy = values * wy[..., None]
        for wx, ki in cols:
            if keep is not None:
                wx = torch.where(keep(ri, ki), wx, 0.0)
            out.index_add_(0, (base + ri * w + ki).reshape(-1),
                           (vy * wx[..., None]).reshape(-1, c))
    return out.reshape(n, h, w, c)


def splat_windowed(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
                   chunk: int = 8, max_dx: Optional[int] = None,
                   col_chunk: int = 128) -> torch.Tensor:
    """The reference's windowed splat (``splat_windowed`` with its fused
    backward), as the scatter with its rule: a tap row r is kept iff it lies
    in [s - max_dy, s - max_dy + 2 max_dy + chunk + 1) with s = chunk
    floor(y / chunk) the source pixel's row chunk; with ``max_dx`` a tap
    column k also iff it lies in [b - max_dx, b - max_dx + 2 max_dx + cw +
    1), b = cw floor(x / cw), cw = min(col_chunk, W). Exact for |flow_y| <=
    max_dy - 1 (and |flow_x| <= max_dx - 1); farther taps are dropped."""
    n, h, w, _ = values.shape
    dev = values.device
    r_lo = (torch.arange(h, device=dev) // chunk * chunk
            - max_dy)[None, :, None]
    r_span = 2 * max_dy + chunk + 1
    if max_dx is None:
        keep = lambda r, k: (r >= r_lo) & (r < r_lo + r_span)
    else:
        cw = min(col_chunk, w)
        k_lo = (torch.arange(w, device=dev) // cw * cw - max_dx)[None, None, :]
        k_span = 2 * max_dx + cw + 1
        keep = lambda r, k: ((r >= r_lo) & (r < r_lo + r_span)
                             & (k >= k_lo) & (k < k_lo + k_span))
    return splat_scatter(values, flow, keep)


def _normalize(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den != 0, else 0."""
    return torch.where(den != 0.0,
                       num / torch.where(den == 0.0, 1.0, den), 0.0)


def softsplat(inp: torch.Tensor, flow: torch.Tensor,
              metric: Optional[torch.Tensor],
              mode: str = "softmax") -> torch.Tensor:
    """The reference's ``FunctionSoftsplat``, NHWC. inp: (N, H, W, C);
    flow: (N, H, W, 2); metric: (N, H, W, 1) or None."""
    if mode not in ("summation", "average", "linear", "softmax"):
        raise ValueError(mode)
    if mode == "summation":
        return splat_scatter(inp, flow)
    if mode == "average":
        ones = torch.ones(inp.shape[:3] + (1,), dtype=inp.dtype,
                          device=inp.device)
        cat = torch.cat([inp, ones], dim=-1)
    elif mode == "linear":
        cat = torch.cat([inp * metric, metric], dim=-1)
    else:
        e = torch.exp(metric)
        cat = torch.cat([inp * e, e], dim=-1)
    out = splat_scatter(cat, flow)
    return _normalize(out[..., :-1], out[..., -1:])


def softmax_coverage_via(splat_fn, inp: torch.Tensor, flow: torch.Tensor,
                         metric: torch.Tensor):
    """Softmax splat and coverage in one splat pass over any splat
    function: packs [inp * exp(metric), exp(metric), ones]. Returns
    (softmax_out (N, H, W, C), coverage (N, H, W, 1)); the coverage carries
    no gradient."""
    e = torch.exp(metric)
    ones = torch.ones(inp.shape[:3] + (1,), dtype=inp.dtype,
                      device=inp.device)
    out = splat_fn(torch.cat([inp * e, e, ones], dim=-1), flow)
    soft = _normalize(out[..., :-2], out[..., -2:-1])
    return soft, out[..., -1:].detach()


def softsplat_with_coverage(inp: torch.Tensor, flow: torch.Tensor,
                            metric: torch.Tensor):
    """Softmax splat and plain coverage map along one flow, exact."""
    return softmax_coverage_via(splat_scatter, inp, flow, metric)


def softsplat_windowed_with_coverage(inp: torch.Tensor, flow: torch.Tensor,
                                     metric: torch.Tensor, max_dy: int,
                                     chunk: int = 16,
                                     max_dx: Optional[int] = None,
                                     col_chunk: int = 128):
    """Softmax splat and coverage on :func:`splat_windowed`."""
    return softmax_coverage_via(
        lambda cat, fl: splat_windowed(cat, fl, max_dy, chunk, max_dx,
                                       col_chunk),
        inp, flow, metric)
