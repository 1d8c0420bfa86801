"""Forward (softmax) splatting in plain PyTorch (NHWC).

Counterpart of ``sin_inn_tpu/ops/splat.py`` (``splat_scatter``,
``softsplat``, ``softmax_coverage_via``, ``softsplat_with_coverage``). The
scatter is ``index_add_`` over the four bilinear taps; a tap outside the
image is dropped, as the reference drops it. With a window it is also the
plain version of the region splat kernel (``ops/cuda/splat.py``). The
windowed XLA forms (``splat_windowed``, ``softsplat_windowed_with_coverage``)
are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def splat_scatter(values: torch.Tensor, flow: torch.Tensor,
                  window: Optional[Tuple[int, int, int, int, int]] = None
                  ) -> torch.Tensor:
    """Bilinear scatter-add of ``values`` (N, H, W, C) along ``flow``
    (N, H, W, 2) pixel displacements (dx, dy). Returns (N, H, W, C).

    Source pixel s adds value hat(ty - r) hat(tx - k) to each of the four
    taps (r, k) of its target t = s + flow(s) that lies in the image.
    ``window = (tile, dy, dx, sh, sw)`` also drops a tap unless s lies in
    rows [tile floor(r / tile) - dy, ... + sh) and columns
    [tile floor(k / tile) - dx, ... + sw): the region splat's rule
    (``ops/cuda/splat.py``)."""
    n, h, w, c = values.shape
    dev = values.device
    ys = torch.arange(h, dtype=values.dtype, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=values.dtype, device=dev)[None, None, :]

    def taps(t, size, s, d, span):
        """[(weight, index)] of the floor and ceil taps; a dropped tap has
        weight 0 and index 0."""
        t0 = torch.floor(t)
        out = []
        for tap in (t0, t0 + 1.0):
            ok = (tap >= 0) & (tap <= size - 1)
            idx = torch.where(ok, tap, 0.0).long()
            if window is not None:
                lo = idx // window[0] * window[0] - d
                ok = ok & (s >= lo) & (s < lo + span)
            out.append((torch.where(ok, _hat(t - tap), 0.0), idx))
        return out

    _, dy, dx, sh, sw = window or (None, 0, 0, 0, 0)
    rows = taps(ys + flow[..., 1], h, ys, dy, sh)
    cols = taps(xs + flow[..., 0], w, xs, dx, sw)
    base = torch.arange(n, device=dev)[:, None, None] * (h * w)
    out = torch.zeros((n * h * w, c), dtype=values.dtype, device=dev)
    for wy, ri in rows:
        vy = values * wy[..., None]
        for wx, ki in cols:
            out.index_add_(0, (base + ri * w + ki).reshape(-1),
                           (vy * wx[..., None]).reshape(-1, c))
    return out.reshape(n, h, w, c)


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
