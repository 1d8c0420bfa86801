"""Plain reference of the flow INR: its query, its training loss and step,
and the Wang occlusion mask.

The published method (paramhanji/sin-inn ``video-interpolation``): an MLP
over an RBF encoding of (t, y, x) in [-1, 1]^3, exp(-sigma^2 |x - c|^2)
with |x - c|^2 = |x|^2 + |c|^2 - 2 x.c, gives both flows of a pair,
scaled by ``W / 5``. The loss warps each frame toward the other (bilinear,
zeros outside, coordinates normalised by size - 1 and sampled without
aligned corners, as ``Resample2d``), softmax-splats each frame along the
other flow with the metric -20 |photometric error| (four bilinear taps,
those outside the frame dropped), masks the pixels that the splat of ones
covers no more than ``occl_thresh`` (Wang), and sums the masked L1, the
census loss (7 x 7 soft ternary, the border left out) and the edge-aware
first-order smoothness. LAMB (optax's arithmetic) takes the step.

The splat and the warp here are exact: no window drops a tap. The
program's windows and their offsets are its own business: where its flows
stay inside them it computes the same function, and where a window drops
a tap the comparison sees it. Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference.precision import matmul

# the MLP's layers by name (harness/weights.py)
def _layers(p: Dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    n = sum(1 for k in p if k.startswith("mlp") and k.endswith(".w"))
    return [(p[f"mlp{i}.w"], p[f"mlp{i}.b"]) for i in range(n)]


def clip_times(frames: int) -> np.ndarray:
    """Frame k's time: k spread evenly over [-1, 1], float32."""
    return np.linspace(-1.0, 1.0, frames).astype(np.float32)


def pair_batch(video: torch.Tensor, pairs: Sequence[int]) -> Dict:
    """The batch of frame pairs (k, k + 1) for k in ``pairs``, from the
    clip (N, H, W, 3): both frames, the first frame's time, and the flow
    scale W / 5 of the published net."""
    idx = torch.as_tensor(list(pairs), device=video.device)
    times = torch.from_numpy(clip_times(video.shape[0])).to(video.device)
    return {"frame1": video[idx], "frame2": video[idx + 1],
            "times": times[idx].to(video.dtype),
            "scale": video.shape[2] / 5.0}


def pose_grid(times: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,) -> (B * H * W, 3) of (t, y, x), in the dtype of ``times``."""
    dev, dt = times.device, times.dtype
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=dev,
                                           dtype=dt),
                            torch.linspace(-1.0, 1.0, w, device=dev,
                                           dtype=dt),
                            indexing="ij")
    b = times.shape[0]
    t = times[:, None, None].expand(b, h, w)
    return torch.stack([t, gy[None].expand(b, h, w),
                        gx[None].expand(b, h, w)], dim=-1).reshape(-1, 3)


def rbf(x: torch.Tensor, centres: torch.Tensor,
        sigma: torch.Tensor) -> torch.Tensor:
    """The encoding; x.c as a float32 multiply-add over the coordinates."""
    xc = x[:, 0:1] * centres[:, 0]
    for k in range(1, x.shape[1]):
        xc = xc + x[:, k:k + 1] * centres[:, k]
    d2 = (x * x).sum(-1, keepdim=True) + (centres * centres).sum(-1) - 2 * xc
    return torch.exp(-torch.clamp(d2, min=0.0) * sigma ** 2)


def query(p: Dict, times: torch.Tensor, h: int, w: int, scale: float,
          prec: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(flow12, flow21), each (B, H, W, 2) of (dx, dy) pixels."""
    x = rbf(pose_grid(times, h, w), p["centres"], p["sigma"])
    layers = _layers(p)
    for i, (wt, b) in enumerate(layers):
        x = matmul(x, wt, prec) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    f = x.reshape(times.shape[0], h, w, 4) * scale
    return f[..., :2], f[..., 2:]


# ---------------------------------------------------------------------------
# Warp, splat, occlusion
# ---------------------------------------------------------------------------

def _pixels(n: int, h: int, w: int, like: torch.Tensor):
    ys = torch.arange(h, dtype=like.dtype, device=like.device)
    xs = torch.arange(w, dtype=like.dtype, device=like.device)
    return ys[None, :, None].expand(n, h, w), xs[None, None, :].expand(n, h, w)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + flow(p)), bilinear, each tap outside the frame
    contributing zero; the sample point (p + f) size / (size - 1) - 0.5."""
    n, h, w, c = img.shape
    ys, xs = _pixels(n, h, w, img)
    px = (xs + flow[..., 0]) * (w / (w - 1)) - 0.5
    py = (ys + flow[..., 1]) * (h / (h - 1)) - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    flat = img.reshape(n, h * w, c)
    out = 0.0
    for xi, yi, wt in ((x0, y0, (1 - fx) * (1 - fy)), (x0 + 1, y0, fx * (1 - fy)),
                       (x0, y0 + 1, (1 - fx) * fy), (x0 + 1, y0 + 1, fx * fy)):
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        val = torch.gather(flat, 1, idx.reshape(n, -1, 1).expand(-1, -1, c))
        out = out + val.reshape(n, h, w, c) * (wt * ok)[..., None]
    return out


def splat(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-add of ``values`` to s + flow(s); taps outside the
    frame are dropped."""
    n, h, w, c = values.shape
    ys, xs = _pixels(n, h, w, values)
    ty, tx = ys + flow[..., 1], xs + flow[..., 0]
    y0, x0 = torch.floor(ty), torch.floor(tx)
    base = (torch.arange(n, device=values.device) * (h * w))[:, None, None]
    out = torch.zeros((n * h * w, c), dtype=values.dtype, device=values.device)
    # the weights of the floor and ceil taps, 1 - a and a for a = t - floor
    # t, as the published splat computes them (so their derivative is the
    # right derivative also where t lands on a pixel centre)
    ay, ax = ty - y0, tx - x0
    for ri, wy in ((y0, 1 - ay), (y0 + 1, ay)):
        for ki, wx in ((x0, 1 - ax), (x0 + 1, ax)):
            ok = (ri >= 0) & (ri <= h - 1) & (ki >= 0) & (ki <= w - 1)
            idx = base + (ri.clamp(0, h - 1) * w + ki.clamp(0, w - 1)).long()
            out.index_add_(0, idx.reshape(-1),
                           (values * (wy * wx * ok)[..., None]).reshape(-1, c))
    return out.reshape(n, h, w, c)


def softsplat_cover(img: torch.Tensor, flow: torch.Tensor,
                    metric: torch.Tensor):
    """(softmax splat of ``img`` with weights exp(metric), coverage)."""
    e = torch.exp(metric)
    out = splat(torch.cat([img * e, e, torch.ones_like(e)], dim=-1), flow)
    num, den = out[..., :-2], out[..., -2:-1]
    soft = torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 0.0)
    return soft, out[..., -1:].detach()


def occlusion_wang(flow21: torch.Tensor, thresh: float) -> torch.Tensor:
    """1 where the splat of ones along flow21 covers more than ``thresh``."""
    ones = torch.ones(flow21.shape[:3] + (1,), dtype=flow21.dtype,
                      device=flow21.device)
    return (splat(ones, flow21) > thresh).to(flow21.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _masked_mean(x, mask):
    return x.mean() / mask.sum() * mask.numel()


def _gray255(img):
    return (img[..., 0] * 0.2989 + img[..., 1] * 0.5870
            + img[..., 2] * 0.1140) * 255.0


def _shift(x, dy, dx):
    """x[:, y + dy, x + dx], zero beyond the border; x (N, H, W)."""
    out = torch.zeros_like(x)
    h, w = x.shape[1:]
    ys, ye = max(-dy, 0), h - max(dy, 0)
    xs, xe = max(-dx, 0), w - max(dx, 0)
    out[:, ys:ye, xs:xe] = x[:, ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def census(im, im_warp, mask, weight, md):
    c1, c2 = _gray255(im * mask), _gray255(im_warp * mask)
    acc = torch.zeros_like(c1)
    for dy in range(-md, md + 1):
        for dx in range(-md, md + 1):
            t1 = _shift(c1, dy, dx) - c1
            t2 = _shift(c2, dy, dx) - c2
            d = (t1 / torch.sqrt(0.81 + t1 ** 2)
                 - t2 / torch.sqrt(0.81 + t2 ** 2)) ** 2
            acc = acc + d / (0.1 + d)
    valid = torch.zeros_like(c1)
    valid[:, md:-md, md:-md] = 1.0
    return _masked_mean(acc / (2 * md + 1) ** 2 * valid, mask) * weight


def smooth(img, flow, weight, edge_constant):
    """First-order edge-aware smoothness, the Gaussian edge weight."""
    def grads(t):
        return t[:, 1:] - t[:, :-1], t[:, :, 1:] - t[:, :, :-1]
    ih, iw = grads(img)
    fh, fw = grads(flow)
    wh = torch.exp(-((edge_constant * ih) ** 2).mean(-1, keepdim=True))
    ww = torch.exp(-((edge_constant * iw) ** 2).mean(-1, keepdim=True))
    rob = lambda v: torch.sqrt(v ** 2 + 1e-6)
    return ((wh * rob(fh)).mean() + (ww * rob(fw)).mean()) / 2.0 * weight


def photometric(cfg: Dict, f1, f2, flow12, flow21) -> torch.Tensor:
    m1 = (f2 - warp(f1, flow21)).abs().mean(-1, keepdim=True)
    m2 = (f1 - warp(f2, flow12)).abs().mean(-1, keepdim=True)
    soft1, cov1 = softsplat_cover(f2, flow21, -20.0 * m1)
    soft2, cov2 = softsplat_cover(f1, flow12, -20.0 * m2)
    mask1 = (cov1 > cfg["occl_thresh"]).float() * (soft1 != 0).float()
    mask2 = (cov2 > cfg["occl_thresh"]).float() * (soft2 != 0).float()
    l1 = lambda a, b, m: _masked_mean((a * m - b * m).abs(), m) * cfg["loss_l1"]
    md = cfg["census_width"]
    return (l1(soft1, f1, mask1) + l1(soft2, f2, mask2)
            + census(soft1, f1, mask1, cfg["loss_census"], md)
            + census(soft2, f2, mask2, cfg["loss_census"], md)
            + smooth(f1, flow12, cfg["loss_smooth1"], cfg["edge_constant"])
            + smooth(f2, flow21, cfg["loss_smooth1"], cfg["edge_constant"]))


def train_steps(p0: Dict[str, torch.Tensor], cfg: Dict,
                batches: Sequence[Dict], prec: str = "fp32"):
    """LAMB steps from ``p0`` over ``batches`` ({frame1, frame2, times,
    scale}, :func:`pair_batch`); only the MLP trains. Returns (losses, the
    gradient of step 1, weights after step 1, weights after the last
    step), by name."""
    b1, b2, eps, lr = 0.9, 0.999, 1e-6, cfg["lr"]
    p = {k: v.detach().clone() for k, v in p0.items()}
    train = [k for k in p if k.startswith("mlp")]
    for k in train:
        p[k].requires_grad_(True)
    mu = {k: torch.zeros_like(p[k]) for k in train}
    nu = {k: torch.zeros_like(p[k]) for k in train}
    losses, g1, p1 = [], None, None
    for t, b in enumerate(batches, start=1):
        f1, f2 = b["frame1"], b["frame2"]
        h, w = f1.shape[1:3]
        flow12, flow21 = query(p, b["times"], h, w, float(b["scale"]), prec)
        loss = photometric(cfg, f1, f2, flow12, flow21)
        grads = torch.autograd.grad(loss, [p[k] for k in train])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                g1 = {k: g.clone() for k, g in zip(train, grads)}
            for k, g in zip(train, grads):
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu[k] / (1 - b1 ** t)) / (
                    (nu[k] / (1 - b2 ** t)).sqrt() + eps)
                pn, un = torch.linalg.norm(p[k]), torch.linalg.norm(u)
                ratio = pn / un if float(pn) > 0 and float(un) > 0 else 1.0
                p[k].sub_(lr * ratio * u)
            if t == 1:
                p1 = {k: p[k].detach().clone() for k in train}
    return losses, g1, p1, {k: p[k].detach() for k in train}
