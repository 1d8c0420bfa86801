"""Photometric losses: masked L1, census, SSIM, edge-aware smoothness.

Counterpart of ``sin_inn_tpu/ops/photometric.py``, function for function,
all NHWC. A loss whose weight is 0 returns a zero scalar without computing
anything, as there. The census loss is the same sum over the p x p shifts
(it never holds the (N, H, W, p^2) patch tensor); ``_ternary_transform`` is
the patch form of it, kept for the tests.

The masked losses normalise by the mask over the whole batch. With
``group`` (the data group of a sharded batch) the inputs are this rank's
shard, and the mean and the mask's sum and size are taken over every
rank's shard (sums whose backward sums over the group too), so each rank
holds the whole batch's value.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _avg_pool_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k mean pool, stride 1, no padding, on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride=1,
                        padding=0).permute(0, 2, 3, 1)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, group) -> torch.Tensor:
    """x.mean() / mask.sum() * mask.numel(), each over the whole batch."""
    if group is None:
        return x.mean() / mask.sum() * mask.numel()
    import torch.distributed as dist

    from sin_inn_tpu_torch.parallel.mesh import all_reduce_sum
    n = dist.get_world_size(group)
    mean = all_reduce_sum(x.sum(), group) / (x.numel() * n)
    return mean / all_reduce_sum(mask.sum(), group) * (mask.numel() * n)


def masked_l1(im1: torch.Tensor, im2: torch.Tensor, mask: torch.Tensor,
              weight: float, group=None) -> torch.Tensor:
    """mean|im1 m - im2 m| / m.sum() * m.numel() * weight."""
    if weight == 0:
        return _zero(im1)
    return _masked_mean((im1 * mask - im2 * mask).abs(), mask, group) * weight


def _rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, (N, H, W, 3) -> (N, H, W, 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (r * 0.2989 + g * 0.5870 + b * 0.1140)[..., None]


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[..., y + dy, x + dx] with zeros beyond the border. x: (N, H, W)."""
    _, h, w = x.shape
    out = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    return out[:, max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def _ternary_transform(img: torch.Tensor, max_distance: int) -> torch.Tensor:
    """Census (ternary) transform, (N, H, W, 3) -> (N, H, W, p^2): the patch
    form of what :func:`census_loss` sums shift by shift."""
    md = max_distance
    inten = _rgb_to_grayscale(img)[..., 0] * 255.0
    patches = torch.stack([_shift2d(inten, dy, dx)
                           for dy in range(-md, md + 1)
                           for dx in range(-md, md + 1)], dim=-1)
    transf = patches - inten[..., None]
    return transf / torch.sqrt(0.81 + transf ** 2)


def census_loss(im: torch.Tensor, im_warp: torch.Tensor, mask: torch.Tensor,
                weight: float, max_distance: int = 3,
                group=None) -> torch.Tensor:
    """Soft Hamming distance of the ternary patches of the two masked
    images, the border of ``max_distance`` pixels left out, normalised by
    the mask."""
    if weight == 0:
        return _zero(im)
    md = max_distance
    p = 2 * md + 1
    c1 = _rgb_to_grayscale(im * mask)[..., 0] * 255.0        # (N, H, W)
    c2 = _rgb_to_grayscale(im_warp * mask)[..., 0] * 255.0
    acc = torch.zeros_like(c1)
    for dy in range(-md, md + 1):
        for dx in range(-md, md + 1):
            t1 = _shift2d(c1, dy, dx) - c1
            t2 = _shift2d(c2, dy, dx) - c2
            f1 = t1 / torch.sqrt(0.81 + t1 ** 2)
            f2 = t2 / torch.sqrt(0.81 + t2 ** 2)
            d = (f1 - f2) ** 2
            acc = acc + d / (0.1 + d)
    dist_mean = acc / (p * p)
    _, h, w, _ = im.shape
    # the interior, built on the device: a slice assignment of a Python
    # number would copy it from the host and wait for the card
    valid = F.pad(torch.ones((1, h - 2 * md, w - 2 * md), dtype=im.dtype,
                             device=im.device), (md, md, md, md))
    return _masked_mean(dist_mean * valid, mask, group) * weight


def ssim_loss(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
              weight: float, md: int = 1, group=None) -> torch.Tensor:
    """Mean clipped (1 - SSIM) / 2 over (2 md + 1)-pixel windows of the
    masked images, normalised by the mask."""
    if weight == 0:
        return _zero(x)
    x = x * mask
    y = y * mask
    k = 2 * md + 1
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    mu_x = _avg_pool_valid(x, k)
    mu_y = _avg_pool_valid(y, k)
    mu_xy = mu_x * mu_y
    mu_x2 = mu_x ** 2
    mu_y2 = mu_y ** 2
    sigma_x = _avg_pool_valid(x * x, k) - mu_x2
    sigma_y = _avg_pool_valid(y * y, k) - mu_y2
    sigma_xy = _avg_pool_valid(x * y, k) - mu_xy
    ssim_n = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)
    dist = torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0)
    return _masked_mean(dist, mask, group) * weight


def image_grads(img: torch.Tensor,
                stride: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gh, gw) finite differences of an NHWC image."""
    gh = img[:, stride:] - img[:, :-stride]
    gw = img[:, :, stride:] - img[:, :, :-stride]
    return gh, gw


def robust_l1(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x ** 2 + 0.001 ** 2)


def bilateral_smooth(img: torch.Tensor, flow: torch.Tensor, weight: float,
                     edge_func: str = "gauss", edge_constant: float = 150.0,
                     order: int = 1) -> torch.Tensor:
    """Edge-aware flow smoothness: the robust L1 of the flow's first (or
    second) differences, weighted down across image edges."""
    if weight == 0:
        return _zero(img)
    abs_fun = torch.abs if edge_func == "exp" else (lambda v: v ** 2)
    img_gh, img_gw = image_grads(img, stride=order)
    flow_gh, flow_gw = image_grads(flow)
    w_h = torch.exp(-abs_fun(edge_constant * img_gh).mean(-1, keepdim=True))
    w_w = torch.exp(-abs_fun(edge_constant * img_gw).mean(-1, keepdim=True))
    if order == 1:
        loss = ((w_h * robust_l1(flow_gh)).mean()
                + (w_w * robust_l1(flow_gw)).mean()) / 2.0
    elif order == 2:
        # stride-2 image differences already have the second-order shapes
        flow_ghh, _ = image_grads(flow_gh)
        _, flow_gww = image_grads(flow_gw)
        loss = ((w_h * robust_l1(flow_ghh)).mean()
                + (w_w * robust_l1(flow_gww)).mean()) / 2.0
    else:
        raise ValueError(order)
    return loss * weight
