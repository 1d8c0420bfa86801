"""Occlusion estimation: Wang range map, Brox forward-backward check, unity.

Counterpart of ``sin_inn_tpu/ops/occlusion.py``. The Wang range map is the
exact scatter of ones (``ops/splat.py`` ``splat_scatter``), as in the
reference package, not the windowed splat kernel.
"""

from __future__ import annotations

import torch

from sin_inn_tpu_torch.ops.splat import splat_scatter
from sin_inn_tpu_torch.ops.warp import resample2d


def occlusion_wang(flow12: torch.Tensor, flow21: torch.Tensor,
                   thresh: float) -> torch.Tensor:
    """Range-map occlusion: splat ones along flow21; pixels whose coverage
    is <= thresh are occluded. Returns a float mask (N, H, W, 1), 1 =
    visible. ``flow12`` is unused (kept for the reference's signature)."""
    del flow12
    n, h, w, _ = flow21.shape
    ones = torch.ones((n, h, w, 1), dtype=flow21.dtype, device=flow21.device)
    return (splat_scatter(ones, flow21) > thresh).to(flow21.dtype)


def occlusion_brox(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                   thresh: float = None) -> torch.Tensor:
    """Forward-backward consistency: 1 where |fw + bw o fw|^2 >=
    0.01 (|fw|^2 + |bw o fw|^2) + 0.5 (the reference's raw polarity;
    ``thresh`` is unused)."""
    del thresh
    warped_bw = resample2d(flow_bw, flow_fw)
    sq_sum = ((flow_fw + warped_bw) ** 2).sum(-1, keepdim=True)
    sum_sq = (flow_fw ** 2 + warped_bw ** 2).sum(-1, keepdim=True)
    return (sq_sum >= 0.01 * sum_sq + 0.5).to(flow_fw.dtype)


def occlusion_unity(flow: torch.Tensor, *args) -> torch.Tensor:
    """All-visible placeholder."""
    return torch.ones(flow.shape[:3] + (1,), dtype=flow.dtype,
                      device=flow.device)


OCCLUSIONS = {"wang": occlusion_wang, "brox": occlusion_brox,
              "unity": occlusion_unity, None: None}
