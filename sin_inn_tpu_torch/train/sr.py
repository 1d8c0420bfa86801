"""Eval and inference steps for INN space-time SR.

Counterpart of the serving half of ``sin_inn_tpu/train/sr.py``
(``make_eval_step``, ``make_infer_step``). Batches arrive as uint8 tensors on
the device; normalization to [0, 1] happens there. Each step runs under
``torch.inference_mode()``. z is drawn from an explicit generator, or passed
in as a standard-normal tensor (tests hand both packages the same draw).
The train step comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.models.inn import (build_inn_spec, init_inn, inn_apply,
                                          params_to)
from sin_inn_tpu_torch.ops import losses as L


@dataclass
class SRState:
    params: List[Optional[Dict[str, Any]]]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "step": self.step}


def _to_float(img: torch.Tensor) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def create_state(gen: torch.Generator, cfg: SRConfig):
    """Build (spec, state): params drawn from ``gen`` on its own device, then
    moved to ``cfg.device``. A CPU generator gives the same weights on every
    device."""
    spec, _ = build_inn_spec(cfg, c=3)
    device = resolve_device(cfg.device)
    params = params_to(init_inn(gen, spec, c_in=3), device)
    return spec, SRState(params=params, step=0)


def _latent(shape, z: Optional[torch.Tensor], gen: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    if z is not None:
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"z has shape {tuple(z.shape)}, expected {shape}")
        return z.to(device=device, dtype=torch.float32)
    if gen is None:
        raise ValueError("pass a generator or an explicit z")
    return torch.randn(shape, generator=gen, device=device)


def make_eval_step(spec, cfg: SRConfig):
    """Validation metrics: lr_acc / hr_acc / z_nll / hr_psnr."""

    @torch.inference_mode()
    def step(params, batch: Dict[str, torch.Tensor],
             gen: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        hr = _to_float(batch["hr"])
        lr = _to_float(batch["lr"])
        b, h, w, _ = lr.shape
        z = _latent((b, h, w, cfg.z_dims), z, gen, lr.device)
        lr_z = torch.cat([lr, z], dim=-1)
        lr_z_hat = inn_apply(spec, params, hr)
        hr_hat = inn_apply(spec, params, lr_z, rev=True)
        return {
            "lr_acc": L.reconstruction(lr_z_hat[..., :cfg.lr_dims], lr),
            "hr_acc": L.reconstruction(hr_hat, hr),
            "z_nll": L.latent_nll(lr_z_hat[..., cfg.lr_dims:]),
            "hr_psnr": L.psnr(torch.clamp(hr_hat, 0, 1), hr),
        }

    return step


def make_infer_step(spec, cfg: SRConfig):
    """Inference: z at temperature ``cfg.temp``, the inverse pass, uint8 HR
    frames."""

    @torch.inference_mode()
    def step(params, lr: torch.Tensor, gen: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
        lr = _to_float(lr)
        b, h, w, _ = lr.shape
        z = cfg.temp * _latent((b, h, w, cfg.z_dims), z, gen, lr.device)
        lr_z = torch.cat([lr, z], dim=-1)
        hr_hat = inn_apply(spec, params, lr_z, rev=True)
        return (torch.clamp(hr_hat, 0.0, 1.0) * 255.0).to(torch.uint8)

    return step
