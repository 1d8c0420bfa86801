"""Train, eval and inference steps for INN space-time SR.

Counterpart of ``sin_inn_tpu/train/sr.py``. Batches arrive as uint8 tensors
on the device; normalization to [0, 1] happens there. The eval and infer
steps run under ``torch.inference_mode()``.

Random draws are explicit. The train step's noise (z, the TCR uniforms and
the TCR z of every iteration) is an :class:`SRDraws`, drawn from a generator
by :func:`draw_sr_noise` or passed in (tests hand both packages the same
numpy draws). The eval and infer steps take a generator or a z.

The reference's three backward calls (forward, inverse and TCR losses) are
one ``backward`` of the summed loss, as in the JAX package's single
``jax.grad``. The train step keeps its metrics on the device; the loop reads
them at its print cadence.

On a mesh (``parallel/``) each rank draws the whole batch's noise from the
same generator and takes its rows; a sharded batch computes its means on
its own rows and the MMD over the gathered batch, and the step averages the
gradients and the metrics over the data group, so every rank takes the
single-process step. A batch the data axis does not divide is computed
whole on every rank. The GLOW subnets' TP shards run over the model group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.core.profiler import span
from sin_inn_tpu_torch.models.inn import (build_inn_spec, init_inn, inn_apply,
                                          flat_params, params_to)
from sin_inn_tpu_torch.ops import losses as L
from sin_inn_tpu_torch.ops.tcr import tcr_transform
from sin_inn_tpu_torch.train.optim import adam_l2


@dataclass
class SRState:
    params: List[Optional[Dict[str, Any]]]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "step": self.step}


@dataclass
class SRTrainState:
    """Params (leaves that require grad), their Adam optimizer, the step;
    on a mesh, ``shardings`` maps each param's path to its spec."""
    params: List[Optional[Dict[str, Any]]]
    optimizer: torch.optim.Optimizer
    step: int = 0
    shardings: Optional[Dict] = None

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.optimizer.state_dict(),
                "step": self.step}


class SRDraws(NamedTuple):
    """The train step's noise. z: (B, h, w, z_dims); tcr_rand:
    (tcr_iters, B, 3) uniforms and tcr_z: (tcr_iters, B, h, w, z_dims), or
    None without TCR."""
    z: torch.Tensor
    tcr_rand: Optional[torch.Tensor] = None
    tcr_z: Optional[torch.Tensor] = None


def _to_float(img: torch.Tensor) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def create_state(gen: torch.Generator, cfg: SRConfig):
    """Build (spec, state): params drawn from ``gen`` on its own device, or
    imported from ``cfg.import_torch`` (a reference checkpoint, checked
    against the spec), then moved to ``cfg.device``. A CPU generator gives
    the same weights on every device."""
    spec, _ = build_inn_spec(cfg, c=3)
    device = resolve_device(cfg.device)
    if cfg.import_torch:
        from sin_inn_tpu_torch.models.torch_import import \
            load_reference_checkpoint
        _, params = load_reference_checkpoint(cfg.import_torch, cfg)
    else:
        params = init_inn(gen, spec, c_in=3)
    return spec, SRState(params=params_to(params, device), step=0)


def train_state(params, cfg: SRConfig, opt_state=None,
                step: int = 0) -> SRTrainState:
    """Make ``params`` trainable leaves and build their optimizer (restoring
    its state from ``opt_state`` when given)."""
    for t in flat_params(params):
        t.requires_grad_(True)
    opt = adam_l2(flat_params(params), cfg.learning_rate, cfg.adam_betas,
                  weight_decay=cfg.weight_decay)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    return SRTrainState(params=params, optimizer=opt, step=step)


def create_train_state(gen: torch.Generator, cfg: SRConfig):
    """(spec, SRTrainState): :func:`create_state`'s params with Adam."""
    spec, state = create_state(gen, cfg)
    return spec, train_state(state.params, cfg)


def draw_sr_noise(gen: torch.Generator, cfg: SRConfig, b: int, h: int,
                  w: int) -> SRDraws:
    """The train step's noise for a batch of b windows at LR size h x w, on
    ``gen``'s device, in the step's z dtype (bf16 in the bfloat16 mode)."""
    zdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    kw = dict(generator=gen, device=gen.device)
    z = torch.randn((b, h, w, cfg.z_dims), dtype=zdt, **kw)
    if cfg.lambda_bwd_tcr <= 0:
        return SRDraws(z)
    n = int(cfg.tcr_iters)
    return SRDraws(z, torch.rand((n, b, 3), **kw),
                   torch.randn((n, b, h, w, cfg.z_dims), dtype=zdt, **kw))


def shard_draws(draws: SRDraws, mesh, sup: Dict,
                unsup: Optional[Dict] = None) -> SRDraws:
    """This rank's rows of the whole batch's draws: z follows the sharding
    of ``sup``, the TCR draws that of ``unsup``."""
    if mesh is None or mesh.data == 1:
        return draws      # one data shard: the rows are the whole batch's
    from sin_inn_tpu_torch.parallel.mesh import shard_rows
    take = lambda t, b, dim: (
        t if t is None or not getattr(b, "sharded", False) else
        shard_rows(t.transpose(0, dim), mesh.data,
                   mesh.data_index).transpose(0, dim))
    return SRDraws(take(draws.z, sup, 0), take(draws.tcr_rand, unsup, 1),
                   take(draws.tcr_z, unsup, 1))


def sr_loss(params, spec, cfg: SRConfig, sup: Dict, unsup: Optional[Dict],
            draws: SRDraws, mesh=None, tp=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss = fwd + bwd + tcr, term for term as the JAX package's
    ``sr_loss``. Returns (loss, aux) with aux's values detached.

    With ``mesh``, ``sup`` / ``unsup`` are placed batches and ``draws`` this
    rank's rows of them (:func:`shard_draws`): the MMD terms span the data
    group when ``sup`` is sharded. ``tp``: the couplings that run
    tensor-parallel over the model group (``parallel/sharding.py``
    ``tp_couplings``). The loss is then this rank's share: its mean over
    the data group is the whole batch's loss."""
    from sin_inn_tpu_torch.parallel.sharding import data_group
    dp = data_group(mesh, sup)
    hr = _to_float(sup["hr"])
    lr = _to_float(sup["lr"])
    # in bf16 mode z and lr_z are built in bfloat16 and the INN runs its
    # chain from a bfloat16 input; losses reduce in fp32 at the boundary
    zdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else hr.dtype
    z = draws.z.to(zdt)
    lr_z = torch.cat([lr.to(zdt), z], dim=-1)

    # forward pass: HR -> (LR || z)
    with span("model.inn"):
        lr_z_hat = inn_apply(spec, params, hr.to(zdt), remat=cfg.remat,
                             tp=tp).to(hr.dtype)
    fwd_loss = cfg.lambda_fwd_rec * L.reconstruction(
        lr_z_hat[..., :cfg.lr_dims], lr)
    if cfg.lambda_fwd_mmd:
        fwd_loss = fwd_loss + cfg.lambda_fwd_mmd * L.mmd(
            lr_z_hat, lr_z.to(hr.dtype), group=dp)
    if cfg.lambda_latent_nll:
        fwd_loss = fwd_loss + cfg.lambda_latent_nll * L.latent_nll(
            lr_z_hat[..., cfg.lr_dims:])

    # inverse pass: (LR || z) -> HR
    with span("model.inn"):
        hr_hat = inn_apply(spec, params, lr_z, rev=True, remat=cfg.remat,
                           tp=tp).to(hr.dtype)
    bwd_loss = cfg.lambda_bwd_rec * L.reconstruction(hr_hat, hr)
    if cfg.lambda_bwd_mmd:
        bwd_loss = bwd_loss + cfg.lambda_bwd_mmd * L.mmd(hr_hat, hr, rev=True,
                                                        group=dp)

    # TCR on the unsupervised batch
    tcr_loss = torch.zeros((), dtype=hr.dtype, device=hr.device)
    if cfg.lambda_bwd_tcr > 0 and unsup is not None:
        if draws.tcr_rand is None or draws.tcr_z is None:
            raise ValueError("TCR is on but the draws carry no TCR noise")
        lr_u = _to_float(unsup["lr"])
        total = torch.zeros((), dtype=hr.dtype, device=hr.device)
        for i in range(int(cfg.tcr_iters)):
            rand = draws.tcr_rand[i].to(lr_u.dtype)
            zi = draws.tcr_z[i].to(zdt)
            lr_zi = torch.cat([lr_u.to(zdt), zi], dim=-1)
            tcr_lr = tcr_transform(lr_u, rand, cfg.rotation, cfg.translation,
                                   scale=1.0 / cfg.scale,
                                   stop_grad=cfg.tcr_stop_grad)
            tcr_lr_z = torch.cat([tcr_lr.to(zdt), zi], dim=-1)
            with span("model.inn"):
                tcr_hr_hat = inn_apply(spec, params, tcr_lr_z, rev=True,
                                       remat=cfg.remat,
                                       tp=tp).to(lr_u.dtype)
            with span("model.inn"):
                hr_hat_i = inn_apply(spec, params, lr_zi, rev=True,
                                     remat=cfg.remat, tp=tp).to(lr_u.dtype)
            hr_hat_tcr = tcr_transform(hr_hat_i, rand, cfg.rotation,
                                       cfg.translation,
                                       stop_grad=cfg.tcr_stop_grad)
            total = total + L.reconstruction(tcr_hr_hat, hr_hat_tcr)
        tcr_loss = cfg.lambda_bwd_tcr / cfg.tcr_iters * total

    loss = fwd_loss + bwd_loss + tcr_loss
    aux = {"loss": loss, "fwd": fwd_loss, "bwd": bwd_loss, "tcr": tcr_loss}
    return loss, {k: v.detach() for k, v in aux.items()}


def make_train_step(spec, cfg: SRConfig, mesh=None):
    """Returns ``step(state, sup, unsup, gen=None, draws=None) -> aux``:
    zero the grads, one backward of the summed loss, one Adam step,
    ``state.step += 1``. Without ``draws`` the noise is drawn from ``gen``
    folded with the step count (the JAX step's ``fold_in(key, step)``).
    aux stays on the device.

    With ``mesh`` the batches are placed ones and ``draws`` (or the draws
    from ``gen``) are the whole batch's; the step takes this rank's rows,
    averages the gradients over the data group before the Adam step and
    returns the whole batch's metrics."""
    from sin_inn_tpu_torch.parallel.sharding import (batch_rows,
                                                     reduce_metrics,
                                                     sync_grads, tp_couplings)

    def step(state: SRTrainState, sup: Dict, unsup: Optional[Dict] = None,
             gen: Optional[torch.Generator] = None,
             draws: Optional[SRDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None and gen is None:
            raise ValueError("pass a generator or explicit draws")
        with span("step.loss"):
            if draws is None:
                _, h, w, _ = sup["lr"].shape
                draws = draw_sr_noise(R.step_fold(gen, state.step), cfg,
                                      batch_rows(sup), h, w)
            draws = shard_draws(draws, mesh, sup, unsup)
            state.optimizer.zero_grad(set_to_none=True)
            loss, aux = sr_loss(state.params, spec, cfg, sup, unsup, draws,
                                mesh, tp_couplings(mesh, state.shardings))
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            sync_grads(mesh, state.optimizer.param_groups[0]["params"])
            state.optimizer.step()
        state.step += 1
        return reduce_metrics(mesh, aux)

    return step


def _latent(shape, z: Optional[torch.Tensor], gen: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    if z is not None:
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"z has shape {tuple(z.shape)}, expected {shape}")
        return z.to(device=device, dtype=torch.float32)
    if gen is None:
        raise ValueError("pass a generator or an explicit z")
    return torch.randn(shape, generator=gen, device=device)


def make_eval_step(spec, cfg: SRConfig, mesh=None, shardings=None):
    """Validation metrics: lr_acc / hr_acc / z_nll / hr_psnr of a whole
    batch (on a mesh every rank evaluates it, over the TP shards that
    ``shardings``, the train state's, places)."""
    from sin_inn_tpu_torch.parallel.sharding import tp_couplings
    tp = tp_couplings(mesh, shardings)

    @torch.inference_mode()
    def step(params, batch: Dict[str, torch.Tensor],
             gen: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        hr = _to_float(batch["hr"])
        lr = _to_float(batch["lr"])
        b, h, w, _ = lr.shape
        z = _latent((b, h, w, cfg.z_dims), z, gen, lr.device)
        lr_z = torch.cat([lr, z], dim=-1)
        lr_z_hat = inn_apply(spec, params, hr, tp=tp)
        hr_hat = inn_apply(spec, params, lr_z, rev=True, tp=tp)
        return {
            "lr_acc": L.reconstruction(lr_z_hat[..., :cfg.lr_dims], lr),
            "hr_acc": L.reconstruction(hr_hat, hr),
            "z_nll": L.latent_nll(lr_z_hat[..., cfg.lr_dims:]),
            "hr_psnr": L.psnr(torch.clamp(hr_hat, 0, 1), hr),
        }

    return step


def make_infer_step(spec, cfg: SRConfig, mesh=None, shardings=None):
    """Inference: z at temperature ``cfg.temp``, the inverse pass, uint8 HR
    frames (over the TP shards that ``shardings`` places)."""
    from sin_inn_tpu_torch.parallel.sharding import tp_couplings
    tp = tp_couplings(mesh, shardings)

    @torch.inference_mode()
    def step(params, lr: torch.Tensor, gen: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
        lr = _to_float(lr)
        b, h, w, _ = lr.shape
        z = cfg.temp * _latent((b, h, w, cfg.z_dims), z, gen, lr.device)
        lr_z = torch.cat([lr, z], dim=-1)
        hr_hat = inn_apply(spec, params, lr_z, rev=True, tp=tp)
        return (torch.clamp(hr_hat, 0.0, 1.0) * 255.0).to(torch.uint8)

    return step
