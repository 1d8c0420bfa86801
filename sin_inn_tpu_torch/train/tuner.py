"""Auto-tuning of ``sr train``: the LR range test and the batch-size probe.

Counterpart of ``sin_inn_tpu/train/tuner.py`` (the reference enables
Lightning's ``auto_lr_find`` / ``auto_scale_batch_size``), over the port's
``train/sr.py`` state and step:

  * :func:`find_lr`: a few train steps from the same weights at each
    candidate LR; the LR whose loss fell the most wins, one whose loss turned
    non-finite loses (:func:`lr_scores` returns every LR's score);
  * :func:`find_batch_size`: one train step at a batch that doubles until
    the card runs out of memory or the batch passes ``limit``; the largest
    batch that ran wins (:func:`batch_probes` returns every probe).

One deliberate difference from the JAX package: the batch probe stops only
on ``torch.cuda.OutOfMemoryError``. Any other exception (a kernel's launch
fault, a shape error) propagates, where the JAX probe's bare ``except``
would read it as "this batch does not fit". Before the next probe, or the
fit, the failed probe's memory goes back to the card: the exception is
dropped first (its traceback's frames hold the probe's tensors), then
``gc.collect()``, then ``torch.cuda.empty_cache()``.
"""

from __future__ import annotations

import copy
import gc
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.models.inn import params_to
from sin_inn_tpu_torch.train import sr as SR

DEFAULT_LRS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)


def _init_params(cfg: SRConfig, gen: torch.Generator):
    """The tuning runs' weights: drawn from a CPU generator of ``gen``'s
    seed (the same weights on every device), or ``cfg.import_torch``'s."""
    cpu = torch.Generator().manual_seed(gen.initial_seed())
    return SR.create_state(R.named_fold(cpu, "init"), cfg)


def lr_scores(cfg: SRConfig, batch: Dict[str, torch.Tensor],
              gen: torch.Generator, lrs: Optional[Sequence[float]] = None,
              steps: int = 8, params=None,
              draws: Optional[Sequence[SR.SRDraws]] = None) -> List[Dict]:
    """For each LR, ``steps`` train steps on ``batch`` from the same weights
    (``params``, else drawn from ``gen``'s seed): its ``score`` is the first
    loss less the last, -inf if a loss turned non-finite. The noise of step
    i is ``draws[i]`` when given, else drawn from ``gen`` (on the step's
    device) at step i, the same for every LR. Returns [{"lr", "score",
    "steps", "losses"}] in ``lrs``' order."""
    lrs = list(lrs) if lrs is not None else list(DEFAULT_LRS)
    spec, init = _init_params(cfg, gen)
    if params is not None:
        init.params = params_to(params, resolve_device(cfg.device))
    out = []
    for lr in lrs:
        c = cfg.replace(learning_rate=lr)
        state = SR.train_state(copy.deepcopy(init.params), c)
        step = SR.make_train_step(spec, c)
        losses: List[float] = []
        for i in range(steps):
            aux = step(state, batch, None, gen,
                       draws=None if draws is None else draws[i])
            losses.append(float(aux["loss"]))
            if not math.isfinite(losses[-1]):
                break
        ok = bool(losses) and math.isfinite(losses[-1])
        out.append({"lr": lr, "score": losses[0] - losses[-1] if ok
                    else -math.inf, "steps": len(losses), "losses": losses})
    return out


def find_lr(cfg: SRConfig, batch: Dict[str, torch.Tensor],
            gen: torch.Generator, lrs: Optional[Sequence[float]] = None,
            steps: int = 8, params=None,
            draws: Optional[Sequence[SR.SRDraws]] = None) -> float:
    """The LR range test: the LR of the best :func:`lr_scores` score (the
    larger LR on a tie, as the JAX package's ``max`` over (score, lr))."""
    return max((r["score"], r["lr"]) for r in
               lr_scores(cfg, batch, gen, lrs, steps, params, draws))[1]


def _release(device: torch.device) -> None:
    """Return what a finished probe held to the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _probe(cfg: SRConfig, make_batch: Callable[[int], Dict],
           gen: torch.Generator, b: int) -> None:
    """One train step at batch ``b`` from fresh weights and optimizer."""
    c = cfg.replace(batch_size=b)
    spec, init = _init_params(c, gen)
    state = SR.train_state(init.params, c)
    aux = SR.make_train_step(spec, c)(state, make_batch(b), None, gen)
    float(aux["loss"])          # the step ran to its end


def batch_probes(cfg: SRConfig, make_batch: Callable[[int], Dict],
                 gen: torch.Generator, start: int = 1,
                 limit: int = 512) -> List[Dict]:
    """One train step at batch ``start``, then at twice the last batch that
    ran, until one raises ``torch.cuda.OutOfMemoryError`` or the batch
    passes ``limit``; ``make_batch(b)`` gives a batch of b windows on the
    device. Every other exception propagates. Returns [{"batch",
    "peak_bytes" (the card's peak allocation of the probe; None on the CPU
    or when it ran out), "error" (the out-of-memory message, else None)}];
    only the last may carry an error."""
    device = resolve_device(cfg.device)
    cuda = device.type == "cuda"
    out: List[Dict] = []
    b = start
    while b <= limit:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        error = None
        try:
            _probe(cfg, make_batch, gen, b)
        except torch.cuda.OutOfMemoryError as e:
            error = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        # out of the handler: the exception and its frames are gone
        _release(device)
        out.append({"batch": b, "error": error, "peak_bytes":
                    torch.cuda.max_memory_allocated(device)
                    if cuda and error is None else None})
        if error is not None:
            break
        b *= 2
    return out


def find_batch_size(cfg: SRConfig, make_batch: Callable[[int], Dict],
                    gen: torch.Generator, start: int = 1,
                    limit: int = 512) -> int:
    """The largest batch of :func:`batch_probes` that ran (``start`` if
    none did)."""
    good = [r["batch"] for r in batch_probes(cfg, make_batch, gen, start,
                                              limit) if r["error"] is None]
    return good[-1] if good else start
