"""The controls and faults a cell's limits are held against.

* The control: the nearest precision below the configuration's in the
  program's place. ``srf-4x`` states float32 with TF32 convolutions, so its
  control is bfloat16, and the program has that path of its own
  (``compute_dtype="bfloat16"``). The flow configuration states float32
  with TF32 off, so its control is TF32, which the program has no path
  for: the reference in TF32 takes its place.
* The faults of a training cell: a step that leaves its state unchanged
  (it reads 1 in the change's norm gaps by the measure's definition), and
  half of each batch left out with the mean taken over the rest, read by
  the reference over the first half of each checked batch.
* The fault of a rendering cell: an answer altered where it is produced.

``plant`` puts a fault into the program for the tests that drive a whole
run with the timed path broken.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch

from harness import core


def program_numbers(cell: core.Cell, seed: int, seconds: float, device,
                    config: Dict = None, check: bool = True):
    """A run's checked numbers without its timing: set-up with the checked
    steps and, for a serving cell, ``seconds`` of its units."""
    cls = core.entry_module(cell.traffic["entry"]).Cell
    traffic = dict(cell.traffic, warm_steps=0, warm_passes=1)
    e = cls(config or cell.config, traffic, seed, device)
    e.setup()
    if cell.traffic["entry"] == "flow_test":
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            e.unit()
    core.sync(device)
    e.release()
    return e, (dict(e.check()) if check else {})


def control_numbers(cell: core.Cell, seed: int, seconds: float, device):
    kind = cell.traffic["entry"]
    if kind == "sr_train":
        cfg = dict(cell.config, compute_dtype="bfloat16")
        return program_numbers(cell, seed, seconds, device, cfg)
    e, _ = program_numbers(cell, seed, 0.0, device, check=False)
    if kind == "flow_train":
        ref = e.reference("fp32")
        return e, dict(e.numbers(e.reference("tf32"), ref))
    flows, masks = e.reference("fp32")
    cflows, cmasks = e.reference("tf32")
    samples = [(i, f.cpu().numpy(), m.cpu().numpy())
               for i, (f, m) in enumerate(zip(cflows, cmasks))]
    return e, dict(e.numbers(flows, masks, samples))


def batch_rows(cell: core.Cell) -> int:
    if cell.traffic["entry"] == "sr_train":
        return cell.config["batch_size"]
    return cell.traffic["batch"]


def half_batch_numbers(e, batch: int) -> Dict[str, float]:
    return dict(e.numbers(e.reference(keep=batch - batch // 2),
                          e.reference()))


# ---------------------------------------------------------------------------
# Faults planted in the program
# ---------------------------------------------------------------------------

def _half(batch: Dict) -> Dict:
    n = next(v.shape[0] for k, v in batch.items() if torch.is_tensor(v))
    keep = n - n // 2
    return {k: v[:keep] if torch.is_tensor(v) else v
            for k, v in batch.items()}


def _wrap_step(make, fault: str):
    def wrapped(*a, **kw):
        real = make(*a, **kw)

        def step(state, *args, **kws):
            if fault == "half_batch":
                args = tuple(_half(x) if isinstance(x, dict) and (
                    "hr" in x or "frame1" in x) else x for x in args)
                if kws.get("draws") is not None:
                    d = kws["draws"]
                    keep = d.z.shape[0] - d.z.shape[0] // 2
                    kws["draws"] = type(d)(d.z[:keep])
                return real(state, *args, **kws)
            params = state.optimizer.param_groups[0]["params"]
            before = [p.detach().clone() for p in params]
            out = real(state, *args, **kws)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            state.optimizer.state.clear()
            return out
        return step
    return wrapped


@contextlib.contextmanager
def plant(kind: str, fault: str):
    """The program with ``fault`` in its timed path: for training
    ``unchanged_state`` or ``half_batch``; for serving ``altered_answer``
    (one pair's flow moved by half a pixel where the query produces it)."""
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train import loop
    from sin_inn_tpu_torch.train import sr as SR
    if kind == "flow_test":
        if fault != "altered_answer":
            raise ValueError(fault)
        real = loop.flow_test_outputs

        def altered(*a, **kw):
            out = real(*a, **kw)
            out["flow12"][1, ..., 0] += 0.5
            return out
        mod, name, new = loop, "flow_test_outputs", altered
    elif kind in ("sr_train", "flow_train"):
        if fault not in ("unchanged_state", "half_batch"):
            raise ValueError(fault)
        mod = SR if kind == "sr_train" else FT
        name = "make_train_step" if kind == "sr_train" else \
            "make_flow_train_step"
        new = _wrap_step(getattr(mod, name), fault)
    else:
        raise ValueError(kind)
    old = getattr(mod, name)
    setattr(mod, name, new)
    try:
        yield
    finally:
        setattr(mod, name, old)


FAULTS: Dict[str, Tuple[str, ...]] = {
    "sr_train": ("unchanged_state", "half_batch"),
    "flow_train": ("unchanged_state", "half_batch"),
    "flow_test": ("altered_answer",),
}
