"""The numbers that decide ``correct``.

Training cells: each step's loss as a relative gap (``loss_gap``; the first
step's alone, ``loss1_gap``, where the later steps' follow a gradient that
is ill-conditioned in float32, PERF.md); the first gradient as the
optimizer takes it, the weights' change over the first step and over all
the checked steps, each as the worst leaf's gap between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the changes. Where the worst leaf swings with float32's rounding, a row
statistic of one leaf stands in (``row_median_gap``, PERF.md).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in t.items()}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str] = None) -> float:
    names = list(ref) if keep is None else list(keep)
    pn, rn = _norms({k: prog[k] for k in names}), _norms(
        {k: ref[k] for k in names})
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def row_median_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The median over the rows (first axis) of ``a`` of the gap between
    its row's norm and ``b``'s, over the larger of ``b``'s row norm and its
    median row's."""
    ra = torch.linalg.norm(a.double().flatten(1), dim=1)
    rb = torch.linalg.norm(b.double().flatten(1), dim=1)
    return float(((ra - rb).abs() / torch.clamp(rb, min=float(rb.median())))
                 .median())


def moving_leaves(g_ref: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = _norms(g_ref)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def training_numbers(p0: Dict[str, torch.Tensor], prog: Sequence,
                     ref: Sequence, rows_of: str = None
                     ) -> List[Tuple[str, float]]:
    """The numbers of a training cell. ``prog`` and ``ref`` are each
    (losses, first gradient, weights after step 1, weights after the last
    checked step), the weights by name; ``p0`` the weights both started
    from. With ``rows_of``, also the first gradient's median row gap of
    that leaf (``grad_row_median_gap``)."""
    losses, g1, p1, p3 = prog
    r_losses, r_g1, r_p1, r_p3 = ref
    keep = moving_leaves(r_g1)
    change = lambda p: {k: p[k] - p0[k] for k in keep}
    out = [("loss_gap", loss_gap(losses, r_losses)),
           ("loss1_gap", loss_gap(losses[:1], r_losses[:1])),
           ("grad_norm_gap", norm_gap(g1, r_g1)),
           ("change1_norm_gap", norm_gap(change(p1), change(r_p1))),
           ("change_norm_gap", norm_gap(change(p3), change(r_p3)))]
    if rows_of is not None:
        out.append(("grad_row_median_gap",
                    row_median_gap(g1[rows_of], r_g1[rows_of])))
    return out


def first_moment(opt_state: Dict, leaf: torch.Tensor) -> torch.Tensor:
    """The optimizer's first moment of ``leaf`` (zeros where the step made
    none: a step that left its state unchanged)."""
    m = opt_state.get(leaf, {}).get("exp_avg")
    return torch.zeros_like(leaf) if m is None else m
