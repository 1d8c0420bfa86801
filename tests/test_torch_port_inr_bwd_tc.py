"""K7 backward's tensor-core arithmetic modelled on the CPU and held against
the JAX package's Pallas backward kernel (``_bwd_kernel``) in interpret mode.

``csrc/inr_bwd.cu`` stages the backward: a row stage recomputes u_0 = [xm |
a_0] (xm only for a progressive net) and a_{l+1} = relu(a_l W_l + b_l), then
the cotangent chain g_{l-1} = (g_l W_l') [a_l > 0]; a weight stage takes
[dW_l | db_l] = u_l' g_l over slots of rows, each slot written once, and the
slots are summed in a fixed order. fp32 operands: every product in 3xTF32
(each operand split into hi = tf32(a), ``cvt.rna``, and lo = tf32(a - hi);
lo hi + hi lo + hi hi summed in fp32), emulated here with ``mm3`` of
``tests/torch_port_helpers.py``. bf16 operands: the activations stored
rounded to bf16, the cotangents rounded where a product reads them (the bias
sums take them unrounded), one TF32 product a product, which is exact on
bf16 values: here exact fp32 matmuls of the rounded operands. Small widths
(E = 128 or 131 with the coordinate rows, hidden 128, two hidden layers),
``rbf`` / ``ff`` x ``const`` / ``point`` / ``slab`` x the coordinate rows of
a progressive net on and off, seeds that keep every relu pre-activation off
0 (see the two modules the setups come from).

What is not modelled: how the tensor cores add. Each mma adds into the
accumulator with truncation, and the kernel starts every run of at most 12
mma from 0; here the three products are exact fp32 matmuls added together.
The card tests (``tests/test_torch_port_cuda.py``) and ``chip_smoke.py``
hold the kernel's own accumulation to the limits.

Tolerances, each with its reason:
* against the Pallas kernel, the card's limit: each weight and bias leaf
  within 1e-3 of its largest |ref| (sums over 300-1,024 rows in another
  order, 3xTF32's 2^-21 a product); the share of the limit used is
  printed, beside one-pass TF32's (hi hi alone, not what the kernel does);
* the slot sums against one plain fp32 sum of the same operands: 2^-15 of
  the sum of the absolute terms (two fp32 sums over 1,024 rows in different
  orders, 1,024 x 2^-24, with 3xTF32's 2^-21 a product beside it), plus
  fp32's smallest normal value, below which rounding is absolute (the RBF
  encoding's far channels give products of 1e-44);
* the bf16 route against the port's bf16 plain version: the card's 1e-3 of
  each leaf's largest |plain| (the same rounded operands, sums in another
  order); against JAX's bf16 kernel: 2e-2 normwise, as
  ``test_torch_port_inr_bwd.py`` (bf16 ties broken at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops.pallas import inr as JPI
from sin_inn_tpu_torch.ops.cuda import inr as TK7
from test_torch_port_inr_bwd import (_inputs_clear_of_the_gates, _jax_grads,
                                     _kind_enc_layers, _nets, _normwise)
from test_torch_port_progressive import _fused_setup
from torch_port_helpers import mm1, mm3
from torch_port_helpers import one_torch_thread  # noqa: F401

SLOT = 96                 # rows a slot here: ragged last slot at every n
N_PLAIN = 301             # non-progressive nets: no multiple of a tile
TINY = torch.finfo(torch.float32).tiny


def _exact(a, b):
    return a @ b


def _kernel_model(kind, enc, layers, x, mask, g, bf16, mm, slot=SLOT):
    """K7 backward as ``csrc/inr_bwd.cu`` stages it, every product by
    ``mm``, in bf16 mode on rounded operands: [(dW_l, db_l)] (a progressive
    net's coordinate rows first in dW_0), and the stage's operands u_l and
    g_l."""
    net = TK7._resolve(kind, enc, layers, x, mask)
    rb = TK7._bf16_round if bf16 else (lambda t: t)
    n = x.shape[0]
    mev, mcv = TK7._mask_values(net, 0, n, bf16)
    u0 = TK7.encode(kind, enc, x, mev)
    if net.prog:
        u0 = torch.cat([x * mcv, u0], 1)
    ws = [rb(w.float()) for w, _ in layers]
    acts = [rb(u0)]
    for l in range(len(layers) - 1):
        acts.append(rb(torch.relu(mm(acts[-1], ws[l]) + layers[l][1])))
    cots = [None] * len(layers)
    cots[-1] = g
    for l in range(len(layers) - 1, 0, -1):
        cots[l - 1] = mm(rb(cots[l]), ws[l].t()) * (acts[l] > 0)
    grads = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in layers]
    for s in range(0, n, slot):      # each slot once, summed in order
        grads = [(dw + mm(u[s:s + slot].t(), rb(c[s:s + slot])),
                  db + c[s:s + slot].sum(0))
                 for (dw, db), u, c in zip(grads, acts, cots)]
    return grads, acts, cots


def _share(got, ref):
    """The worst leaf's error as a share of the card's limit, 1e-3 of the
    leaf's largest |ref|."""
    return max((np.abs(a.numpy() - np.asarray(r)).max()
                / (1e-3 * np.abs(np.asarray(r)).max()))
               for pair, rp in zip(got, ref)
               for a, r in zip(pair, (rp["w"], rp["b"])))


@pytest.fixture(scope="module",
                params=["RBF-const", "FFN-const", "PRBF-const", "PFF-const",
                        "PRBF-slab", "PFF-slab", "PRBF-point", "PFF-point"])
def case(request):
    """(kind, enc, layers, x, mask, g, the Pallas kernel's fp32 gradients)
    for one net and mask mode."""
    net, mode = request.param.split("-")
    if net in ("RBF", "FFN"):
        (jspec, jp, jc), (tspec, tp, tc) = _nets(net)
        kind, enc, layers = _kind_enc_layers(tspec, tp, tc)
        x, tgt, _ = _inputs_clear_of_the_gates(
            kind, enc, layers, tspec.encoding_dim, N_PLAIN, False)
        ref = _jax_grads(jspec, jp, jc, x, None, tgt, precise=True)
        return (kind, enc, layers, torch.from_numpy(x), None,
                torch.from_numpy(tgt), ref)
    s = _fused_setup(net, mode)
    jspec, jp, jc = s["j"]
    pts = s["pts"]
    jpts = jnp.asarray(pts.numpy())
    tgt = np.random.RandomState(7).randn(pts.shape[0], 4).astype(np.float32)

    def loss(p):
        out = JPI.fused_inr_apply(jspec, p, jc, jpts, s["jmask"],
                                  precise=True, tn=128, interpret=True)
        return jnp.sum(out * tgt)

    ref = jax.grad(loss)(jp)["mlp"]
    return (s["kind"], s["t"][2]["enc"], s["layers"], pts, s["tmask"],
            torch.from_numpy(tgt), ref)


def test_3xtf32_backward_within_card_limits(case):
    kind, enc, layers, x, mask, g, ref = case
    got, _, _ = _kernel_model(kind, enc, layers, x, mask, g, False, mm3)
    one, _, _ = _kernel_model(kind, enc, layers, x, mask, g, False, mm1)
    share, share1 = _share(got, ref), _share(one, ref)
    print(f"\nK7 backward, share of the card's leaf limit used: 3xTF32 "
          f"{share:.3g}; one-pass TF32 {share1:.3g}")
    assert share <= 1.0


def test_slots_match_one_plain_sum(case):
    kind, enc, layers, x, mask, g, _ = case
    got, acts, cots = _kernel_model(kind, enc, layers, x, mask, g, False,
                                    mm3)
    for (dw, db), u, c in zip(got, acts, cots):
        terms = (u.abs().t() @ c.abs(), c.abs().sum(0))
        for a, b, t in zip((dw, db), (u.t() @ c, c.sum(0)), terms):
            assert ((a - b).abs() <= 2.0 ** -15 * t + TINY).all()
    # the leaves in the shapes of the layers, the coordinate rows in dW_0
    assert [tuple(dw.shape) for dw, _ in got] == \
        [tuple(w.shape) for w, _ in layers]


def test_bf16_route_within_card_limits(case):
    kind, enc, layers, x, mask, g, _ = case
    got, _, _ = _kernel_model(kind, enc, layers, x, mask, g, True, _exact)
    plain = TK7.fused_inr_backward_plain(kind, enc, layers, x, mask, g,
                                         bf16=True)
    for pair, pp in zip(got, plain):
        for a, b in zip(pair, pp):
            assert (a - b).abs().max() <= 1e-3 * b.abs().max()


@pytest.mark.parametrize("net", ["RBF", "FFN"])
def test_bf16_route_matches_jax_bf16_kernel(net):
    (jspec, jp, jc), (tspec, tp, tc) = _nets(net, "bfloat16")
    kind, enc, layers = _kind_enc_layers(tspec, tp, tc)
    rng = np.random.RandomState(19)
    x = rng.uniform(-1, 1, (384, 3)).astype(np.float32)
    # a cotangent with a mean: with a zero-mean one the sums cancel and the
    # comparison measures where the two frameworks break bf16 ties
    tgt = (0.5 + rng.rand(384, 4)).astype(np.float32)
    ref = _jax_grads(jspec, jp, jc, x, None, tgt, precise=False)
    got, _, _ = _kernel_model(kind, enc, layers, torch.from_numpy(x), None,
                              torch.from_numpy(tgt), True, _exact)
    for (dw, db), r in zip(got, ref):
        assert _normwise(dw.numpy(), r["w"]) < 2e-2
        assert _normwise(db.numpy(), r["b"]) < 2e-2
