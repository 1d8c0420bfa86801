"""K7 forward's tensor-core arithmetic modelled on the CPU and held against
the JAX package's Pallas forward kernel (``_fwd_kernel``) in interpret mode.

``csrc/inr_fwd.cu`` runs each layer of a 64-point tile as 32-row slices of
the weights: u_0 = [xm | encoding x mask | 0] (xm only for a progressive
net), a_{l+1} = relu(a_l W_l + b_l), each slice's product summed from 0 and
added to the layer's fp32 accumulator; the output layer is one more product
whose depth four groups of the block's warps take, the parts added in fp32
in order before the bias. fp32 operands: every product in 3xTF32 with the split
toward zero (hi = the top 19 bits of a, lo = the same of a - hi; lo hi +
hi lo + hi hi summed in fp32), emulated here with ``mm3_rz`` of
``tests/torch_port_helpers.py``. bf16 operands: u_0 and the activations
stored rounded to bf16, the weights rounded by the wrapper, one exact TF32
product a product: here exact fp32 matmuls of the rounded operands. Small
widths (E = 128 or 131 with the coordinate rows, hidden 128, two hidden
layers), ``rbf`` / ``ff`` x ``const`` / ``point`` / ``slab`` x the
coordinate rows of a progressive net on and off, seeds that keep every relu
pre-activation off 0 (see the two modules the setups come from).

What is not modelled: how the tensor cores add inside a slice (each mma
adds into the accumulator with truncation, and the kernel starts every
slice's run of at most 12 mma from 0); here a slice's three products are
exact fp32 matmuls added together. The card tests
(``tests/test_torch_port_cuda.py``) and ``chip_smoke.py`` hold the kernel's
own accumulation to the limits.

Tolerances, each with its reason:
* against the Pallas kernel, the card's limit 1e-4 + 1e-4 |ref| (sums over
  up to 515 channels in another order, 3xTF32's 2^-20 a product); the
  share of the limit used is printed, beside one-pass TF32's (hi hi alone,
  not what the kernel does), which uses at least 20 times more of it at
  the path's widths; there also normwise within 1e-5 of the plain fp32
  forward, a gate one-pass TF32 fails;
* the slices and parts with exact products against the plain fp32
  forward: 2^-17 of the sum of the absolute terms at every layer's output
  (two fp32 sums over 131 terms in different orders, the relu and the
  bias);
* the bf16 route against the port's bf16 plain version: the card's
  1e-4 + 1e-4 |plain| at every point whose activations both round alike
  (a pre-activation at a bf16 tie may round either way under the two
  sums' orders, and the bf16 step it then takes, 2^-8 of it, reaches the
  output; ``test_torch_port_cuda.py`` says the same of the bf16 mode), and
  such points are few; against JAX's bf16 kernel 2e-2 normwise, as
  ``test_torch_port_inr_bwd.py`` (bf16 ties broken at other places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops.pallas import inr as JPI
from sin_inn_tpu_torch.ops.cuda import inr as TK7
from test_torch_port_inr_bwd import (_inputs_clear_of_the_gates,
                                     _kind_enc_layers, _nets, _normwise)
from test_torch_port_progressive import _fused_setup
from torch_port_helpers import mm1, mm3_rz
from torch_port_helpers import one_torch_thread  # noqa: F401

N_PLAIN = 301             # non-progressive nets: no multiple of a tile
SLICE = 32                # rows of a weight slice
PARTS = 4                 # parts of the output layer's depth


def _exact(a, b):
    return a @ b


def _u0(kind, enc, layers, x, mask, bf16):
    """u_0 = [xm | encoding x mask] as the kernel encodes it."""
    net = TK7._resolve(kind, enc, layers, x, mask)
    rb = TK7._bf16_round if bf16 else (lambda t: t)
    mev, mcv = TK7._mask_values(net, 0, x.shape[0], bf16)
    u = rb(TK7.encode(kind, enc, x, mev))
    return torch.cat([rb(x * mcv), u], 1) if net.prog else u


def _sliced(a, w, mm):
    """a @ w as the kernel sums it: slices of 32 rows of w, each summed from
    0, added in order in fp32."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for s in range(0, w.shape[0], SLICE):
        acc = acc + mm(a[:, s:s + SLICE], w[s:s + SLICE])
    return acc


def _kernel_model(kind, enc, layers, x, mask, bf16, mm, keep=None):
    """K7 forward as ``csrc/inr_fwd.cu`` sums it, every product by ``mm``;
    ``keep`` collects each hidden layer's activations as stored."""
    rb = TK7._bf16_round if bf16 else (lambda t: t)
    u = _u0(kind, enc, layers, x, mask, bf16)
    ws = [rb(w.float()) for w, _ in layers]
    for l in range(len(layers) - 1):
        u = rb(torch.relu(_sliced(u, ws[l], mm) + layers[l][1]))
        if keep is not None:
            keep.append(u)
    # the output layer: the depth's four parts (its k-steps of 8 split
    # evenly), each in 32-row runs from its own start, added in order
    nks = -(-ws[-1].shape[0] // 8)
    cuts = [8 * (q * nks // PARTS) for q in range(PARTS + 1)]
    parts = [_sliced(u[:, lo:hi], ws[-1][lo:hi], mm)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    total = parts[0]
    for more in parts[1:]:
        total = total + more
    return total + layers[-1][1]


def _share(got, ref):
    """The worst point's error as a share of the card's limit."""
    ref = np.asarray(ref)
    return float((np.abs(got.numpy() - ref) / (1e-4 + 1e-4 * np.abs(ref))
                  ).max())


@pytest.fixture(scope="module",
                params=["RBF-const", "FFN-const", "PRBF-const", "PFF-const",
                        "PRBF-slab", "PFF-slab", "PRBF-point", "PFF-point"])
def case(request):
    """(kind, enc, layers, x, mask, the Pallas kernel's fp32 forward) for
    one net and mask mode."""
    net, mode = request.param.split("-")
    if net in ("RBF", "FFN"):
        (jspec, jp, jc), (tspec, tp, tc) = _nets(net)
        kind, enc, layers = _kind_enc_layers(tspec, tp, tc)
        x, _, _ = _inputs_clear_of_the_gates(
            kind, enc, layers, tspec.encoding_dim, N_PLAIN, False)
        ref = JPI.fused_inr_apply(jspec, jp, jc, jnp.asarray(x), None,
                                  precise=True, tn=128, interpret=True)
        return kind, enc, layers, torch.from_numpy(x), None, np.asarray(ref)
    s = _fused_setup(net, mode)
    jspec, jp, jc = s["j"]
    ref = JPI.fused_inr_apply(jspec, jp, jc, jnp.asarray(s["pts"].numpy()),
                              s["jmask"], precise=True, tn=128,
                              interpret=True)
    return (s["kind"], s["t"][2]["enc"], s["layers"], s["pts"], s["tmask"],
            np.asarray(ref))


def test_3xtf32_forward_within_card_limits(case):
    kind, enc, layers, x, mask, ref = case
    got = _kernel_model(kind, enc, layers, x, mask, False, mm3_rz)
    one = _kernel_model(kind, enc, layers, x, mask, False, mm1)
    share, share1 = _share(got, ref), _share(one, ref)
    print(f"\nK7 forward, share of the card's limit used: 3xTF32 "
          f"{share:.3g}; one-pass TF32 {share1:.3g}")
    assert share <= 1.0


def test_slices_and_parts_are_the_plain_forward(case):
    """With exact products the kernel's slices, runs and parts compute the
    plain forward's function: every layer within fp32's reordering bound."""
    kind, enc, layers, x, mask, _ = case
    got = _kernel_model(kind, enc, layers, x, mask, False, _exact)
    want = TK7.fused_inr_forward_plain(kind, enc, layers, x, mask)
    u = _u0(kind, enc, layers, x, mask, False).abs()
    for w, _ in layers[:-1]:
        u = u @ w.abs()         # a bound of the hidden activations' terms
    terms = u @ layers[-1][0].abs() + layers[-1][1].abs()
    assert ((got - want).abs() <= 2.0 ** -17 * terms).all()
    assert got.shape == (x.shape[0], layers[-1][0].shape[1])


def test_bf16_route_within_card_limits(case):
    kind, enc, layers, x, mask, _ = case
    acts = []
    got = _kernel_model(kind, enc, layers, x, mask, True, _exact, acts)
    plain = TK7.fused_inr_forward_plain(kind, enc, layers, x, mask, bf16=True)
    # the plain version's activations as its next product rounds them: a
    # point where one of them differs had a pre-activation at a bf16 tie
    net = TK7._resolve(kind, enc, layers, x, mask)
    ref_acts, _ = TK7._recompute(kind, enc, net, layers, x, 0, x.shape[0],
                                 True, False)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool)
    for a, r in zip(acts, ref_acts[1:]):
        flipped |= (a != TK7._bf16_round(r)).any(1)
    ok = ((got - plain).abs() <= 1e-4 + 1e-4 * plain.abs()).all(1)
    print(f"\nK7 forward bf16: {int(flipped.sum())} of {x.shape[0]} points "
          f"with an activation rounded the other way")
    assert (ok | flipped).all()
    assert flipped.float().mean() < 0.05


@pytest.mark.parametrize("net", ["RBF", "FFN"])
def test_bf16_route_matches_jax_bf16_kernel(net):
    (jspec, jp, jc), (tspec, tp, tc) = _nets(net, "bfloat16")
    kind, enc, layers = _kind_enc_layers(tspec, tp, tc)
    x = np.random.RandomState(19).uniform(-1, 1, (384, 3)).astype(np.float32)
    ref = JPI.fused_inr_apply(jspec, jp, jc, jnp.asarray(x), None,
                              precise=False, tn=128, interpret=True)
    got = _kernel_model(kind, enc, layers, torch.from_numpy(x), None, True,
                        _exact)
    assert _normwise(got.numpy(), ref) < 2e-2


@pytest.mark.parametrize("net", ["RBF", "FFN", "PRBF", "PFF"])
def test_3xtf32_at_the_paths_widths(net):
    """At the flow path's widths (E = 512, + 3 coordinate rows for the
    progressive nets, MLP 512-256-256-256-4; 256 points, a constant mask)
    3xTF32 uses under 1% of the card's limit and at least 20 times less of
    it than one-pass TF32 would. The limit's absolute 1e-4 is large beside
    these outputs (|out| < 0.2), so one-pass TF32 stays inside it here
    (14-60%); the card's normwise gate of 1e-5 against the plain fp32
    forward is where it fails (about 1e-4), and 3xTF32 passes it (a few
    1e-7, as fp32 reordered)."""
    (jspec, jp, jc), (tspec, tp, tc) = _nets(
        net, num_frequencies=256, hidden_dim=256, num_layers=3)
    kind, enc, layers = _kind_enc_layers(tspec, tp, tc)
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    mask = (rng.rand(tspec.encoding_dim).astype(np.float32)
            if tspec.is_progressive else None)
    ref = JPI.fused_inr_apply(jspec, jp, jc, jnp.asarray(x),
                              None if mask is None else jnp.asarray(mask),
                              precise=True, tn=128, interpret=True)
    tx = torch.from_numpy(x)
    tm = None if mask is None else torch.from_numpy(mask)
    share = _share(_kernel_model(kind, enc, layers, tx, tm, False, mm3_rz),
                   ref)
    share1 = _share(_kernel_model(kind, enc, layers, tx, tm, False, mm1),
                    ref)
    # normwise against the plain fp32 forward, the card's second gate:
    # 3xTF32 within fp32's own reordering, one-pass TF32 well outside
    plain = TK7.fused_inr_forward_plain(kind, enc, layers, tx, tm)
    normwise = lambda mm: ((_kernel_model(kind, enc, layers, tx, tm, False,
                                          mm) - plain).norm()
                           / plain.norm()).item()
    nw3, nw1 = normwise(mm3_rz), normwise(mm1)
    print(f"\nK7 forward {net} at the path's widths, share of the card's "
          f"limit used: 3xTF32 {share:.3g}; one-pass TF32 {share1:.3g}; "
          f"normwise against plain fp32: {nw3:.3g} / {nw1:.3g}")
    assert share <= 0.01 and 20 * share <= share1
    assert nw3 <= 1e-5 < nw1


def test_kernel_rules_name_what_the_forward_holds():
    """K7 forward holds a tile's whole hidden width (at most 256) and one
    8-column output tile; its block is 198 KB at the path's widths."""
    assert TK7.kernel_supports(4, 3, 512, 256, 4, prog=True, res=50)
    assert not TK7.kernel_supports(4, 3, 64, 264, 4)       # hidden > 256
    assert not TK7.kernel_supports(4, 3, 64, 256, 9)       # out > 8
    assert TK7._fwd_smem_bytes(256, 50) == 198556
    assert TK7._fwd_smem_bytes(20, 34) < TK7._fwd_smem_bytes(256, 0)
    layers = [(torch.zeros(64, 264), torch.zeros(264)),
              (torch.zeros(264, 4), torch.zeros(4))]
    with pytest.raises(ValueError, match="at most 256.*use-kernel off"):
        TK7.require_kernel(layers, torch.zeros(5, 3))
