"""K3/K4's tensor-core arithmetic (3xTF32) modelled on the CPU and held
against the JAX package's Pallas backward kernels in interpret mode.

``csrc/coupling_1x1_bwd.cu`` takes every product of K3 and K4 on the tensor
cores: each fp32 operand a is split into hi = tf32(a) (``cvt.rna``: to
nearest on the top 10 mantissa bits, ties away from zero) and lo =
tf32(a - hi), and a b is taken as lo hi + hi lo + hi hi, summed in fp32.
Here that split is emulated in plain PyTorch (``tf32_rna``, ``mm3`` of
``tests/torch_port_helpers.py``), every product of the reverse chain
(``_plain_rows``) goes through it, and the weight products are summed over
row chunks in a fixed order as the kernel's slots are. Inputs come from numpy seeds at C = 48 and C = 192,
hidden 256, the SRF flagship's widths, over 512 rows.

What is not modelled: how the tensor cores add. Each mma adds its products
into the accumulator with truncation, and the kernel starts every run of at
most 12 mma from 0 and adds it to the running sum in fp32 against the bias
that truncation builds up; here the three products are exact fp32 matmuls
added together, so these tests pass with or without that reset. The card
tests (``tests/test_torch_port_cuda.py``, at the flagship's shapes) and
``chip_smoke.py`` hold the kernel's own accumulation to the limits.

Tolerances, each with its reason:
* against the Pallas reference, the card's limits (``chip_smoke.py``): dx
  within 1e-4 + 1e-4 |ref|, each weight and bias leaf within 1e-3 of its
  largest |ref|, both plus ``relu_gate_slack`` (a pre-activation within
  1e-5 of 0 may be gated either way);
* the chunked sum against the plain fp32 sum of the same operands: 2^-15
  of the sum of the absolute terms, the a-priori bound of two fp32 sums
  over 512 rows in different orders (512 x 2^-24) with 3xTF32's 2^-21 per
  product beside it;
* one-pass TF32 (hi hi alone) is only printed, as a margin against the
  same limits: it is not what the kernel does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops import subnet as JS
from sin_inn_tpu.ops.pallas import coupling as JK
from sin_inn_tpu_torch.models.convert import glow_params_from_jax
from sin_inn_tpu_torch.ops.cuda import coupling as TK
from torch_port_helpers import mm1, mm3, split, tf32_rna
from torch_port_helpers import one_torch_thread  # noqa: F401

CLAMP = 1.2
HIDDEN = 256
SHAPE = (2, 16, 16)          # 512 rows: two of the Pallas kernel's tiles
CHUNK = 96                   # rows per slot here: 5 full chunks, 1 ragged


@pytest.fixture(scope="module", params=[(48, 24), (192, 96)],
                ids=["C48", "C192"])
def case(request):
    c, len1 = request.param
    len2 = c - len1
    k1, k2 = jax.random.split(jax.random.key(c))
    jp = {"s1": JS.conv_subnet_init(k1, len1, 2 * len2, 1, HIDDEN),
          "s2": JS.conv_subnet_init(k2, len2, 2 * len1, 1, HIDDEN)}
    rng = np.random.RandomState(c)
    x = rng.randn(*SHAPE, c).astype(np.float32)
    g = rng.randn(*SHAPE, c).astype(np.float32)
    tp = glow_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    refs = {}
    for inverse in (False, True):
        jfn = (JK.fused_glow_inverse_backward_1x1 if inverse
               else JK.fused_glow_backward_1x1)
        jdp, jdx = jfn(jp, jnp.asarray(x), jnp.asarray(g), CLAMP, len1,
                       interpret=True)
        refs[inverse] = (glow_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jdp)),
            torch.from_numpy(np.array(jdx)))
    return tp, torch.from_numpy(x), torch.from_numpy(g), len1, refs


def _backward(tp, x, g, len1, inverse, mm, chunk=None):
    """K3/K4 with every product taken by ``mm``; the weight products summed
    over ``chunk``-row slots in order (one slot when None)."""
    c = x.shape[-1]
    ops, dx, _ = TK._plain_rows(tp, x.reshape(-1, c), g.reshape(-1, c),
                                CLAMP, len1, inverse, mm=mm)
    m = dx.shape[0]
    step = chunk or m
    sums = None
    for r0 in range(0, m, step):
        part = [t[r0:r0 + step] for t in ops]
        a2, gz2, h2, gr2, a1, gz1, h1, gr1 = part
        slot = [mm(a2.t(), gz2), gz2.sum(0), mm(h2.t(), gr2), gr2.sum(0),
                mm(a1.t(), gz1), gz1.sum(0), mm(h1.t(), gr1), gr1.sum(0)]
        sums = slot if sums is None else [s + t for s, t in zip(sums, slot)]
    return TK._grads_to_params(*sums), dx.reshape(x.shape), ops


def _margins(dp, dx, ref, slack):
    """(worst dx error over its limit, worst leaf error over its limit),
    each error beyond the gate slack."""
    rp, rx = ref
    sp, sdx = slack
    dx_m = ((dx - rx).abs() - sdx).div(1e-4 + 1e-4 * rx.abs()).max().item()
    leaf_m = max((((a - b).abs() - s).max() / (1e-3 * b.abs().max())).item()
                 for a, b, s in zip(TK.param_leaves(dp), TK.param_leaves(rp),
                                    TK.param_leaves(sp)))
    return dx_m, leaf_m


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's step at 1.0
    # below, at and above half a step; the same mirrored
    vals = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                         -(one + 0.5 * ulp), one + 1.5 * ulp],
                        dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp),
                         one + 2 * ulp])
    assert torch.equal(tf32_rna(vals), want)
    a = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi, lo = split(a)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    # hi + lo holds a to about 2^-22 of |a|
    assert ((hi + lo - a).abs() <= 2.0 ** -21 * a.abs()).all()


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_3xtf32_chain_within_card_limits(case, inverse):
    tp, x, g, len1, refs = case
    slack = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse)
    dp, dx, _ = _backward(tp, x, g, len1, inverse, mm3, CHUNK)
    dx_m, leaf_m = _margins(dp, dx, refs[inverse], slack)
    dp1, dx1, _ = _backward(tp, x, g, len1, inverse, mm1, CHUNK)
    dx_1, leaf_1 = _margins(dp1, dx1, refs[inverse], slack)
    print(f"\nC={x.shape[-1]} {'K4' if inverse else 'K3'}: error over the "
          f"card's limit, dx / worst leaf: 3xTF32 {dx_m:.3g} / "
          f"{leaf_m:.3g}; one-pass TF32 {dx_1:.3g} / {leaf_1:.3g}")
    assert dx_m <= 1.0 and leaf_m <= 1.0


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_split_k_chunks_match_plain_sum(case, inverse):
    tp, x, g, len1, refs = case
    dp, _, ops = _backward(tp, x, g, len1, inverse, mm3, CHUNK)
    a2, gz2, h2, gr2, a1, gz1, h1, gr1 = ops
    plain = TK._grads_to_params(
        a2.t() @ gz2, gz2.sum(0), h2.t() @ gr2, gr2.sum(0),
        a1.t() @ gz1, gz1.sum(0), h1.t() @ gr1, gr1.sum(0))
    terms = TK._grads_to_params(
        a2.abs().t() @ gz2.abs(), gz2.abs().sum(0),
        h2.abs().t() @ gr2.abs(), gr2.abs().sum(0),
        a1.abs().t() @ gz1.abs(), gz1.abs().sum(0),
        h1.abs().t() @ gr1.abs(), gr1.abs().sum(0))
    for a, b, t in zip(TK.param_leaves(dp), TK.param_leaves(plain),
                       TK.param_leaves(terms)):
        assert ((a - b).abs() <= 2.0 ** -15 * t).all()
    # and the chunked sums hold the card's leaf limit against the reference
    rp, _ = refs[inverse]
    sp, _ = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse)
    for a, b, s in zip(TK.param_leaves(dp), TK.param_leaves(rp),
                       TK.param_leaves(sp)):
        assert ((a - b).abs() - s).max() <= 1e-3 * b.abs().max()


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_relu_gate_slack_covers_flipped_gates(inverse):
    """Inverting gates near 0 (one per row at most) moves the backward by no
    more than ``relu_gate_slack`` says; with tau = 0 the slack is 0."""
    c, len1 = 16, 8
    k1, k2 = jax.random.split(jax.random.key(3))
    jp = {"s1": JS.conv_subnet_init(k1, len1, 2 * (c - len1), 1, 32),
          "s2": JS.conv_subnet_init(k2, c - len1, 2 * len1, 1, 32)}
    tp = glow_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 8, 8, c).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 8, 8, c).astype(np.float32))
    tau = 0.05
    v, gg = x.reshape(-1, c), g.reshape(-1, c)
    _, dx0, (z1, z2) = TK._plain_rows(tp, v, gg, CLAMP, len1, inverse)
    # the first near gate of each row, in s1 where it has one, else s2
    flips = [torch.zeros_like(z1, dtype=torch.bool) for _ in range(2)]
    flipped = 0
    for r in range(v.shape[0]):
        for f, z in zip(flips, (z1, z2)):
            near = (z[r].abs() < tau).nonzero()
            if near.numel():
                f[r, near[0, 0]] = True
                flipped += 1
                break
    assert flipped > 10
    ops0, _, _ = TK._plain_rows(tp, v, gg, CLAMP, len1, inverse)
    ops1, dx1, _ = TK._plain_rows(tp, v, gg, CLAMP, len1, inverse,
                                  flip1=flips[0], flip2=flips[1])
    leaves = lambda o: TK.param_leaves(TK._grads_to_params(
        o[0].t() @ o[1], o[1].sum(0), o[2].t() @ o[3], o[3].sum(0),
        o[4].t() @ o[5], o[5].sum(0), o[6].t() @ o[7], o[7].sum(0)))
    sp, sdx = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse, tau=tau)
    assert ((dx1 - dx0).abs() <= sdx.reshape(-1, c) + 1e-5).all()
    assert (dx1 - dx0).abs().max() > 1e-3       # the flips did move dx
    for a, b, s in zip(leaves(ops1), leaves(ops0), TK.param_leaves(sp)):
        assert ((a - b).abs() <= s + 1e-4).all()
    sp0, sdx0 = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse, tau=0.0)
    assert not sdx0.any()
    assert not any(t.any() for t in TK.param_leaves(sp0))


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_relu_gate_slack_keeps_to_the_gates_set_otherwise(inverse):
    """With ``gates`` (another route's relu gates) the slack covers just the
    gates within tau of 0 that route sets otherwise than the plain chain:
    none when it sets them all alike, those alone when it inverts some (a
    part of the bound over every gate within tau), and nothing for a gate
    it inverts beyond tau, which the checks then see whole."""
    c, len1 = 16, 8
    k1, k2 = jax.random.split(jax.random.key(4))
    jp = {"s1": JS.conv_subnet_init(k1, len1, 2 * (c - len1), 1, 32),
          "s2": JS.conv_subnet_init(k2, c - len1, 2 * len1, 1, 32)}
    tp = glow_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 8, 8, c).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 8, 8, c).astype(np.float32))
    tau = 0.05
    _, _, (z1, z2) = TK._plain_rows(tp, x.reshape(-1, c), g.reshape(-1, c),
                                    CLAMP, len1, inverse)
    same = (z1 > 0, z2 > 0)
    sp, sdx = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse, same, tau)
    assert not sdx.any() and not any(t.any() for t in TK.param_leaves(sp))
    # invert every other near gate of s1 and s2, and a far one of s1
    near = [(z.abs() < tau) for z in (z1, z2)]
    picked = []
    for n in near:
        keep = torch.zeros_like(n)
        idx = n.nonzero()[::2]
        keep[idx[:, 0], idx[:, 1]] = True
        picked.append(keep)
    assert sum(int(k.sum()) for k in picked) > 5
    far = (z1.abs() > 1.0).nonzero()[0]
    other = [s ^ k for s, k in zip(same, picked)]
    other[0][far[0], far[1]] ^= True
    got = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse, other, tau)
    # the far gate adds nothing to the near ones' bound
    want = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse,
                              [s ^ k for s, k in zip(same, picked)], tau)
    every = TK.relu_gate_slack(tp, x, g, CLAMP, len1, inverse, tau=tau)
    assert torch.equal(got[1], want[1]) and got[1].any()
    for a, b, e in zip(TK.param_leaves(got[0]), TK.param_leaves(want[0]),
                       TK.param_leaves(every[0])):
        assert torch.equal(a, b)
        assert (a <= e + 1e-6).all()
    assert (got[1] <= every[1] + 1e-6).all()
    assert got[1].sum() < every[1].sum()
