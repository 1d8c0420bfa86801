"""K8's tensor-core arithmetic (3xTF32) modelled on the CPU and held against
the JAX package's Pallas K8 in interpret mode.

``csrc/coupling_3x3.cu`` and ``csrc/coupling_3x3_bwd.cu`` run every product
of K8 as an implicit GEMM on the tensor cores: each fp32 operand a is split
into hi = tf32(a) (``cvt.rna``) and lo = tf32(a - hi), a b is taken as lo hi
+ hi lo + hi hi, and every run of at most 4 k-steps (12 mma, one 32-row
weight slice) sums from 0 and is added to the running fp32 sum. Here that
is modelled in plain PyTorch (``split`` / ``mm3`` of
``tests/torch_port_helpers.py``) in the kernels' order:

* conv1: im2col of x_in (Cin padded to 8 with zeros) in (tap, channel)
  order, K = 9 Cin8 in 32-row runs; h = relu(z + b1) at image pixels, 0
  outside (conv2's zero padding);
* conv2: the hidden width in chunks of 32 channels, each chunk tap by tap
  (a 32-row run each), added in that order; then the affine step in fp32;
* the VJP's stages 2-3: gz = conv3x3(gr, W2t) gated by h > 0 and dx_in =
  conv3x3(gz, W1t), their inputs in 32-channel chunks, each chunk tap by
  tap; W2t, W1t the flipped, transposed kernels;
* stage 4: [dW1 | db1] = im2col(x_in)^T gz and [dW2 | db2] = im2col(h)^T gr
  as split-K sums over chunks of pixels, each chunk in 32-pixel runs, the
  slots added in chunk order (the biases: plain column sums).

Inputs come from numpy seeds at the SRF flagship's channel widths, Cin 24 /
Caff 24 and Cin 96 / Caff 96, hidden 256, on a 1 x 5 x 18 crop (an odd
height and width: every border rule of the 8-row tiles and of the TPU's
8-row bands is reached), both flags.

What is not modelled: how the tensor cores add inside an mma (truncation);
the card tests (``tests/test_torch_port_cuda.py``) and ``chip_smoke.py``
phase 12 hold the kernels' own sums to the same limits.

Tolerances, each with its reason (the card's limits, ``chip_smoke.py``):
* forward, both flags: 1e-4 + 1e-4 |ref| elementwise, and the normwise gate
  ||y - ref|| <= 1e-5 ||ref||, the value the card gates with. 3xTF32 keeps
  about 2^-21 of each product: on these inputs it lands at 0.9-1.1e-7
  normwise (1% of the gate) and uses 0.2-0.4% of the elementwise limit;
  one-pass TF32 (hi hi alone, 2^-11) lands at 0.96-1.04e-4 normwise, some
  ten times the gate, and at 2.8-3.5 times the elementwise limit;
* backward: dx_in within 1e-4 + 1e-4 |ref| plus ``relu_gate_slack`` (a
  conv1 pre-activation within 1e-5 of 0 may be gated either way), dx_aff
  within the same without it, each weight and bias leaf within 1e-3 of its
  largest |ref| plus the slack on conv1's;
* the chunked weight sums against the plain fp32 sum of the same operands:
  2^-15 of the sum of the absolute terms (two fp32 sums over 90 pixels in
  other orders, 3xTF32's 2^-21 a product beside it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sin_inn_tpu.ops.pallas import coupling3x3 as JK
from sin_inn_tpu_torch.models.convert import glow_params_from_jax
from sin_inn_tpu_torch.ops.coupling import glow_log_e
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
from torch_port_helpers import mm1, mm3
from torch_port_helpers import one_torch_thread  # noqa: F401

CLAMP = 1.2
HIDDEN = 256
SHAPE = (1, 5, 18)           # an odd crop: 90 pixels
CHUNK = 64                   # pixels a gradient slot here: one full, one not
NORMWISE = 1e-5              # the forward's normwise gate (card and here)


def _up(v, m):
    return -(-v // m) * m


def _np_sub(cin, caff, seed):
    """One subnet's HWIO params, torch-default uniform bounds."""
    rng = np.random.RandomState(seed)

    def conv(ci, co):
        bound = 1.0 / np.sqrt(ci * 9)
        return {"w": rng.uniform(-bound, bound, (3, 3, ci, co))
                .astype(np.float32),
                "b": rng.uniform(-bound, bound, co).astype(np.float32)}
    return {"conv1": conv(cin, HIDDEN), "conv2": conv(HIDDEN, 2 * caff)}


def _torch_sub(jsub):
    return glow_params_from_jax({"s1": jsub, "s2": jsub})["s2"]


def _jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


@pytest.fixture(scope="module", params=[(24, 24), (96, 96)],
                ids=["Cin24", "Cin96"])
def case(request):
    cin, caff = request.param
    jsub = _np_sub(cin, caff, seed=cin)
    rng = np.random.RandomState(cin + 1)
    x_in = rng.randn(*SHAPE, cin).astype(np.float32)
    x_aff = rng.randn(*SHAPE, caff).astype(np.float32)
    g = rng.randn(*SHAPE, caff).astype(np.float32)
    refs = {}
    for inverse in (False, True):
        y = JK.half_coupling_3x3(_jtree(jsub), jnp.asarray(x_in),
                                 jnp.asarray(x_aff), CLAMP, inverse,
                                 interpret=True)
        jd, jdx_in, jdx_aff = JK._half_banded_bwd(
            _jtree(jsub), jnp.asarray(x_in), jnp.asarray(x_aff),
            jnp.asarray(g), CLAMP, inverse, interpret=True)
        dsub = {c: {"w": torch.from_numpy(np.array(jd[c]["w"]))
                    .permute(3, 2, 0, 1).contiguous(),
                    "b": torch.from_numpy(np.array(jd[c]["b"]))}
                for c in ("conv1", "conv2")}
        refs[inverse] = (torch.from_numpy(np.array(y)), dsub,
                         torch.from_numpy(np.array(jdx_in)),
                         torch.from_numpy(np.array(jdx_aff)))
    return (_torch_sub(jsub), torch.from_numpy(x_in),
            torch.from_numpy(x_aff), torch.from_numpy(g), refs)


# ---- the kernels' arithmetic ----


def _im2col(x):
    """(N, H, W, C) -> (N H W, 9 C), column tap C + c (tap = 3 dy + dx),
    zero padded: the A operand the kernels read by address."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], -1).reshape(-1, 9 * c)


def _pad_c(x, c):
    return F.pad(x, (0, c - x.shape[-1]))


def _operand(w, rows_pad, cols_pad, flip):
    """The packed (9 rows_pad, cols_pad) weight operand of an OIHW 3x3
    weight: B[tap rp + i][o] = w[o][i][tap], or flipped and transposed,
    B[tap rp + o][i] = w[o][i][8 - tap]."""
    wk = (w.flip(2, 3).permute(2, 3, 0, 1) if flip
          else w.permute(2, 3, 1, 0))                    # (3, 3, rows, cols)
    wk = F.pad(wk, (0, cols_pad - wk.shape[3], 0, rows_pad - wk.shape[2]))
    return wk.reshape(9 * rows_pad, cols_pad)


def _runs(a, b, slices, mm):
    """sum over the 32-row runs `slices` of K, in that order, each taken
    from 0 by ``mm``."""
    acc = None
    for s in slices:
        t = mm(a[:, s], b[s])
        acc = t if acc is None else acc + t
    return acc


def _conv_chunked(x, b, cp, mm):
    """A 3x3 convolution of x (channels padded to cp, a multiple of 32) with
    the operand b (9 cp rows): 32-channel chunks, each chunk tap by tap."""
    a = _im2col(_pad_c(x, cp))
    slices = [slice(tap * cp + 32 * c, tap * cp + 32 * c + 32)
              for c in range(cp // 32) for tap in range(9)]
    return _runs(a, b, slices, mm)


def _forward_model(sub, x_in, x_aff, inverse, mm):
    """The fused kernel's arithmetic: (z, h, s, t, y) at image pixels."""
    n, hh, ww, cin = x_in.shape
    caff = x_aff.shape[-1]
    cin8, hp = _up(cin, 8), _up(HIDDEN, 32)
    w1, b1 = sub["conv1"]["w"], sub["conv1"]["b"]
    w2, b2 = sub["conv2"]["w"], sub["conv2"]["b"]
    a1 = _im2col(_pad_c(x_in, cin8))
    k1 = 9 * cin8
    z = _runs(a1, _operand(w1, cin8, hp, False),
              [slice(k, min(k + 32, k1)) for k in range(0, k1, 32)], mm)
    z = z[:, :HIDDEN] + b1
    h = torch.relu(z)
    r = _conv_chunked(h.reshape(n, hh, ww, HIDDEN),
                      _operand(w2, hp, 2 * caff, False), hp, mm) + b2
    s, t = r[:, :caff], r[:, caff:]
    xa = x_aff.reshape(-1, caff)
    le = glow_log_e(s, CLAMP)
    y = (xa - t) * torch.exp(-le) if inverse else torch.exp(le) * xa + t
    return z, h, s, t, y.reshape(x_aff.shape)


def _backward_model(sub, x_in, x_aff, g, inverse, mm, chunk=CHUNK):
    """The VJP's stages 1-4 and the slot sums: (dsub, dx_in, dx_aff, ops),
    ops = (U1, gz, U2, gr) of the weight products."""
    n, hh, ww, cin = x_in.shape
    caff = x_aff.shape[-1]
    hp, grp = _up(HIDDEN, 32), _up(2 * caff, 32)
    w1, w2 = sub["conv1"]["w"], sub["conv2"]["w"]
    z, h, s, t, _ = _forward_model(sub, x_in, x_aff, inverse, mm)
    xa, gg = x_aff.reshape(-1, caff), g.reshape(-1, caff)
    le = glow_log_e(s, CLAMP)
    lp = K._log_e_prime(s, CLAMP)
    if inverse:
        einv = torch.exp(-le)
        gs, gt, dx_aff = -gg * ((xa - t) * einv) * lp, -gg * einv, gg * einv
    else:
        e = torch.exp(le)
        gs, gt, dx_aff = gg * xa * e * lp, gg, gg * e
    gr = torch.cat([gs, gt], -1)
    gh = _conv_chunked(gr.reshape(n, hh, ww, 2 * caff),
                       _operand(w2, grp, hp, True), grp, mm)[:, :HIDDEN]
    gz = torch.where(h > 0, gh, 0.0)
    dx_in = _conv_chunked(gz.reshape(n, hh, ww, HIDDEN),
                          _operand(w1, hp, cin, True), hp, mm)
    u1 = _im2col(x_in)
    u2 = _im2col(h.reshape(n, hh, ww, HIDDEN))
    sums = None
    m = u1.shape[0]
    for c0 in range(0, m, chunk):
        slot = []
        for u, v in ((u1, gz), (u2, gr)):
            stages = [slice(r, min(r + 32, c0 + chunk, m))
                      for r in range(c0, min(c0 + chunk, m), 32)]
            slot += [_runs(u.t(), v, stages, mm),
                     v[c0:c0 + chunk].sum(0)]
        sums = slot if sums is None else [a + b for a, b in zip(sums, slot)]
    oihw = lambda v, ci: v.view(3, 3, ci, -1).permute(3, 2, 0, 1)
    dsub = {"conv1": {"w": oihw(sums[0], cin), "b": sums[1]},
            "conv2": {"w": oihw(sums[2], HIDDEN), "b": sums[3]}}
    return (dsub, dx_in.reshape(x_in.shape), dx_aff.reshape(x_aff.shape),
            (u1, gz, u2, gr))


def _leaves(d):
    return [d[c][k] for c in ("conv1", "conv2") for k in ("w", "b")]


def _flat(d):
    """The leaves in the products' layout: weights (9 cin, cout)."""
    return [v.permute(2, 3, 1, 0).reshape(-1, v.shape[0]) if v.dim() == 4
            else v for v in _leaves(d)]


def _shares(dsub, dx_in, dx_aff, ref, slack):
    """The share of each card limit the model's error uses: dx_in, dx_aff,
    and the worst leaf (each error beyond its gate slack)."""
    _, rd, rdx_in, rdx_aff = ref
    sdx, sw1, sb1 = slack
    share = lambda a, b, sl: ((a - b).abs() - sl).div(
        1e-4 + 1e-4 * b.abs()).max().item()
    leaf = max((((a - b).abs() - sl).max() / (1e-3 * b.abs().max())).item()
               for a, b, sl in zip(_leaves(dsub), _leaves(rd),
                                   (sw1, sb1, 0.0, 0.0)))
    return share(dx_in, rdx_in, sdx), share(dx_aff, rdx_aff, 0.0), leaf


# ---- the tests ----


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_3xtf32_forward_within_card_limits(case, inverse):
    sub, x_in, x_aff, _, refs = case
    ref = refs[inverse][0]
    y = _forward_model(sub, x_in, x_aff, inverse, mm3)[-1]
    y1 = _forward_model(sub, x_in, x_aff, inverse, mm1)[-1]
    elem = lambda v: ((v - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max()
    norm = lambda v: ((v - ref).norm() / ref.norm()).item()
    print(f"\nCin={x_in.shape[-1]} inverse={inverse}: share of 1e-4 + "
          f"1e-4|ref| used: 3xTF32 {elem(y):.3g}, one-pass TF32 "
          f"{elem(y1):.3g}; normwise error (gate {NORMWISE:g}): 3xTF32 "
          f"{norm(y):.3g}, one-pass TF32 {norm(y1):.3g}")
    assert elem(y) <= 1.0
    assert norm(y) <= NORMWISE


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_one_pass_tf32_fails_the_normwise_gate(case, inverse):
    """The gate fails one-pass TF32 by a margin of over 5 and passes
    3xTF32 by one of over 10."""
    sub, x_in, x_aff, _, refs = case
    ref = refs[inverse][0]
    norm = lambda mm: ((_forward_model(sub, x_in, x_aff, inverse, mm)[-1]
                        - ref).norm() / ref.norm()).item()
    assert norm(mm1) > 5 * NORMWISE
    assert norm(mm3) < NORMWISE / 10


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_3xtf32_backward_within_card_limits(case, inverse):
    sub, x_in, x_aff, g, refs = case
    slack = K8.relu_gate_slack(sub, x_in, x_aff, g, CLAMP, inverse)
    got = _backward_model(sub, x_in, x_aff, g, inverse, mm3)
    one = _backward_model(sub, x_in, x_aff, g, inverse, mm1)
    s3 = _shares(*got[:3], refs[inverse], slack)
    s1 = _shares(*one[:3], refs[inverse], slack)
    print(f"\nCin={x_in.shape[-1]} inverse={inverse}: share of the card's "
          f"limit used, dx_in / dx_aff / worst leaf: 3xTF32 "
          f"{s3[0]:.3g} / {s3[1]:.3g} / {s3[2]:.3g}; one-pass TF32 "
          f"{s1[0]:.3g} / {s1[1]:.3g} / {s1[2]:.3g}")
    assert max(s3) <= 1.0


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_split_k_chunks_match_plain_sum(case, inverse):
    sub, x_in, x_aff, g, _ = case
    dsub, _, _, (u1, gz, u2, gr) = _backward_model(sub, x_in, x_aff, g,
                                                   inverse, mm3)
    plain = [u1.t() @ gz, gz.sum(0), u2.t() @ gr, gr.sum(0)]
    terms = [u1.abs().t() @ gz.abs(), gz.abs().sum(0),
             u2.abs().t() @ gr.abs(), gr.abs().sum(0)]
    for a, b, t in zip(_flat(dsub), plain, terms):
        assert ((a - b).abs() <= 2.0 ** -15 * t).all()
    # one slot, or one slot a 32-pixel run, gives the same sums as well
    for chunk in (32, 96):
        other = _backward_model(sub, x_in, x_aff, g, inverse, mm3, chunk)[0]
        for a, b, t in zip(_flat(other), _flat(dsub), terms):
            assert ((a - b).abs() <= 2.0 ** -15 * t).all()


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_relu_gate_slack_covers_the_gates_3xtf32_sets_otherwise(case,
                                                                 inverse):
    """Conv1 biases shifted so that one pre-activation of each hidden channel
    sits within 1e-7 of 0:
    the 3xTF32 recompute may set those gates otherwise than the plain fp32
    version, and every gate it sets otherwise is within relu_gate_slack's
    1e-5 of 0, so the slack covers it and the backward holds the card's
    limits against the plain backward."""
    sub, x_in, x_aff, g, _ = case
    z = K8._conv3x3(x_in, sub["conv1"]["w"], sub["conv1"]["b"]).reshape(
        -1, HIDDEN)
    rng = np.random.RandomState(5)
    pix = torch.from_numpy(rng.randint(0, z.shape[0], HIDDEN))
    b1 = sub["conv1"]["b"] - z[pix, torch.arange(HIDDEN)] + torch.from_numpy(
        rng.uniform(-1e-7, 1e-7, HIDDEN).astype(np.float32))
    near = {"conv1": {"w": sub["conv1"]["w"], "b": b1}, "conv2": sub["conv2"]}
    zp = K8._conv3x3(x_in, near["conv1"]["w"], b1).reshape(-1, HIDDEN)
    assert (zp.abs() < 1e-6).sum() >= HIDDEN
    zm = _forward_model(near, x_in, x_aff, inverse, mm3)[0]
    other = (zm > 0) != (zp > 0)
    print(f"\nCin={x_in.shape[-1]}: {int(other.sum())} of "
          f"{int((zp.abs() < 1e-5).sum())} gates within 1e-5 of 0 set "
          f"otherwise by the 3xTF32 recompute")
    assert (zp[other].abs() < 1e-5).all()
    slack = K8.relu_gate_slack(near, x_in, x_aff, g, CLAMP, inverse)
    plain = K8.half_coupling_3x3_backward_plain(near, x_in, x_aff, g, CLAMP,
                                                inverse)
    got = _backward_model(near, x_in, x_aff, g, inverse, mm3)
    assert max(_shares(*got[:3], (None, *plain), slack)) <= 1.0
