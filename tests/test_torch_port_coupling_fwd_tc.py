"""K1/K2's tensor-core arithmetic (3xTF32) modelled on the CPU and held
against the JAX package's Pallas forward and inverse kernels in interpret
mode.

``csrc/coupling_1x1.cu`` takes every product of K1 and K2 on the tensor
cores: each fp32 operand a is split into hi = tf32(a) (``cvt.rna``) and lo
= tf32(a - hi), and a b is taken as lo hi + hi lo + hi hi, summed in fp32.
Here every product of the fused chain (``ops/cuda/coupling.py`` ``_plain``:
x2 -> h2 -> r2 -> y1 -> h1 -> r1 -> y2, and the mirrored inverse) goes
through that split, emulated in plain PyTorch (``mm3`` of
``tests/torch_port_helpers.py``). Inputs and weights come from numpy seeds
at the SRF flagship's widths, C = 48 and C = 192 with hidden 256 over 512
rows, and at the uneven split 12 = 5 + 7 with hidden 32.

What is not modelled: how the tensor cores add (each mma adds with
truncation; the kernel starts every run of at most 12 mma from 0 and adds
it in fp32), nor the kernel's tiling. The card tests
(``tests/test_torch_port_cuda.py``) and ``chip_smoke.py`` hold the kernel
itself to the same limits.

Tolerances, the card's: the output within 1e-4 + 1e-4 |ref| of the Pallas
kernel (fp32 sums in another order, ``atanf`` against the TPU's
Abramowitz-Stegun polynomial), and inverse(forward) within 1e-4 of the
input. One-pass TF32 (hi hi alone) is only printed, as a margin against the
same limit: it is not what the kernel does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops.pallas import coupling as JK
from sin_inn_tpu_torch.models.convert import glow_params_from_jax
from sin_inn_tpu_torch.ops.cuda import coupling as TK
from torch_port_helpers import mm1, mm3
from torch_port_helpers import one_torch_thread  # noqa: F401

CLAMP = 1.2
SHAPE = (2, 16, 16)          # 512 rows: two of the Pallas kernel's tiles


def _np_coupling(c, len1, hidden, seed):
    """A 1x1 GLOW coupling's HWIO params from numpy (torch-default uniform
    bounds), in the JAX package's layout."""
    rng = np.random.RandomState(seed)

    def conv(cin, cout):
        bound = 1.0 / np.sqrt(cin)
        return {"w": rng.uniform(-bound, bound, (1, 1, cin, cout))
                .astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    len2 = c - len1
    return {"s1": {"conv1": conv(len1, hidden),
                   "conv2": conv(hidden, 2 * len2)},
            "s2": {"conv1": conv(len2, hidden),
                   "conv2": conv(hidden, 2 * len1)}}


@pytest.fixture(scope="module", params=[(48, 24, 256), (192, 96, 256),
                                        (12, 5, 32)],
                ids=["C48", "C192", "C12-split5"])
def case(request):
    c, len1, hidden = request.param
    npp = _np_coupling(c, len1, hidden, seed=c + len1)
    jp = {s: {k: {n: jnp.asarray(v) for n, v in conv.items()}
              for k, conv in sub.items()} for s, sub in npp.items()}
    x = np.random.RandomState(c).randn(*SHAPE, c).astype(np.float32)
    y = np.array(JK.fused_glow_forward_1x1(jp, jnp.asarray(x), CLAMP, len1,
                                           interpret=True))
    x_back = np.array(JK.fused_glow_inverse_1x1(jp, jnp.asarray(y), CLAMP,
                                                len1, interpret=True))
    refs = {False: (torch.from_numpy(x), torch.from_numpy(y)),
            True: (torch.from_numpy(y), torch.from_numpy(x_back))}
    return glow_params_from_jax(npp), len1, refs


def _use(got, ref):
    """The largest error over the card's limit 1e-4 + 1e-4 |ref|."""
    return ((got - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max().item()


@pytest.mark.parametrize("inverse", [False, True], ids=["K1", "K2"])
def test_3xtf32_chain_within_card_limits(case, inverse):
    tp, len1, refs = case
    inp, ref = refs[inverse]
    got = TK._plain(tp, inp, CLAMP, len1, inverse, mm=mm3)
    one = TK._plain(tp, inp, CLAMP, len1, inverse, mm=mm1)
    use3, use1 = _use(got, ref), _use(one, ref)
    print(f"\nC={inp.shape[-1]} {'K2' if inverse else 'K1'}: error over "
          f"the card's limit: 3xTF32 {use3:.3g}, one-pass TF32 {use1:.3g}")
    assert torch.isfinite(got).all()
    assert use3 <= 1.0


def test_3xtf32_round_trip(case):
    tp, len1, refs = case
    x, _ = refs[False]
    y = TK._plain(tp, x, CLAMP, len1, False, mm=mm3)
    back = TK._plain(tp, y, CLAMP, len1, True, mm=mm3)
    assert (back - x).abs().max().item() <= 1e-4
