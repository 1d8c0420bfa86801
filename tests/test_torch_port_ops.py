"""PyTorch port ops held against the JAX package on the same numpy inputs.

Squeeze, permutation, GLOW coupling (forward, inverse, inverse with log-det),
the subnet compute modes, the losses, and the plain versions of the fused
1x1 coupling kernels against the Pallas kernels run in interpret mode. The
CUDA kernels themselves run only on the card (chip_smoke.py and
tests/test_torch_port_cuda.py); here a CPU tensor takes the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops import coupling as JC
from sin_inn_tpu.ops import losses as JL
from sin_inn_tpu.ops import permute as JP
from sin_inn_tpu.ops import squeeze as JSQ
from sin_inn_tpu.ops import subnet as JS
from sin_inn_tpu.ops.pallas import coupling as JK
from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.models.convert import glow_params_from_jax
from sin_inn_tpu_torch.ops import coupling as TC
from sin_inn_tpu_torch.ops import losses as TL
from sin_inn_tpu_torch.ops import permute as TP
from sin_inn_tpu_torch.ops import squeeze as TSQ
from sin_inn_tpu_torch.ops import subnet as TS
from sin_inn_tpu_torch.ops.cuda import coupling as TK
from torch_port_helpers import one_torch_thread  # noqa: F401

CLAMP = 1.2


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _glow_setup(rng, c, len1, kernel, hidden, shape=(2, 6, 10)):
    """JAX params for one coupling, the port's copy, and a numpy input."""
    k1, k2 = jax.random.split(jax.random.key(3))
    len2 = c - len1
    jp = {"s1": JS.conv_subnet_init(k1, len1, 2 * len2, kernel, hidden),
          "s2": JS.conv_subnet_init(k2, len2, 2 * len1, kernel, hidden)}
    x = rng.randn(*shape, c).astype(np.float32)
    return jp, glow_params_from_jax(jax.tree_util.tree_map(np.asarray, jp)), x


def test_squeeze_matches_jax_and_inverts(rng):
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    y = TSQ.space_to_depth(_t(x))
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(JSQ.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(TSQ.depth_to_space(y).numpy(), x)
    with pytest.raises(ValueError):
        TSQ.space_to_depth(torch.zeros(1, 3, 4, 2))


@pytest.mark.parametrize("channels,seed", [(12, 0), (48, 1), (192, 3)])
def test_permutation_matches_jax(rng, channels, seed):
    perm = TP.make_permutation(channels, seed)
    np.testing.assert_array_equal(perm, JP.make_permutation(channels, seed))
    inv = TP.invert_permutation(perm)
    np.testing.assert_array_equal(inv, JP.invert_permutation(perm))
    x = rng.randn(2, 3, 4, channels).astype(np.float32)
    y = TP.permute_channels(_t(x), perm)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(JP.permute_channels(jnp.asarray(x), perm)))
    np.testing.assert_array_equal(TP.permute_channels(y, inv).numpy(), x)


@pytest.mark.parametrize("kernel", [1, 3])
def test_glow_coupling_matches_jax(rng, kernel):
    """Forward (with log-det), inverse and inverse_ld; fp32 on both sides,
    sums in another order: atol/rtol 1e-5."""
    jp, tp, x = _glow_setup(rng, 12, 6, kernel, 16)
    jy, jld = JC.glow_coupling_forward(jp, jnp.asarray(x), JS.conv_subnet_apply,
                                       CLAMP, 6)
    ty, tld = TC.glow_coupling_forward(tp, _t(x), TS.conv_subnet_apply,
                                       CLAMP, 6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-4,
                               rtol=1e-5)
    jx, jild = JC.glow_coupling_inverse_ld(jp, jy, JS.conv_subnet_apply,
                                           CLAMP, 6)
    tx, tild = TC.glow_coupling_inverse_ld(tp, _t(np.asarray(jy)),
                                           TS.conv_subnet_apply, CLAMP, 6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tild.numpy(), np.asarray(jild), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(
        TC.glow_coupling_inverse(tp, ty, TS.conv_subnet_apply, CLAMP, 6).numpy(),
        x, atol=1e-5)


@pytest.mark.parametrize("mode,jmode,tol", [
    ("float32", None, 1e-5),
    ("float32_highest", "highest", 1e-5),
    # bf16 inputs on both sides; the two frameworks round at other places
    ("bfloat16", jnp.bfloat16, 5e-2),
])
def test_conv_compute_modes_match_jax(rng, mode, jmode, tol):
    jp, tp, x = _glow_setup(rng, 12, 6, 3, 16)
    w, b = jp["s1"]["conv1"]["w"], jp["s1"]["conv1"]["b"]
    xin = x[..., :6]
    jo = JS.conv2d(jnp.asarray(xin), w, b, compute_dtype=jmode)
    to = TS.conv2d(_t(xin), tp["s1"]["conv1"]["w"], tp["s1"]["conv1"]["b"],
                   TS.compute_mode(mode))
    assert to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=tol, rtol=tol)


def test_conv_highest_leaves_global_tf32_flag():
    before = torch.backends.cudnn.allow_tf32
    TS.conv2d(torch.randn(1, 4, 4, 2), torch.randn(3, 2, 3, 3), None,
              "highest")
    assert torch.backends.cudnn.allow_tf32 == before


def test_subnet_init_is_torch_default_uniform():
    gen = R.root_generator(0)
    p = TS.conv_subnet_init(gen, 6, 10, 3, hidden=16)
    assert tuple(p["conv1"]["w"].shape) == (16, 6, 3, 3)
    assert tuple(p["conv2"]["w"].shape) == (10, 16, 3, 3)
    for conv, fan_in in (("conv1", 6 * 9), ("conv2", 16 * 9)):
        bound = 1.0 / np.sqrt(fan_in)
        for t in p[conv].values():
            assert float(t.abs().max()) <= bound
    again = TS.conv_subnet_init(R.root_generator(0), 6, 10, 3, hidden=16)
    assert torch.equal(again["conv1"]["w"], p["conv1"]["w"])


def test_named_folds_are_stable_and_independent():
    root = R.root_generator(5)
    a = torch.rand(4, generator=R.named_fold(root, "init"))
    b = torch.rand(4, generator=R.named_fold(R.root_generator(5), "init"))
    c = torch.rand(4, generator=R.named_fold(root, "infer"))
    d = torch.rand(4, generator=R.step_fold(root, 1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_losses_match_jax(rng):
    x = rng.rand(2, 4, 4, 3).astype(np.float32)
    y = rng.rand(2, 4, 4, 3).astype(np.float32)
    for tf, jf in ((TL.reconstruction, JL.reconstruction),
                   (TL.psnr, JL.psnr)):
        np.testing.assert_allclose(float(tf(_t(x), _t(y))),
                                   float(jf(jnp.asarray(x), jnp.asarray(y))),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(TL.latent_nll(_t(x))),
                               float(JL.latent_nll(jnp.asarray(x))), rtol=1e-5)


# -- the fused 1x1 coupling: plain versions against the Pallas kernels -------

@pytest.fixture
def fused_setup(rng):
    # C=16, len1=8, hidden 32; 3*7*13 = 273 rows, not a multiple of the
    # Pallas kernel's 256-row tile
    return _glow_setup(rng, 16, 8, 1, 32, shape=(3, 7, 13))


def test_fused_forward_plain_matches_pallas(fused_setup):
    jp, tp, x = fused_setup
    ref = JK.fused_glow_forward_1x1(jp, jnp.asarray(x), CLAMP, 8,
                                    interpret=True)
    got = TK.fused_glow_forward_1x1_plain(tp, _t(x), CLAMP, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_fused_inverse_plain_matches_pallas(fused_setup):
    jp, tp, x = fused_setup
    ref = JK.fused_glow_inverse_1x1(jp, jnp.asarray(x), CLAMP, 8,
                                    interpret=True)
    got = TK.fused_glow_inverse_1x1_plain(tp, _t(x), CLAMP, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_fused_plain_round_trip(fused_setup):
    _, tp, x = fused_setup
    y = TK.fused_glow_forward_1x1_plain(tp, _t(x), CLAMP, 8)
    back = TK.fused_glow_inverse_1x1_plain(tp, y, CLAMP, 8)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


def test_fused_plain_matches_conv_coupling(fused_setup):
    _, tp, x = fused_setup
    ref, _ = TC.glow_coupling_forward(tp, _t(x), TS.conv_subnet_apply, CLAMP, 8)
    got = TK.fused_glow_forward_1x1_plain(tp, _t(x), CLAMP, 8)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_cuda_wrapper_takes_plain_version_on_cpu(fused_setup):
    _, tp, x = fused_setup
    TK.reset_launch_counts()
    for wrapper, plain in ((TK.fused_glow_forward_1x1,
                            TK.fused_glow_forward_1x1_plain),
                           (TK.fused_glow_inverse_1x1,
                            TK.fused_glow_inverse_1x1_plain)):
        assert torch.equal(wrapper(tp, _t(x), CLAMP, 8),
                           plain(tp, _t(x), CLAMP, 8))
    # CPU calls never reach a kernel, so nothing is counted
    counts = TK.launch_counts()
    assert counts["fused_glow_forward_1x1"] == 0
    assert counts["fused_glow_inverse_1x1"] == 0


def test_cuda_wrapper_rejects_bad_split_and_weights(fused_setup):
    _, tp, x = fused_setup
    with pytest.raises(ValueError):
        TK.fused_glow_forward_1x1(tp, _t(x), CLAMP, 16)
    with pytest.raises(ValueError):
        TK.fused_glow_inverse_1x1(tp, _t(x[..., :12]), CLAMP, 6)
