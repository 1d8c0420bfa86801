"""The port's SRF INN held against the JAX package's, layer for layer.

Params are drawn with numpy in the JAX layout and carried over with
``params_from_jax``. Tolerance
atol 1e-4: fp32 convolutions summed in another order, then amplified by up
to e^1.2 per coupling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.models import inn as JI
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import params_from_jax
from sin_inn_tpu_torch.ops.cuda import coupling as TK
from torch_port_helpers import np_params
from torch_port_helpers import one_torch_thread  # noqa: F401

TINY = [
    dict(scale=2, lr_window=1, num_coupling=2, hidden_channels=16),
    dict(scale=4, lr_window=1, num_coupling=2, hidden_channels=16),
]


def _jax_apply(spec, params, x, **kw):
    """The JAX INN, jitted: one compile instead of one per eager op."""
    fn = jax.jit(lambda p, v: JI.inn_apply(spec, p, v, **kw))
    return fn(params, x)


def _models(kw, use_kernel="auto", compute="float32"):
    jcfg = JaxSRConfig(**kw, compute_dtype=compute)
    tcfg = SRConfig(**kw, compute_dtype=compute, use_kernel=use_kernel,
                    device="cpu")
    jspec, _ = JI.build_inn_spec(jcfg)
    tspec, _ = TI.build_inn_spec(tcfg)
    jparams = np_params(jspec)
    tparams = params_from_jax(tspec, jparams)
    return tcfg, jspec, jparams, tspec, tparams


def _hr(rng, cfg):
    side = 2 ** cfg.num_squeezes * 2
    return rng.rand(2, side, side, 3).astype(np.float32)


@pytest.mark.parametrize("kw", TINY)
@pytest.mark.parametrize("compute", ["float32", "float32_highest"])
def test_srf_spec_matches_jax(kw, compute):
    # JAX resolves its kernel flag from the platform; pin it to "on" to
    # compare the routing rule alone
    jspec, jc = JI.build_inn_spec(JaxSRConfig(**kw, compute_dtype=compute,
                                              use_pallas="on"))
    tspec, tc = TI.build_inn_spec(SRConfig(**kw, compute_dtype=compute,
                                           device="cpu"))
    assert tc == jc
    assert len(tspec) == len(jspec)
    for t, j in zip(tspec, jspec):
        assert (t.kind, t.clamp, t.split_len1, t.kernel, t.hidden, t.perm,
                t.perm_inv, t.compute) == (
                    j.kind, j.clamp, j.split_len1, j.kernel, j.hidden, j.perm,
                    j.perm_inv, j.compute)
        if t.kind == "glow":
            # the port never routes float32_highest through the kernels
            assert t.use_kernel == (compute != "float32_highest")


def test_irn_not_ported_yet():
    """IRN came with its slice: the spec builds at the flagship widths and
    matches the JAX package's layer for layer."""
    jspec, jc = JI.build_inn_spec(JaxSRConfig(architecture="IRN"))
    tspec, tc = TI.build_inn_spec(SRConfig(architecture="IRN", device="cpu"))
    assert tc == jc == 192
    assert [(l.kind, l.clamp, l.split_len1, l.gc) for l in tspec] == \
        [(l.kind, l.clamp, l.split_len1, l.gc) for l in jspec]


def test_kernel_off_routes_no_coupling():
    spec, _ = TI.build_inn_spec(SRConfig(**TINY[0], use_kernel="off",
                                         device="cpu"))
    assert not any(l.use_kernel for l in spec)


@pytest.mark.parametrize("kw", TINY)
@pytest.mark.parametrize("use_kernel", ["auto", "off"])
def test_inn_apply_matches_jax(rng, kw, use_kernel):
    cfg, jspec, jparams, tspec, tparams = _models(kw, use_kernel)
    x = _hr(rng, cfg)
    jy = _jax_apply(jspec, jparams, jnp.asarray(x))
    ty = TI.inn_apply(tspec, tparams, torch.from_numpy(x))
    assert ty.shape[-1] == cfg.total_dims
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    jx = _jax_apply(jspec, jparams, jy, rev=True)
    tx = TI.inn_apply(tspec, tparams, torch.from_numpy(np.array(jy)),
                      rev=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(tx.numpy(), x, atol=1e-4)


@pytest.mark.parametrize("kw", TINY)
def test_inn_apply_log_det_matches_jax(rng, kw):
    cfg, jspec, jparams, tspec, tparams = _models(kw)
    x = _hr(rng, cfg)
    jy, jld = _jax_apply(jspec, jparams, jnp.asarray(x), with_log_det=True)
    ty, tld = TI.inn_apply(tspec, tparams, torch.from_numpy(x),
                           with_log_det=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-3,
                               rtol=1e-5)
    jx, jild = _jax_apply(jspec, jparams, jy, rev=True,
                          with_log_det=True)
    tx, tild = TI.inn_apply(tspec, tparams, torch.from_numpy(np.array(jy)),
                            rev=True, with_log_det=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(tild.numpy(), np.asarray(jild), atol=1e-3,
                               rtol=1e-5)
    np.testing.assert_allclose(tild.numpy(), -tld.numpy(), atol=1e-3)


def test_inn_apply_counts_no_launch_on_cpu(rng):
    cfg, _, _, tspec, tparams = _models(TINY[1])
    TK.reset_launch_counts()
    TI.inn_apply(tspec, tparams, torch.from_numpy(_hr(rng, cfg)))
    assert sum(TK.launch_counts().values()) == 0


def test_params_from_jax_layout():
    cfg, _, jparams, tspec, tparams = _models(TINY[0])
    for layer, jp, tp in zip(tspec, jparams, tparams):
        if layer.kind != "glow":
            assert tp is None
            continue
        for sub in ("s1", "s2"):
            for conv in ("conv1", "conv2"):
                np.testing.assert_array_equal(
                    tp[sub][conv]["w"].numpy(),
                    np.asarray(jp[sub][conv]["w"]).transpose(3, 2, 0, 1))
    with pytest.raises(ValueError):
        params_from_jax(tspec, jparams[:-1])
