"""The port's analytic-GT flow fixtures and ``param_count`` held against the
JAX package on the CPU.

``synthetic_flow_sequence`` is numpy in both packages and must be the same
bit for bit; its padded base must cover every sampled coordinate (the
counterpart of ``tests/test_convergence.py``'s pad test); the convergence
tool's shift fixture is ``tools/validate.py``'s; ``param_count`` counts the
same scalars as JAX's on nets carried across with ``params_from_jax``.
"""

import os
import sys

import jax
import numpy as np
import pytest

from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.data import synthetic as JS
from sin_inn_tpu.models import inn as JI
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data import synthetic as TS
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import validate_torch as V  # noqa: E402


@pytest.mark.parametrize("kind,magnitude", [
    ("shift", 2.0), ("shift", 6.5), ("rotation", 3.0), ("rotation", 7.5),
    ("zoom", 4.0), ("zoom", -3.0), ("occlusion", 2.0), ("occlusion", 3.0)])
def test_synthetic_flow_sequence_is_jax_bit_for_bit(kind, magnitude):
    ref = JS.synthetic_flow_sequence(kind, 5, 24, 40, seed=2,
                                     magnitude=magnitude)
    got = TS.synthetic_flow_sequence(kind, 5, 24, 40, seed=2,
                                     magnitude=magnitude)
    assert got[0].shape == (5, 24, 40, 3) and got[1].shape == (4, 24, 40, 2)
    assert got[0].dtype == got[1].dtype == np.float32
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_unknown_fixture_kind_raises():
    with pytest.raises(ValueError):
        TS.synthetic_flow_sequence("shear", 3, 8, 8)


@pytest.mark.parametrize("kind,magnitude", [
    ("rotation", 3.0), ("zoom", 4.0), ("shift", 6.0)])
def test_fixture_pad_covers_sampled_coords(kind, magnitude, monkeypatch):
    """The padded base covers the whole sampled coordinate range at an
    aggressive magnitude and horizon: ``_sample_bilinear`` clips at the
    base border, so an under-padded base would smear the frames' edges
    while the returned GT stayed analytic."""
    worst = {"v": -np.inf}
    orig = TS._sample_bilinear

    def spy(base, yy, xx):
        hb, wb = base.shape[:2]
        worst["v"] = max(worst["v"], float(-yy.min()),
                         float(yy.max() - (hb - 1)),
                         float(-xx.min()), float(xx.max() - (wb - 1)))
        return orig(base, yy, xx)

    monkeypatch.setattr(TS, "_sample_bilinear", spy)
    TS.synthetic_flow_sequence(kind, 8, 120, 260, magnitude=magnitude)
    assert worst["v"] <= 0.0, (f"{kind}: sampled {worst['v']:.1f} px past "
                               f"the padded base")


def test_sample_bilinear_is_jax_bit_for_bit(rng):
    base = rng.rand(9, 11, 3).astype(np.float32)
    yy = rng.rand(5, 7) * 10 - 1
    xx = rng.rand(5, 7) * 12 - 1
    assert np.array_equal(TS._sample_bilinear(base, yy, xx),
                          JS._sample_bilinear(base, yy, xx))


@pytest.mark.parametrize("fixture", ["shift", "zoom"])
def test_tool_fixture_is_validate_py_s(fixture):
    """``tools/validate_torch.py``'s frames and GT are those that
    ``tools/validate.py`` ``validate_flow`` builds."""
    h, w, nf = 20, 48, 4
    frames, gt = V.flow_fixture(fixture, h, w, magnitude=4.0)
    if fixture == "shift":
        base = JS.moving_texture_video(1, h, w + 2 * nf + 2, seed=3)[0]
        ref_f = np.stack([base[:, 2 * i:2 * i + w] for i in range(nf)])
        ref_g = np.zeros((nf - 1, h, w, 2), np.float32)
        ref_g[..., 0] = -2.0
    else:
        ref_f, ref_g = JS.synthetic_flow_sequence(fixture, nf, h, w, seed=3,
                                                  magnitude=4.0)
    assert np.array_equal(frames, ref_f) and np.array_equal(gt, ref_g)


@pytest.mark.parametrize("arch,scale", [("SRF", 2), ("SRF", 4), ("IRN", 2)])
def test_param_count_matches_jax(arch, scale):
    kw = dict(architecture=arch, scale=scale, lr_window=1, num_coupling=2,
              hidden_channels=16, dense_gc=8, fps=30)
    jspec, _ = JI.build_inn_spec(JaxSRConfig(**kw))
    jparams = JI.init_inn(jax.random.key(0), jspec, 3)
    tspec, _ = TI.build_inn_spec(SRConfig(**kw, device="cpu"))
    tparams = params_from_jax(tspec,
                              jax.tree_util.tree_map(np.asarray, jparams))
    assert TI.param_count(tparams) == JI.param_count(jparams) > 0
