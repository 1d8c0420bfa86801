"""The port's RAFT (``sin_inn_tpu_torch/models/raft.py``) against the JAX
package's on the CPU.

The same numpy draws go through both. Limits: the schema's keys equal, its
shapes equal up to HWIO <-> OIHW; ``raft_params_from_jax`` exact; the
correlation pyramid and both lookups (r = 4 and 3, coordinates in frame, on
its edges, far outside and infinite) within 1e-5, the JAX suite's own
lookup limit; the encoders, update blocks and upsamplers within 1e-4 +
1e-4 |JAX| (fp32 convolutions of another library, summed in another
order); ``raft_flow`` (both variants, both lookups, 64x96, 3 iterations)
and the committed goldens ``tests/goldens/raft_{basic,small}.npz`` through
``load_torch_weights`` (128x160, 3 iterations) within atol 2e-3 / rtol
1e-2, the JAX package's limits against its torch replica.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.models import raft as JR
from sin_inn_tpu_torch.models import raft as TR
from sin_inn_tpu_torch.models.convert import raft_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import goldens as G  # noqa: E402

VARIANTS = ("basic", "small")
FLOW_TOL = dict(atol=2e-3, rtol=1e-2)
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several workers on the box's cores; torch's default of
    a thread per core in each of them oversubscribes the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Each variant's deterministic official-schema checkpoint (the
    goldens' draw) saved as the release saves it, and both packages'
    params loaded from it."""
    out = {}
    for v in VARIANTS:
        path = tmp_path_factory.mktemp("raft") / f"raft-{v}.pth"
        torch.save({k: torch.tensor(a) for k, a in
                    G.raft_state_dict_np(v).items()}, path)
        out[v] = (str(path), JR.load_torch_weights(str(path)),
                  TR.load_torch_weights(str(path)))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _close(got, ref, tol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), err_msg=what, **tol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_schema_matches_jax(variant):
    js, ts = JR.param_schema(variant), TR.param_schema(variant)
    assert list(ts) == list(js)
    for k, shape in js.items():
        want = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 \
            else shape
        assert ts[k] == want, k
    assert TR.detect_variant(ts) == variant == JR.detect_variant(js)
    assert (TR.CORR_LEVELS, TR.CORR_RADIUS, TR.HDIM, TR.CDIM, TR.S_HDIM,
            TR.S_CDIM, TR.S_CORR_RADIUS) == (
        JR.CORR_LEVELS, JR.CORR_RADIUS, JR.HDIM, JR.CDIM, JR.S_HDIM,
        JR.S_CDIM, JR.S_CORR_RADIUS)
    params = TR.init_raft(torch.Generator().manual_seed(0), variant)
    assert {k: tuple(v.shape) for k, v in params.items()} == ts


@pytest.mark.parametrize("variant", VARIANTS)
def test_raft_params_from_jax_is_exact(variant, ckpts):
    rng = np.random.RandomState(3)
    jp = {k: rng.randn(*shape).astype(np.float32)
          for k, shape in JR.param_schema(variant).items()}
    tp = raft_params_from_jax(jp)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        a = np.asarray(v)
        want = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), want, err_msg=k)
    # and the two loaders agree on the release-schema file, through it
    _, jparams, tparams = ckpts[variant]
    conv = raft_params_from_jax({k: np.asarray(v) for k, v in
                                 jparams.items()})
    for k in tparams:
        assert torch.equal(conv[k], tparams[k]), k


@pytest.mark.parametrize("variant,prefix,norm", [
    ("basic", "fnet", "instance"), ("basic", "cnet", "batch"),
    ("small", "fnet", "instance"), ("small", "cnet", "none")])
def test_encoders_match_jax(variant, prefix, norm, ckpts):
    _, jp, tp = ckpts[variant]
    x = (np.random.RandomState(0).rand(2, 64, 96, 3) * 2 - 1
         ).astype(np.float32)
    jenc = JR._small_encoder if variant == "small" else JR._encoder
    tenc = TR._small_encoder if variant == "small" else TR._encoder
    ref = jenc(jp, prefix, jnp.asarray(x), norm)
    got = tenc(tp, prefix, _t(x), norm)
    assert got.shape == ref.shape
    _close(got, ref, BLOCK_TOL)


def _features(seed, c=64, h=16, w=16):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, h, w, c).astype(np.float32),
            rng.rand(1, h, w, c).astype(np.float32))


def _coords(h=16, w=16):
    rng = np.random.RandomState(1)
    coords = rng.rand(1, h, w, 2).astype(np.float32) * 12 + 2
    # partly and wholly out of frame, far out and infinite
    coords[0, 0, :6, 0] = [-2.0, -40.0, 17.5, 300.0, 1e4, np.inf]
    coords[0, 0, 6:12, 1] = [-3.25, -99.0, 16.2, 1e4, -1e6, -np.inf]
    coords[0, 1, :3] = [[15.0, 15.0], [0.0, 0.0], [-0.5, 15.5]]
    return coords


def test_corr_pyramid_matches_jax():
    f1, f2 = _features(0)
    ref = JR.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = TR.build_corr_pyramid(_t(f1), _t(f2))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref] == [
        (256, 16, 16, 1), (256, 8, 8, 1), (256, 4, 4, 1), (256, 2, 2, 1)]
    for g, r in zip(got, ref):
        _close(g, r, dict(atol=1e-5, rtol=1e-5))
    # odd sizes floor, as avg_pool2d does
    f1, f2 = _features(2, c=32, h=10, w=14)
    got = TR.build_corr_pyramid(_t(f1), _t(f2))
    ref = JR.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]


@pytest.mark.parametrize("r", [4, 3])
@pytest.mark.parametrize("form", ["take", "matmul"])
def test_corr_lookups_match_jax(form, r):
    f1, f2 = _features(0)
    coords = _coords()
    jpyr = JR.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    tpyr = TR.build_corr_pyramid(_t(f1), _t(f2))
    if form == "take":
        ref = JR.lookup_corr(jpyr, jnp.asarray(coords), r=r)
        got = TR.lookup_corr(tpyr, _t(coords), r=r)
        padded = TR.pad_corr_pyramid(tpyr, r)
        assert torch.equal(TR.lookup_corr_padded(padded, _t(coords), r=r),
                           got)
    else:
        ref = JR.lookup_corr_matmul(jpyr, jnp.asarray(coords), r=r)
        got = TR.lookup_corr_matmul(tpyr, _t(coords), r=r)
        assert torch.equal(TR.lookup_corr_matmul(tpyr, _t(coords), r=r,
                                                 precision="highest"), got)
    assert got.shape == (1, 16, 16, 4 * (2 * r + 1) ** 2)
    assert torch.isfinite(got).all()
    _close(got, ref, dict(atol=1e-5, rtol=1e-5))
    # far-out and infinite coordinates read zeros, never wrapped values
    assert torch.all(got[0, 0, [3, 4, 5, 7, 9, 10, 11]] == 0)


def test_take_and_matmul_lookups_agree():
    f1, f2 = _features(4)
    pyr = TR.build_corr_pyramid(_t(f1), _t(f2))
    for r in (4, 3):
        _close(TR.lookup_corr_matmul(pyr, _t(_coords()), r=r),
                TR.lookup_corr(pyr, _t(_coords()), r=r),
                dict(atol=1e-5, rtol=1e-5))


def _update_inputs(variant, seed=5, h=8, w=12):
    rng = np.random.RandomState(seed)
    small = variant == "small"
    hdim = TR.S_HDIM if small else TR.HDIM
    cdim = TR.S_CDIM if small else TR.CDIM
    r = TR.S_CORR_RADIUS if small else TR.CORR_RADIUS
    net = np.tanh(rng.randn(1, h, w, hdim)).astype(np.float32)
    inp = np.maximum(rng.randn(1, h, w, cdim), 0).astype(np.float32)
    corr = rng.randn(1, h, w, TR.CORR_LEVELS * (2 * r + 1) ** 2
                     ).astype(np.float32)
    flow = (2 * rng.randn(1, h, w, 2)).astype(np.float32)
    return net, inp, corr, flow


@pytest.mark.parametrize("variant", VARIANTS)
def test_update_blocks_match_jax(variant, ckpts):
    _, jp, tp = ckpts[variant]
    args = _update_inputs(variant)
    jfn = JR._small_update_block if variant == "small" else JR._update_block
    tfn = TR._small_update_block if variant == "small" else TR._update_block
    ref = jfn(jp, *[jnp.asarray(a) for a in args])
    got = tfn(tp, *[_t(a) for a in args])
    assert len(got) == len(ref) == (2 if variant == "small" else 3)
    for g, r in zip(got, ref):
        _close(g, r, BLOCK_TOL)


def test_upsamplers_match_jax():
    rng = np.random.RandomState(6)
    flow = (3 * rng.randn(2, 5, 7, 2)).astype(np.float32)
    mask = rng.randn(2, 5, 7, 576).astype(np.float32)
    _close(TR.upsample_flow_bilinear8(_t(flow)),
           JR.upsample_flow_bilinear8(jnp.asarray(flow)), BLOCK_TOL)
    _close(TR.upsample_flow_convex(_t(flow), _t(mask)),
           JR.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)),
           BLOCK_TOL)


@pytest.mark.parametrize("lookup", TR.LOOKUPS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_raft_flow_matches_jax(variant, lookup, ckpts):
    _, jp, tp = ckpts[variant]
    rng = np.random.RandomState(2)
    i1 = (rng.rand(1, 64, 96, 3) * 255).astype(np.float32)
    i2 = (rng.rand(1, 64, 96, 3) * 255).astype(np.float32)
    ref = np.asarray(JR.raft_flow(jp, jnp.asarray(i1), jnp.asarray(i2),
                                  iters=3, variant=variant, lookup=lookup))
    got = TR.raft_flow(tp, _t(i1), _t(i2), iters=3, variant=variant,
                       lookup=lookup)
    assert got.shape == (1, 64, 96, 2) and not got.requires_grad
    err = np.abs(got.numpy() - ref).max()
    print(f"raft_flow {variant}/{lookup}: max |port - JAX| {err:.3e} px "
          f"(max |flow| {np.abs(ref).max():.3f})")
    _close(got, ref, FLOW_TOL)
    assert torch.equal(TR.raft_flow(tp, _t(i1), _t(i2), iters=3,
                                    variant=variant, lookup=lookup,
                                    lookup_precision="highest"), got)


@pytest.mark.parametrize("variant", VARIANTS)
def test_committed_goldens(variant, ckpts):
    z = np.load(os.path.join(G.GOLDEN_DIR, f"raft_{variant}.npz"))
    params = TR.load_torch_weights(ckpts[variant][0])   # variant detected
    assert TR.detect_variant(params) == variant == str(z["variant"])
    got = TR.raft_flow(params, _t(z["img1"]), _t(z["img2"]),
                       iters=int(z["iters"]), variant=variant)
    err = np.abs(got.numpy() - z["flow"]).max()
    print(f"golden {variant}: max |port - golden| {err:.3e} px")
    _close(got, z["flow"], FLOW_TOL)


def test_chip_smoke_state_dict_copy_is_bitwise(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    for v in VARIANTS:
        ref = G.raft_state_dict_np(v)
        got = chip_smoke.raft_state_dict_np(v)
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_load_torch_weights_rejects_bad_files(tmp_path, ckpts):
    p = tmp_path / "bad.pth"
    torch.save({"module.fnet.conv1.weight": torch.zeros(64, 3, 7, 7)}, p)
    with pytest.raises(ValueError, match="missing"):
        TR.load_torch_weights(str(p))
    sd = {k: torch.tensor(a) for k, a in G.raft_state_dict_np("small").items()}
    sd["module.fnet.conv1.weight"] = torch.zeros(32, 3, 5, 5)
    torch.save(sd, p)
    with pytest.raises(ValueError, match="fnet.conv1.weight has shape"):
        TR.load_torch_weights(str(p))
    torch.save([1, 2], p)
    with pytest.raises(ValueError, match="state_dict"):
        TR.load_torch_weights(str(p))
    # a wrapped {'state_dict': ...} file loads, without prefixes
    sd = {k[len("module."):]: torch.tensor(a) for k, a in
          G.raft_state_dict_np("small").items()}
    torch.save({"state_dict": sd, "epoch": 3}, p)
    params = TR.load_torch_weights(str(p))
    assert set(params) == set(TR.param_schema("small"))


def test_bad_lookup_and_precision_raise(ckpts):
    _, _, tp = ckpts["small"]
    img = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="lookup"):
        TR.raft_flow(tp, img, img, iters=1, variant="small", lookup="bogus")
    with pytest.raises(ValueError, match="lookup_precision"):
        TR.raft_flow(tp, img, img, iters=1, variant="small",
                     lookup_precision="high")


@pytest.mark.parametrize("hw", [(120, 132), (64, 72), (61, 83)])
def test_pad_to_multiple_and_unpad_match_jax(hw):
    x = np.random.RandomState(7).rand(2, *hw, 3).astype(np.float32)
    jpad, jpads = JR.pad_to_multiple(jnp.asarray(x))
    tpad, tpads = TR.pad_to_multiple(_t(x))
    assert tpads == jpads
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_array_equal(TR.unpad(tpad, tpads).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(JR.unpad(jpad, jpads)), TR.unpad(tpad, tpads).numpy())


def test_producer_needs_a_card_unless_asked_for_the_cpu(monkeypatch, ckpts):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = ckpts["small"][0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.make_raft_producer(path)
    prod = TR.make_raft_producer(path, iters=1, batch_pairs=3, device="cpu")
    assert prod.batch_pairs == 3
    f = np.random.RandomState(0).rand(2, 40, 44, 3).astype(np.float32)
    one = prod(f[0], f[1])
    both = prod(f[:1], f[1:])
    assert one.shape == (40, 44, 2) and both.shape == (1, 40, 44, 2)
    np.testing.assert_array_equal(both[0], one)
