"""The port's pseudo-GT producers (``data/flow_media.py``) and their hook in
the flow drivers (``train/loop.py`` ``_maybe_pseudo_gt``, ``flow
--flow-producer``) against the JAX package on the CPU.

Both packages run their own RAFT on the same release-schema checkpoint (the
goldens' deterministic draw): the flows agree within atol 2e-3 / rtol 1e-2
(the JAX package's limits against its torch replica), a batched producer
within 1e-4 of the per-pair one (the JAX suite's limit), and the cache
directory and the ``.flo`` names are the same.
"""

import argparse
import glob
import os
import sys

import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.data import flow_media as JM
from sin_inn_tpu.models import raft as JR
from sin_inn_tpu.train import loop as JL
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.data import flow_media as TM
from sin_inn_tpu_torch.data.flo import read_flo
from sin_inn_tpu_torch.models import raft as TR
from sin_inn_tpu_torch.train import loop as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import goldens as G  # noqa: E402

FLOW_TOL = dict(atol=2e-3, rtol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several workers on the box's cores; torch's default of
    a thread per core in each of them oversubscribes the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("raft") / "raft-basic.pth"
    torch.save({k: torch.tensor(a) for k, a in
                G.raft_state_dict_np("basic").items()}, path)
    return str(path)


def _video(n=6, h=60, w=70, seed=4):
    # 60x70 is no multiple of 8: pad_to_multiple and unpad run
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("batch_pairs", [1, 2])
def test_generate_pseudo_gt_matches_jax(batch_pairs, ckpt, tmp_path):
    video = _video()
    jp = JR.make_raft_producer(ckpt, iters=2, batch_pairs=batch_pairs)
    tp = TR.make_raft_producer(ckpt, iters=2, batch_pairs=batch_pairs,
                               device="cpu")
    ref = JM.generate_pseudo_gt(video, jp, str(tmp_path / "jax"))
    got = TM.generate_pseudo_gt(video, tp, str(tmp_path / "port"))
    assert got.shape == ref.shape == (5, 60, 70, 2)
    err = np.abs(got - ref).max()
    print(f"pseudo-GT, batch_pairs {batch_pairs}: max |port - JAX| "
          f"{err:.3e} px (max |flow| {np.abs(ref).max():.3f})")
    np.testing.assert_allclose(got, ref, **FLOW_TOL)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        f"frame_{i:04d}.flo" for i in range(1, 6)]
    for i, n in enumerate(names):
        np.testing.assert_array_equal(read_flo(str(tmp_path / "port" / n)),
                                      got[i])


def test_batched_pseudo_gt_matches_per_pair(ckpt, tmp_path):
    """5 pairs at batch_pairs 2: two full calls and a ragged tail padded by
    repeating the last pair; every norm is per sample, so the batch changes
    nothing beyond summation order."""
    video = _video()
    per_pair = TR.make_raft_producer(ckpt, iters=2, batch_pairs=1,
                                     device="cpu")
    batched = TR.make_raft_producer(ckpt, iters=2, batch_pairs=2,
                                    device="cpu")
    calls = []

    def counted(f1, f2):
        calls.append(np.asarray(f1).shape)
        return batched(f1, f2)

    counted.batch_pairs = 2
    f_a = TM.generate_pseudo_gt(video, per_pair, str(tmp_path / "a"))
    f_b = TM.generate_pseudo_gt(video, counted, str(tmp_path / "b"))
    assert calls == [(2, 60, 70, 3)] * 3
    np.testing.assert_allclose(f_b, f_a, atol=1e-4, rtol=1e-4)


def test_batched_producer_shape_is_checked(tmp_path):
    def wrong(f1, f2):
        return np.zeros((1, 4, 4, 2), np.float32)

    wrong.batch_pairs = 2
    with pytest.raises(ValueError, match="batched producer returned"):
        TM.generate_pseudo_gt(_video(4, 8, 8), wrong, str(tmp_path))
    with pytest.raises(ValueError, match="producer returned"):
        TM.generate_pseudo_gt(_video(3, 8, 8), lambda a, b: np.zeros((2, 2)),
                              str(tmp_path / "b"))


def test_resolve_producer_schemes(ckpt, tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "tests"))
    video = _video(3, 8, 12)
    # py:
    fn = TM.resolve_producer("py:flow_producer_helper:unit_flow")
    assert fn is JM.resolve_producer("py:flow_producer_helper:unit_flow")
    flows = TM.generate_pseudo_gt(video, fn, str(tmp_path / "py"))
    assert flows.shape == (2, 8, 12, 2) and np.all(flows[..., 0] == 1)
    # a callable passes through, a template stays a template
    assert TM.resolve_producer(fn) is fn
    tpl = "mytool {f1} {f2} {out}"
    assert TM.resolve_producer(tpl) == tpl == JM.resolve_producer(tpl)
    # raft: on the device asked for, iterations after '@'
    prod = TR.make_raft_producer(ckpt, iters=1, device="cpu")
    raft = TM.resolve_producer(f"raft:{ckpt}@1", device="cpu")
    assert raft.batch_pairs == 4
    f = _video(2, 16, 24)
    np.testing.assert_array_equal(raft(f[0], f[1]), prod(f[0], f[1]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.resolve_producer(f"raft:{ckpt}")
    # the error names the schemes, word for word as in JAX
    for bad in ("not-a-spec", "raft:", "{f1} {out}"):
        with pytest.raises(ValueError) as te:
            TM.resolve_producer(bad)
        with pytest.raises(ValueError) as je:
            JM.resolve_producer(bad)
        assert str(te.value) == str(je.value)
        assert "producer spec" in str(te.value)


def test_template_producer_runs_a_command(tmp_path):
    pytest.importorskip("imageio.v2")
    script = tmp_path / "tool.py"
    script.write_text(
        "import sys\n"
        "import imageio.v2 as io\n"
        "import numpy as np\n"
        "sys.path.insert(0, %r)\n"
        "from sin_inn_tpu_torch.data.flo import write_flo\n"
        "a = io.imread(sys.argv[1]).astype(np.float32)\n"
        "b = io.imread(sys.argv[2]).astype(np.float32)\n"
        "f = np.stack([a[..., 0] - b[..., 0], a[..., 1] * 0 + 2], -1)\n"
        "write_flo(sys.argv[3], f.astype(np.float32))\n" % REPO)
    video = _video(3, 8, 12)
    spec = f"{sys.executable} {script} {{f1}} {{f2}} {{out}}"
    prod = TM.resolve_producer(spec)
    flows = TM.generate_pseudo_gt(video, prod, str(tmp_path / "out"))
    ref = JM.generate_pseudo_gt(video, spec, str(tmp_path / "jout"))
    assert flows.shape == (2, 8, 12, 2) and np.all(flows[..., 1] == 2)
    np.testing.assert_array_equal(flows, ref)
    # a failing command leaves no partial .flo behind
    import subprocess

    with pytest.raises(subprocess.CalledProcessError):
        TM.generate_pseudo_gt(video, "false {f1} {f2} {out}",
                              str(tmp_path / "fail"))
    assert os.listdir(tmp_path / "fail") == []


def test_attach_pseudo_gt_reuses_the_cache(tmp_path):
    video = _video(4, 8, 12)
    out = str(tmp_path / "cache")
    m1 = TM.attach_pseudo_gt(TM.FlowMedia(video), lambda a, b: np.full(
        a.shape[:2] + (2,), 0.5, np.float32), out)
    assert m1.gt_available and m1.flow_scale == 1.0
    assert TM.FlowMedia(video).flow_scale == 12 / 5.0

    def never(a, b):
        raise AssertionError("the cache should have been used")

    m2 = TM.attach_pseudo_gt(TM.FlowMedia(video), never, out)
    np.testing.assert_array_equal(m2.flow, m1.flow)
    assert m2.flow_scale == 1.0
    # an incomplete cache is made again
    os.remove(os.path.join(out, "frame_0003.flo"))
    m3 = TM.attach_pseudo_gt(TM.FlowMedia(video), lambda a, b: np.ones(
        a.shape[:2] + (2,), np.float32), out)
    assert np.all(m3.flow == 1)


@pytest.mark.parametrize("step,end", [(None, None), (3, 40)])
def test_pseudo_gt_cache_directory_is_named_as_in_jax(step, end, tmp_path,
                                                      monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "tests"))
    spec = "py:flow_producer_helper:unit_flow"
    video = _video(3, 12, 16)
    kw = dict(flow_producer=spec, step=step, end=end)
    TL._maybe_pseudo_gt(FlowConfig(checkpoints_dir=str(tmp_path / "t"),
                                   device="cpu", **kw),
                        TM.FlowMedia(video), "prodscene")
    JL._maybe_pseudo_gt(JaxFlowConfig(checkpoints_dir=str(tmp_path / "j"),
                                      **kw), JM.FlowMedia(video), "prodscene")
    names = os.listdir(tmp_path / "t" / "pseudo_gt")
    assert names == os.listdir(tmp_path / "j" / "pseudo_gt")
    assert len(names) == 1 and names[0].startswith("prodscene_h12_")
    # media with GT, or no producer, are left alone
    gt = TM.FlowMedia(video, np.zeros((2, 12, 16, 2), np.float32))
    cfg = FlowConfig(checkpoints_dir=str(tmp_path / "t2"), device="cpu", **kw)
    assert TL._maybe_pseudo_gt(cfg, gt, "s") is gt and gt.flow_scale == 16 / 5
    assert TL._maybe_pseudo_gt(cfg, None, "s") is None
    assert not os.path.exists(tmp_path / "t2")


def test_flow_producer_flag_reaches_the_config():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    cli._flow_parser(sub)
    a = parser.parse_args(["flow", "train", "--flow-producer",
                           "raft:ckpt.pth@12", "--device", "cpu"])
    cfg = cli.flow_config_from_args(a)
    assert cfg.flow_producer == "raft:ckpt.pth@12"
    assert cli.flow_config_from_args(
        parser.parse_args(["flow", "test"])).flow_producer is None
    assert FlowConfig().flow_producer is None is JaxFlowConfig().flow_producer


def test_run_flow_train_with_raft_pseudo_gt(ckpt, tmp_path, monkeypatch):
    """A tiny ``run_flow_train`` on the CPU with the seeded RAFT producer:
    the attached flow equals JAX's within the flow limits, and the bounds
    the run trained on (refit off) are the JAX probe's on JAX's media."""
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video

    spec = f"raft:{ckpt}@2"
    video = moving_texture_video(3, 128, 160, seed=1)
    media = TM.FlowMedia(video)
    cfg = FlowConfig(device="cpu", num_frequencies=16, hidden_dim=16,
                     num_layers=2, size=128, test_size=128, epochs=1,
                     window_refit="off", flow_producer=spec,
                     checkpoints_dir=str(tmp_path / "ck"),
                     results_dir=str(tmp_path / "res"))
    out = TL.run_flow_train(cfg, media=media, scene="clip")
    assert media.gt_available and media.flow_scale == 1.0
    assert out["state"].step == 2 and "epe" in out["metrics"]

    jmedia = JM.FlowMedia(video)
    jcfg = JaxFlowConfig(checkpoints_dir=str(tmp_path / "jck"), size=128,
                         test_size=128, flow_producer=spec)
    JL._maybe_pseudo_gt(jcfg, jmedia, "clip")
    err = np.abs(media.flow - jmedia.flow).max()
    print(f"attached flow: max |port - JAX| {err:.3e} px (max |flow| "
          f"{np.abs(jmedia.flow).max():.3f})")
    np.testing.assert_allclose(media.flow, jmedia.flow, **FLOW_TOL)
    assert os.listdir(tmp_path / "ck" / "pseudo_gt") == os.listdir(
        tmp_path / "jck" / "pseudo_gt")
    probed = JL._resolve_and_probe_splat_bounds(jcfg, jmedia, 128, 160)
    keys = FlowConfig.WINDOW_BOUND_KEYS
    got = tuple(getattr(out["cfg"], k) for k in keys)
    assert got == tuple(getattr(probed, k) for k in keys)
    assert isinstance(got[0], int), got      # the windowed path engaged
    # flow test attaches the same cached flow (RAFT does not run) and
    # scores against it
    def never(*a, **k):
        raise AssertionError("the cache should have been used")

    monkeypatch.setattr(TR, "raft_flow", never)
    res = TL.run_flow_test(cfg, media=TM.FlowMedia(video), scene="clip")
    assert np.isfinite(res["epe"])
    (flo_dir,) = glob.glob(str(tmp_path / "ck" / "pseudo_gt" / "clip_h128_*"))
    assert len(os.listdir(flo_dir)) == 2
