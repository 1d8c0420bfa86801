"""The port's multi-scene launcher held against the JAX package's.

Both launchers' ``main`` train and test the same two tiny scenes (3 frames
of 10 x 14, GT flow from ``--flow-dir``) on the CPU; each writes its
per-scene JSON. The packages draw their inits from different generators,
so the EPEs differ; what must agree is the structure: the scenes, each
scene's frame count, each package's printed AEPE as the frame-weighted mean
of its own per-scene EPEs, and ``--aggregate`` of either package's JSON
giving the same number in both packages. ``run_scenes`` on in-memory media
(the form the card's smoke drives) gives ``run_flow_test``'s EPE and frame
count.
"""

import json
import os

import numpy as np
import pytest

from sin_inn_tpu.data.flo import write_flo
from sin_inn_tpu.data.synthetic import moving_texture_video
from sin_inn_tpu.parallel import launcher as JL
from sin_inn_tpu_torch.parallel import launcher as TL
from torch_port_helpers import one_torch_thread  # noqa: F401

FLAGS = ["--name", "t", "--size", "10", "--test-size", "10", "--net", "RBF",
         "--num-frequencies", "8", "--hidden-dim", "16", "--num-layers", "2",
         "--epochs", "2", "--batch", "2"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    import imageio.v2 as io

    root = tmp_path_factory.mktemp("launch")
    for s in ("a", "b"):
        d = root / "scenes" / s
        d.mkdir(parents=True)
        frames = (moving_texture_video(3, 10, 14, seed=ord(s)) * 255
                  ).astype(np.uint8)
        for i, f in enumerate(frames):
            io.imwrite(str(d / f"frame_{i + 1:04d}.png"), f)
    flow = root / "flow"
    flow.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        write_flo(str(flow / f"frame_{i + 1:04d}.flo"),
                  rng.uniform(-1, 1, (10, 14, 2)).astype(np.float32))
    return root


def _run(main, scenes, tag, capsys, extra=()):
    """One package's launcher from its own working directory (checkpoints
    and results land under it); returns (printed AEPE, JSON, its path)."""
    out = scenes / f"{tag}.json"
    cwd = os.getcwd()
    (scenes / tag).mkdir()
    os.chdir(scenes / tag)
    try:
        assert main(["--root", str(scenes / "scenes"), "--out", str(out),
                     "--flow-dir", str(scenes / "flow")]
                    + FLAGS + list(extra)) == 0
    finally:
        os.chdir(cwd)
    text = capsys.readouterr().out
    line = [ln for ln in text.splitlines() if ln.startswith("Normalized AEPE")]
    with open(out) as f:
        return float(line[-1].split(":")[1]), json.load(f), str(out)


def test_launcher_main_and_aggregate_match_jax(scenes, capsys):
    jaepe, jres, jpath = _run(JL.main, scenes, "jax", capsys)
    taepe, tres, tpath = _run(TL.main, scenes, "torch", capsys,
                              ["--device", "cpu"])
    assert [r["scene"] for r in tres] == [r["scene"] for r in jres] == \
        ["a", "b"]
    assert [r["num_frames"] for r in tres] == \
        [r["num_frames"] for r in jres] == [2, 2]
    for aepe, res in ((jaepe, jres), (taepe, tres)):
        frames = sum(r["num_frames"] for r in res)
        assert aepe == pytest.approx(
            sum(r["epe"] * r["num_frames"] for r in res) / frames, rel=1e-6)
        assert all(np.isfinite(r["epe"]) and r["epe"] > 0 for r in res)
    for p in (jpath, tpath):
        assert TL.aggregate_from_files([p]) == JL.aggregate_from_files([p])
    assert TL.aggregate_from_files([jpath, tpath]) == pytest.approx(
        (jaepe + taepe) / 2, rel=1e-6)
    assert TL.main(["--aggregate", tpath]) == 0
    assert f"Normalized AEPE: {taepe}" in capsys.readouterr().out


def test_run_scenes_in_memory_matches_the_files_path(scenes, tmp_path,
                                                     monkeypatch):
    """``media=`` takes the in-memory test core: the EPE and frame count of
    ``run_flow_test`` on the same scene, trained the same way."""
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data import flow_media

    monkeypatch.chdir(tmp_path)
    kw = dict(name="t", size=10, test_size=10, net="RBF", num_frequencies=8,
              hidden_dim=16, num_layers=2, epochs=2, batch=2, device="cpu",
              flow_dir=str(scenes / "flow"))
    root = scenes / "scenes"
    cfg = FlowConfig(input_video=str(root / "a"),
                     checkpoints_dir=str(tmp_path / "ck1"), **kw)
    files = TL.run_scenes(cfg, root=str(root), scenes=["a"])
    media = {}
    for s in ("a", "b"):
        tr, te, _ = flow_media.get_video(str(root / s), 10, 10, None, None,
                                         flow_dir=str(scenes / "flow"))
        media[s] = (tr, te)
    mem = TL.run_scenes(cfg.replace(checkpoints_dir=str(tmp_path / "ck2")),
                        root=str(root), media=media)
    assert [r.scene for r in mem] == ["a", "b"]
    assert mem[0].num_frames == files[0].num_frames == 2
    assert mem[0].epe == pytest.approx(files[0].epe, rel=1e-5)
    assert TL.aggregate_aepe(mem) == pytest.approx(
        sum(r.epe * r.num_frames for r in mem) / 4, rel=1e-6)
    assert TL.aggregate_aepe([]) == 0.0
    assert TL.shard_for_process(["a", "b", "c"], 1, 2) == ["b"]
    assert TL.shard_for_process(["a", "b", "c"]) == ["a", "b", "c"]
