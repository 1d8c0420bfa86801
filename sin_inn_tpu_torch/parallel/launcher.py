"""Multi-scene experiment launcher: train and test every scene of a root,
then the frame-weighted AEPE.

Counterpart of ``sin_inn_tpu/parallel/launcher.py``. Scenes share nothing,
so the scale-out is plain: one process runs its scenes one after another,
and several processes (``torchrun``, or any launcher that sets up the
process group) each take a round-robin shard of the scenes by their rank,
each scene on its own GPU. Every process writes its per-scene results as
JSON (``--out``); ``--aggregate a.json b.json ...`` is the final reduce.

    python -m sin_inn_tpu_torch.parallel.launcher --root SCENES [flow flags]
"""

from __future__ import annotations

import json
import os
import os.path as path
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sin_inn_tpu_torch.core.config import FlowConfig


@dataclass
class SceneResult:
    scene: str
    epe: float
    num_frames: int
    metrics: Dict


def scene_list(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root)
                  if path.isdir(path.join(root, d)))


def shard_for_process(scenes: List[str], process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> List[str]:
    """Round-robin scene assignment across processes: by default this
    process's rank and the group's size (0 and 1 without a group)."""
    if process_index is None:
        from sin_inn_tpu_torch.parallel.mesh import world_rank, world_size
        process_index, process_count = world_rank(), world_size()
    return scenes[process_index::max(process_count or 1, 1)]


def run_scenes(cfg: FlowConfig, root: Optional[str] = None,
               scenes: Optional[List[str]] = None,
               out_path: Optional[str] = None,
               media: Optional[Dict[str, Tuple]] = None
               ) -> List[SceneResult]:
    """``flow train`` then the test pass of every assigned scene; with
    ``out_path`` the results are written there as JSON. Each scene trains
    on this process alone (``mesh_data=1``): the processes split the
    scenes, not a batch.

    ``media`` maps a scene to its (train, test) ``FlowMedia`` in memory;
    such a scene's test pass is the in-memory core ``flow_test_outputs``
    (the same EPE and frame count, no GIF written)."""
    from sin_inn_tpu_torch.train import loop as L

    if scenes is None:
        scenes = shard_for_process(sorted(media) if media is not None
                                   else scene_list(root or path.dirname(
                                       cfg.input_video)))
    root = root or path.dirname(cfg.input_video)
    results: List[SceneResult] = []
    for scene in scenes:
        scfg = cfg.replace(input_video=path.join(root, scene), mesh_data=1)
        if media is not None:
            train_media, test_media = media[scene]
            out = L.run_flow_train(scfg, media=train_media, scene=scene,
                                   val_media=test_media)
            state = out["state"]
            test = L.flow_test_outputs(
                out["cfg"], test_media, out["spec"],
                state.params, out["consts"], state.ctrl_cfg,
                state.ctrl_state)
            epe = test["epe"] if test["epe"] is not None else 0.0
            frames = len(test["flow12"])
        else:
            out = L.run_flow_train(scfg)
            state = out["state"]
            test = L.run_flow_test(
                scfg, scene=out["scene"], spec=out["spec"],
                params=state.params, consts=out["consts"],
                ctrl_cfg=state.ctrl_cfg, ctrl_state=state.ctrl_state)
            epe, frames = test["epe"], test["num_frames"]
        results.append(SceneResult(scene=scene, epe=float(epe),
                                   num_frames=int(frames),
                                   metrics=out["metrics"]))
    if out_path:
        with open(out_path, "w") as f:
            json.dump([r.__dict__ for r in results], f, indent=2)
    return results


def aggregate_aepe(results: List[SceneResult]) -> float:
    """Frame-weighted mean EPE over the scenes."""
    frames = sum(r.num_frames for r in results)
    if frames == 0:
        return 0.0
    return sum(r.epe * r.num_frames for r in results) / frames


def aggregate_from_files(paths: List[str]) -> float:
    """Combine per-process result JSONs (the cross-process reduce)."""
    results: List[SceneResult] = []
    for p in paths:
        with open(p) as f:
            results.extend(SceneResult(**r) for r in json.load(f))
    return aggregate_aepe(results)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m sin_inn_tpu_torch.parallel.launcher --root <scenes>
    [...]``. Trains and tests this process's shard of the scene
    subdirectories of ``--root`` (round-robin over the process group's
    ranks) and prints the frame-weighted AEPE. Every flag of ``flow train``
    is accepted and forwarded (``--distributed`` and the ``--dist-*``
    flags start the process group); ``--out`` writes this process's
    results, ``--aggregate a.json b.json ...`` combines them."""
    import argparse
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(
        prog="python -m sin_inn_tpu_torch.parallel.launcher",
        description="multi-scene flow runner; other flags are forwarded to "
                    "`flow train`")
    pre.add_argument("--root", default=None,
                     help="directory containing one subdirectory per scene")
    pre.add_argument("--out", default=None,
                     help="write this process's per-scene results JSON here")
    pre.add_argument("--aggregate", nargs="+", default=None, metavar="JSON",
                     help="combine per-process result JSONs and print the "
                          "AEPE")
    mine, rest = pre.parse_known_args(argv)
    if mine.aggregate:
        print(f"Normalized AEPE: {aggregate_from_files(mine.aggregate)}")
        return 0
    if not mine.root:
        pre.error("--root is required (or use --aggregate)")

    from sin_inn_tpu_torch import cli as C
    from sin_inn_tpu_torch.train.loop import _init_distributed

    fp = argparse.ArgumentParser(prog=pre.prog)
    sub = fp.add_subparsers(dest="command", required=True)
    C._flow_parser(sub)
    cfg = C.flow_config_from_args(fp.parse_args(["flow", "train"] + rest))
    _init_distributed(cfg)
    results = run_scenes(cfg.replace(distributed=False), root=mine.root,
                         out_path=mine.out)
    print(f"Normalized AEPE: {aggregate_aepe(results)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
