"""Flow-pipeline media: frame dirs, video clips, GT flow (numpy, host side).

A copy of ``FlowMedia``, ``load_images``, ``load_video_clip``,
``load_flow_dir`` and ``get_video`` of ``sin_inn_tpu/data/flow_media.py``:
frames resized to a target short side, Sintel ``.flo`` GT found under
``../../flow/<scene>`` (or an explicit ``flow_dir``) and rescaled, and the
``flow_scale = W / 5`` heuristic; and the pseudo-GT producers of
``--flow-producer`` (``generate_pseudo_gt``, ``FLOW_PRODUCERS``,
``resolve_producer``, ``attach_pseudo_gt``), whose ``raft:`` scheme runs the
port's RAFT (``models/raft.py``) on the device the caller names. ``imageio``
and ``cv2`` are imported inside the functions that read or write files or
resize, so in-memory media need neither.
"""

from __future__ import annotations

import os
import os.path as path
from typing import Dict, Iterator, Optional

import numpy as np

from sin_inn_tpu_torch.data.flo import read_flo


def _resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """Resize (N, H, W, C) so the short (height) side == size."""
    n, h, w, c = frames.shape
    if h == size:
        return frames
    import cv2

    scale = size / h
    new_w = int(round(w * scale))
    out = np.stack([cv2.resize(f, (new_w, size), interpolation=cv2.INTER_AREA
                               if scale < 1 else cv2.INTER_LINEAR)
                    for f in frames])
    return out.reshape(n, size, new_w, c)


class FlowMedia:
    """Host-cached frames (N, H, W, 3) float32 + optional GT flow, both
    C-contiguous whatever the caller's layout (the kernels take NHWC
    tensors as ``torch.from_numpy`` leaves a batch of them)."""

    def __init__(self, video: np.ndarray, flow: Optional[np.ndarray] = None,
                 flow_scale: float = None):
        self.video = np.ascontiguousarray(video, dtype=np.float32)
        self.flow = (np.ascontiguousarray(flow, dtype=np.float32)
                     if flow is not None else None)
        n = video.shape[0]
        self.times = np.linspace(-1.0, 1.0, n).astype(np.float32)
        self.flow_scale = (video.shape[2] / 5.0 if flow_scale is None
                           else float(flow_scale))

    @property
    def gt_available(self) -> bool:
        return self.flow is not None

    def __len__(self) -> int:
        return self.video.shape[0] - 1

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = {
            "frame1": self.video[idx],
            "frame2": self.video[idx + 1],
            "times": self.times[idx],
            "scale": np.float32(self.flow_scale),
        }
        if self.gt_available:
            out["gt_flow"] = self.flow[idx]
        return out

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.RandomState] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self))
        if shuffle:
            (rng or np.random).shuffle(order)
        for s in range(0, len(order), batch_size):
            yield self.sample(order[s:s + batch_size])


def load_images(root: str, size: int = 200,
                flow_dir: Optional[str] = None) -> FlowMedia:
    """A ``frame_%04d.png`` directory. An explicit ``flow_dir`` overrides
    the Sintel ``../../flow/<scene>`` convention."""
    import imageio.v2 as io

    files = sorted(f for f in os.listdir(root) if f.endswith(".png"))
    num = len(files)
    frames = np.stack([io.imread(path.join(root, f)) for f in files])
    if frames.ndim == 3:
        frames = frames[..., None].repeat(3, -1)
    h0, w0 = frames.shape[1:3]
    if h0 > w0:
        raise ValueError("frames should be landscape oriented")
    video = _resize_frames(frames, size).astype(np.float32) / 255.0

    scene = path.splitext(path.basename(root))[0]
    lookup = flow_dir if flow_dir else path.join(root, "../../flow", scene)
    flow = None
    if path.isdir(lookup):
        flows = load_flow_dir(lookup, num - 1)
        # rescale by the flow files' own resolution, not the frames'
        flow = _resize_frames(flows, size) * (size / flows.shape[1])
    return FlowMedia(video, flow)


def load_video_clip(video_path: str, end: Optional[int] = None,
                    step: int = 10, size: int = 200,
                    flow_dir: Optional[str] = None) -> FlowMedia:
    """Frames of a video file, every ``step``-th up to ``end``, with
    precomputed flow from ``flow_dir`` when given."""
    import imageio.v2 as io

    frames = np.stack(io.mimread(video_path, memtest=False)[:end:step or 1])
    video = _resize_frames(frames, size).astype(np.float32) / 255.0
    flow = None
    if flow_dir and path.isdir(flow_dir):
        flow = _resize_frames(load_flow_dir(flow_dir, len(video) - 1), size)
    return FlowMedia(video, flow, flow_scale=1.0 if flow is not None else None)


def load_flow_dir(flow_dir: str, num: int) -> np.ndarray:
    """Read ``frame_%04d.flo`` or ``.npy`` flow files."""
    flows = []
    for i in range(num):
        flo = path.join(flow_dir, f"frame_{i+1:04d}.flo")
        npy = path.join(flow_dir, f"frame_{i+1:04d}.npy")
        if path.isfile(flo):
            flows.append(read_flo(flo))
        elif path.isfile(npy):
            flows.append(np.load(npy))
        else:
            raise FileNotFoundError(f"no flow file for frame {i+1} in {flow_dir}")
    return np.stack(flows)


def generate_pseudo_gt(video: np.ndarray, producer, out_dir: str) -> np.ndarray:
    """Pseudo-GT flow over consecutive frame pairs, written to ``out_dir``
    as ``frame_%04d.flo`` (the layout :func:`load_flow_dir` reads) and
    returned as an (N-1, H, W, 2) array.

    ``producer`` is either
      * a callable ``(frame1, frame2) -> (H, W, 2) float array`` (frames
        (H, W, 3) float32 in [0, 1]); with a ``batch_pairs`` attribute above
        1 it is handed that many consecutive pairs a call as (B, H, W, 3)
        stacks, the ragged tail padded by repeating the last pair; or
      * a subprocess command template with ``{f1} {f2} {out}`` placeholders,
        run once a pair on PNG paths and an output ``.flo`` path (any
        external flow tool).
    """
    from sin_inn_tpu_torch.data.flo import write_flo

    os.makedirs(out_dir, exist_ok=True)
    bp = int(getattr(producer, "batch_pairs", 0) or 0)
    if callable(producer) and bp > 1 and len(video) > 2:
        flows = []
        n_pairs = len(video) - 1
        for s in range(0, n_pairs, bp):
            f1s = video[s:min(s + bp, n_pairs)]
            f2s = video[s + 1:min(s + bp, n_pairs) + 1]
            pad = bp - len(f1s)
            if pad:
                f1s = np.concatenate([f1s, np.repeat(f1s[-1:], pad, 0)])
                f2s = np.concatenate([f2s, np.repeat(f2s[-1:], pad, 0)])
            fls = np.asarray(producer(f1s, f2s), np.float32)
            if fls.shape != f1s.shape[:3] + (2,):
                raise ValueError(
                    f"batched producer returned {fls.shape}, want "
                    f"{f1s.shape[:3] + (2,)}")
            for k in range(len(f1s) - pad):
                write_flo(path.join(out_dir, f"frame_{s + k + 1:04d}.flo"),
                          fls[k])
                flows.append(fls[k])
        return np.stack(flows)

    flows = []
    for i in range(len(video) - 1):
        f1, f2 = video[i], video[i + 1]
        if callable(producer):
            fl = np.asarray(producer(f1, f2), np.float32)
        else:
            import shlex
            import subprocess
            import tempfile

            import imageio.v2 as io

            with tempfile.TemporaryDirectory() as td:
                p1 = path.join(td, "f1.png")
                p2 = path.join(td, "f2.png")
                # the tool writes to a temporary path and only a validated
                # result reaches out_dir: a failing producer leaves no
                # partial frame_%04d.flo behind
                po = path.join(td, "out.flo")
                io.imwrite(p1, (np.clip(f1, 0, 1) * 255).astype(np.uint8))
                io.imwrite(p2, (np.clip(f2, 0, 1) * 255).astype(np.uint8))
                # an argument list, no shell: a path with spaces stays one
                argv = [a.format(f1=p1, f2=p2, out=po)
                        for a in shlex.split(producer)]
                subprocess.run(argv, check=True)
                fl = read_flo(po)
        if fl.shape != f1.shape[:2] + (2,):
            raise ValueError(
                f"producer returned {fl.shape}, want {f1.shape[:2] + (2,)}")
        write_flo(path.join(out_dir, f"frame_{i+1:04d}.flo"), fl)
        flows.append(fl)
    return np.stack(flows)


def _raft_producer_factory(arg: str, device="cuda"):
    from sin_inn_tpu_torch.models.raft import make_raft_producer

    ckpt, _, iters = arg.partition("@")
    return make_raft_producer(ckpt, iters=int(iters) if iters else 20,
                              device=device)


def _py_producer_factory(arg: str, device="cuda"):
    import importlib

    mod, _, fn = arg.rpartition(":")
    return getattr(importlib.import_module(mod), fn)


#: producer-spec schemes of --flow-producer (see :func:`resolve_producer`)
FLOW_PRODUCERS = {
    "raft": _raft_producer_factory,   # raft:<ckpt.pth>[@iters]: the port's RAFT
    "py": _py_producer_factory,       # py:<module>:<function>: any callable
}


def resolve_producer(spec, device="cuda"):
    """A producer spec -> the callable or template :func:`generate_pseudo_gt`
    takes.

    Specs: ``raft:<ckpt.pth>[@iters]`` (``models/raft.py`` on ``device``),
    ``py:<module>:<function>`` (any importable callable), or a subprocess
    command template holding ``{f1} {f2} {out}``. A callable passes through.
    """
    if callable(spec):
        return spec
    scheme, _, arg = spec.partition(":")
    if arg and scheme in FLOW_PRODUCERS:
        return FLOW_PRODUCERS[scheme](arg, device=device)
    if "{f1}" in spec and "{f2}" in spec and "{out}" in spec:
        return spec
    raise ValueError(
        f"flow producer spec {spec!r} is neither a registered scheme "
        f"({sorted(FLOW_PRODUCERS)}) nor a {{f1}}/{{f2}}/{{out}} template")


def attach_pseudo_gt(media: FlowMedia, producer, out_dir: str) -> FlowMedia:
    """Attach producer-made pseudo-GT flow to ``media``, reusing the files
    in ``out_dir`` when they are complete. The flow is in pixels at the
    training resolution, so ``flow_scale`` drops to 1."""
    num = len(media.video) - 1
    try:
        flow = load_flow_dir(out_dir, num)
    except FileNotFoundError:
        flow = generate_pseudo_gt(media.video, producer, out_dir)
    media.flow = flow.astype(np.float32)
    media.flow_scale = 1.0
    return media


def get_video(input_video: str, size: int, test_size: int,
              end: Optional[int] = None, step: Optional[int] = None,
              flow_dir: Optional[str] = None):
    """(trainset, testset, scene) from a frame directory or a video file."""
    if path.isdir(input_video):
        trainset = load_images(input_video, size=size, flow_dir=flow_dir)
        testset = (trainset if test_size == size
                   else load_images(input_video, size=test_size,
                                    flow_dir=flow_dir))
    else:
        trainset = load_video_clip(input_video, end, step or 10, size,
                                   flow_dir)
        testset = (trainset if test_size == size else
                   load_video_clip(input_video, end, step or 10, test_size,
                                   flow_dir))
    scene = path.splitext(path.basename(input_video))[0]
    return trainset, testset, scene
