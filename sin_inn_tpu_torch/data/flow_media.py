"""Flow-pipeline media: frame dirs, video clips, GT flow (numpy, host side).

A copy of ``FlowMedia``, ``load_images``, ``load_video_clip``,
``load_flow_dir`` and ``get_video`` of ``sin_inn_tpu/data/flow_media.py``:
frames resized to a target short side, Sintel ``.flo`` GT found under
``../../flow/<scene>`` (or an explicit ``flow_dir``) and rescaled, and the
``flow_scale = W / 5`` heuristic. ``imageio`` and ``cv2`` are imported inside
the functions that read files or resize, so in-memory media need neither.
The pseudo-GT producers (RAFT and friends) come with a later slice.
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
    """Host-cached frames (N, H, W, 3) float32 + optional GT flow."""

    def __init__(self, video: np.ndarray, flow: Optional[np.ndarray] = None,
                 flow_scale: float = None):
        self.video = video.astype(np.float32)
        self.flow = flow.astype(np.float32) if flow is not None else None
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
