"""Video/image artifact writers with ffmpeg gated behind availability.

Counterpart of ``sin_inn_tpu/io/video_io.py``: ffmpeg when present on PATH,
otherwise a GIF; PNG frame dumps. The GIF and the PNGs are written by the
port's own codecs (``io/gif.py``, ``io/png.py``), so no imageio is needed.
"""

from __future__ import annotations

import os
import shutil
import subprocess as sp
from typing import Iterator

import numpy as np

from sin_inn_tpu_torch.io import gif, png


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoWriter:
    """Stream uint8 (H, W, 3) frames to x264 video (ffmpeg) or GIF."""

    def __init__(self, out_path: str, fps: int = 30, crf: int = 18):
        self.requested_path = out_path
        self.fps = fps
        self.crf = crf
        self._frames = []
        self._proc = None
        self._use_ffmpeg = have_ffmpeg() and not out_path.endswith(".gif")
        if self._use_ffmpeg:
            self.path = out_path
        else:
            base, _ = os.path.splitext(out_path)
            self.path = base + ".gif"

    def add(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame)
        if self._use_ffmpeg:
            if self._proc is None:
                h, w = frame.shape[:2]
                self._proc = sp.Popen(
                    ["ffmpeg", "-f", "rawvideo", "-pix_fmt", "rgb24",
                     "-s", f"{w}x{h}", "-framerate", str(self.fps), "-i", "-",
                     "-c:v", "libx264", "-preset", "veryslow",
                     "-crf", str(self.crf), "-y", self.path],
                    stdin=sp.PIPE, stderr=sp.DEVNULL)
            self._proc.stdin.write(frame.tobytes())
        else:
            self._frames.append(frame)

    def close(self) -> str:
        if self._use_ffmpeg:
            if self._proc is not None:
                self._proc.stdin.close()
                self._proc.wait()
        else:
            if self._frames:
                gif.mimsave(self.path, self._frames, fps=min(self.fps, 30))
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_frames(directory: str, frames: Iterator[np.ndarray],
                 prefix: str = "out"):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(directory, f"{prefix}_{i:05d}.png")
        png.imwrite(p, f)
        paths.append(p)
    return paths
