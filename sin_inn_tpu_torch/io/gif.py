"""GIF89a writer of the port, in place of imageio's ``mimsave(..., "GIF")``.

Each frame is a full-canvas image with a palette of its own: exact where
the frame has at most 256 colours (occlusion masks, flat renders), else a
256-colour median cut over the frame's colour histogram (5 bits a
channel), each box drawn as the mean colour of its pixels. The file loops forever (the
NETSCAPE2.0 block) and each frame shows for ``int(1000 / fps / 10)``
hundredths of a second, the delay imageio (through Pillow) writes for the
same ``fps``. The LZW encoding is ``io/codec.py``'s (C++ where ``g++`` is
found).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Tuple

import numpy as np

from sin_inn_tpu_torch.io import codec

_LOOP_FOREVER = (b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
                 + struct.pack("<H", 0) + b"\x00")


def frame_delay(fps: float) -> int:
    """Hundredths of a second a frame: imageio hands Pillow a duration of
    ``1000 * 1 / fps`` ms and Pillow writes ``int(duration / 10)``."""
    return int(1000 * (1 / fps) / 10)


def _median_cut(cells: np.ndarray, weights: np.ndarray,
                n: int) -> np.ndarray:
    """Split the (U, 3) colour cells into at most ``n`` boxes, each time
    the box with the widest channel at that channel's weighted median.
    Returns each cell's box."""
    def span(box):
        r = np.ptp(cells[box], 0)
        return int(r.max()), int(r.argmax())

    boxes = [np.arange(len(cells))]
    spans = [span(boxes[0])]
    while len(boxes) < n:
        k = max(range(len(boxes)), key=lambda i: spans[i][0])
        if spans[k][0] == 0:
            break
        box = boxes[k][np.argsort(cells[boxes[k], spans[k][1]],
                                  kind="stable")]
        cum = np.cumsum(weights[box])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2)) + 1, 1),
                  len(box) - 1)
        boxes[k:k + 1] = [box[:cut], box[cut:]]
        spans[k:k + 1] = [span(box[:cut]), span(box[cut:])]
    assign = np.empty(len(cells), np.int64)
    for i, b in enumerate(boxes):
        assign[b] = i
    return assign


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 (H, W) or (H, W, 3) -> ((P, 3) uint8 palette, P <= 256, and
    (H, W) uint8 indices). Exact where the frame has at most 256 colours;
    else the median cut runs over the frame's histogram at 5 bits a channel
    and each box's colour is the mean of its pixels' full 8-bit colours."""
    f = np.asarray(frame)
    if f.dtype != np.uint8 or not (f.ndim == 2 or (f.ndim == 3
                                                   and f.shape[2] == 3)):
        raise ValueError(f"GIF frames are uint8 (H, W) or (H, W, 3), got "
                         f"{f.dtype} {f.shape}")
    if f.ndim == 2:
        f = np.repeat(f[..., None], 3, -1)
    rgb = f.reshape(-1, 3)
    c5 = (rgb >> 3).astype(np.int64)
    cell = c5[:, 0] << 10 | c5[:, 1] << 5 | c5[:, 2]
    hist = np.bincount(cell, minlength=1 << 15)
    if np.count_nonzero(hist) <= 256:
        # fewer than 257 cells: perhaps fewer than 257 colours
        key = (rgb[:, 0].astype(np.uint32) << 16
               | rgb[:, 1].astype(np.uint32) << 8 | rgb[:, 2])
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) <= 256:
            palette = np.stack([uniq >> 16, (uniq >> 8) & 0xff, uniq & 0xff],
                               -1).astype(np.uint8)
            return palette, inv.astype(np.uint8).reshape(f.shape[:2])
    used = np.flatnonzero(hist)
    cells = np.stack([used >> 10, (used >> 5) & 31, used & 31], -1)
    box_of_cell = np.zeros(1 << 15, np.int64)
    box_of_cell[used] = _median_cut(cells, hist[used], 256)
    idx = box_of_cell[cell]
    count = np.bincount(idx)
    palette = np.stack([np.bincount(idx, rgb[:, ch].astype(np.float64))
                        for ch in range(3)], -1) / count[:, None]
    return (np.rint(palette).astype(np.uint8),
            idx.astype(np.uint8).reshape(f.shape[:2]))


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def encode(frames: Iterable[np.ndarray], fps: float) -> bytes:
    """uint8 (H, W) or (H, W, 3) frames of one size -> GIF89a bytes."""
    frames = list(frames)
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    delay = frame_delay(fps)
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0), _LOOP_FOREVER]
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"GIF frame {f.shape[:2]} differs from the "
                             f"first frame's {(h, w)}")
        palette, idx = quantize(f)
        bits = max(1, int(len(palette) - 1).bit_length())
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        min_code = max(2, bits)
        out += [
            # graphic control: no disposal, the delay, no transparency
            b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00",
            # image descriptor with a local colour table of 2^bits entries
            b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1)),
            table.tobytes(), bytes([min_code]),
            _sub_blocks(codec.lzw(idx, min_code))]
    out.append(b"\x3b")
    return b"".join(out)


def describe(data: bytes) -> Dict:
    """Walk a GIF's blocks without decoding them: its canvas ``size`` (W,
    H), ``frames`` (image descriptors), each frame's ``delays``
    (hundredths of a second) and whether it ``loops`` (a NETSCAPE2.0
    block). Raises ValueError on a truncated stream or a missing
    trailer."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    info = {"size": (w, h), "frames": 0, "delays": [], "loops": False}

    def skip_sub_blocks(p):
        while True:
            if p >= len(data):
                raise ValueError("GIF data ends inside a block")
            if data[p] == 0:
                return p + 1
            p += data[p] + 1

    while pos < len(data):
        kind = data[pos]
        if kind == 0x3b:
            return info
        if kind == 0x21:
            label = data[pos + 1]
            if label == 0xf9:
                info["delays"].append(struct.unpack(
                    "<H", data[pos + 4:pos + 6])[0])
            elif label == 0xff and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                info["loops"] = True
            pos = skip_sub_blocks(pos + 2)
        elif kind == 0x2c:
            fl = data[pos + 9]
            pos += 10 + (3 << ((fl & 7) + 1) if fl & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)    # after the LZW code size
            info["frames"] += 1
        else:
            raise ValueError(f"unknown GIF block 0x{kind:02x} at byte {pos}")
    raise ValueError("GIF has no trailer")


def mimsave(path: str, frames: Iterable[np.ndarray], fps: float) -> None:
    """Write ``frames`` as a looping GIF at ``fps``."""
    data = encode(frames, fps)
    with open(path, "wb") as fh:
        fh.write(data)
