"""GIF89a reader and writer of the port, in place of imageio's ``mimread``
/ ``get_reader`` on a GIF and its ``mimsave(..., "GIF")``.

Reading (:func:`mimread`, :func:`iter_frames`) gives the frames
``imageio.v2.mimread`` gives through Pillow (its default loading strategy,
the first frame in palette mode, the rest composited in RGB or RGBA):

  * the first frame is the palette image over the logical screen (indices
    outside the frame's extent 0, or the transparent index where the frame
    has one), each index through the frame's palette (local, else global;
    an index past the palette's end reads black) -> (H, W, 3) uint8; a
    GIF without colour palettes (none, or only the grey ramp) gives (H, W);
  * later frames are pasted on the previous composite within their extent,
    their transparent pixels left as they were; the composite is RGBA from
    the second frame on when the first frame named a transparent index,
    else RGB;
  * before a frame is drawn, the previous frame's extent is disposed as its
    graphic control said (a frame without one keeps the last method given):
    2 fills it with the transparent index's colour (alpha 0) or else the
    background's, 3 restores what was there before that frame was drawn;
  * interlaced frames, global and local palettes, LZW codes of 3-12 bits.

The LZW codes are ``io/codec.py``'s (C++ where ``g++`` is found).

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
from typing import Dict, Iterable, Iterator, List, Tuple

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


def _ramp_palette(raw: bytes) -> bool:
    """Pillow's test for a palette that only lists grey levels in order."""
    return all(raw[i] == raw[i + 1] == raw[i + 2] == i // 3
               for i in range(0, len(raw), 3))


def _lut(raw) -> np.ndarray:
    """A palette as Pillow holds it: 256 entries, black past its end (and
    the grey ramp where there is none)."""
    if not raw:
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    lut = np.zeros((256, 3), np.uint8)
    if raw:
        pal = np.frombuffer(raw, np.uint8).reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
    return lut


def _colours(lut: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(h, w) indices -> (h, w, 4) uint8: each index's colour, alpha 255
    (one 32-bit gather a pixel)."""
    rgba = np.concatenate([lut, np.full((256, 1), 255, np.uint8)], 1)
    return rgba.view(np.uint32).reshape(256).take(idx).view(
        np.uint8).reshape(idx.shape + (4,))


_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def _frame_indices(data: bytes, pos: int, name: str):
    """The image descriptor at ``pos`` -> (extent, local palette bytes or
    None, (h, w) uint8 indices, the position after its data)."""
    if pos + 10 > len(data):
        raise ValueError(f"{name}: GIF ends inside an image descriptor")
    x0, y0, fw, fh, flags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    pos += 10
    local = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        local = data[pos:pos + n]
        pos += n
    if pos >= len(data):
        raise ValueError(f"{name}: GIF ends before its image data")
    min_code = data[pos]
    pos += 1
    chunks = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: GIF data ends inside a frame")
        n = data[pos]
        if n == 0:
            pos += 1
            break
        chunks.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    idx = np.zeros(fw * fh, np.uint8)
    got = codec.unlzw(b"".join(chunks), min_code, fw * fh)
    idx[:len(got)] = got
    known = np.zeros(fw * fh, bool)
    known[:len(got)] = True
    if flags & 0x40:                       # interlaced: rows in four passes
        order = np.concatenate([np.arange(a, fh, b) for a, b in _INTERLACE])
        rows, krows = np.zeros((fh, fw), np.uint8), np.zeros((fh, fw), bool)
        rows[order] = idx.reshape(fh, fw)
        krows[order] = known.reshape(fh, fw)
        idx, known = rows, krows
    return ((x0, y0, x0 + fw, y0 + fh), local, idx.reshape(fh, fw),
            known.reshape(fh, fw), pos)


def iter_frames(path: str) -> Iterator[np.ndarray]:
    """The frames of a GIF file as ``imageio.v2.get_reader`` yields them
    (module docstring)."""
    with open(path, "rb") as fh:
        data = fh.read()
    yield from _decode_frames(data, str(path))


def mimread(path: str) -> List[np.ndarray]:
    """Every frame of a GIF file, as ``imageio.v2.mimread`` returns them."""
    return list(iter_frames(path))


def _decode_frames(data: bytes, name: str) -> Iterator[np.ndarray]:
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    sw, sh, flags, background = struct.unpack("<HHBB", data[6:12])
    pos = 13
    global_pal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        raw = data[pos:pos + n]
        pos += n
        if not _ramp_palette(raw):
            global_pal = raw
    else:
        background = 0
    mode, im = None, None          # the composite: "P", "L", "RGB", "RGBA"
    info_trns = None               # the first frame's transparent index
    disposal = 0
    dispose = None                 # (patch, extent) pasted before the next
    frame = 0
    while pos < len(data):
        trns = None
        while True:                # extensions up to the image descriptor
            if pos >= len(data):
                raise ValueError(f"{name}: GIF has no trailer")
            kind = data[pos]
            if kind == 0x3b:
                return
            if kind == 0x2c:
                break
            if kind != 0x21:
                raise ValueError(f"{name}: unknown GIF block 0x{kind:02x} "
                                 f"at byte {pos}")
            label, p = data[pos + 1], pos + 2
            first = None
            while True:
                if p >= len(data):
                    raise ValueError(f"{name}: GIF ends inside a block")
                n = data[p]
                if first is None:
                    first = data[p + 1:p + 1 + n]
                p += 1 + n
                if n == 0:
                    break
            if label == 0xf9 and first:
                if first[0] & 1:
                    trns = first[3]
                if (first[0] >> 2) & 7:
                    disposal = (first[0] >> 2) & 7
            pos = p
        extent, local, idx, known, pos = _frame_indices(data, pos, name)
        x0, y0, x1, y1 = extent
        if x1 > sw or y1 > sh:
            raise ValueError(f"{name}: a GIF frame reaching past the logical "
                             f"screen is not supported")
        if local is not None and _ramp_palette(local):
            local = False
        pal = local if local is not None else global_pal
        if dispose is not None:
            patch, (dx0, dy0, dx1, dy1) = dispose
            im[dy0:dy1, dx0:dx1] = patch
        if frame == 0:
            mode = "P" if pal else "L"
        elif mode == "P":
            rgba = _colours(_lut(first_pal), im)
            if info_trns is not None:
                rgba[..., 3][im == info_trns] = 0
                im, mode = rgba, "RGBA"
                info_trns = None
            else:
                im, mode = np.ascontiguousarray(rgba[..., :3]), "RGB"
        lut = _lut(pal)

        def fill_colour(index):
            if pal and index * 3 + 3 > len(pal):
                index = 0
            return lut[index] if pal else np.array([index] * 3, np.uint8)

        dispose = None
        if disposal == 2:
            colour = info_trns if info_trns is not None else trns
            if colour is not None:
                val = (np.append(fill_colour(colour), 0)
                       if mode in ("RGB", "RGBA") else colour)
            else:
                val = (fill_colour(background) if mode in ("RGB", "RGBA")
                       else background)
            if mode == "RGB":
                val = np.asarray(val)[:3]
            elif mode == "RGBA" and len(val) == 3:
                val = np.append(val, 255)
            dispose = (val, extent)
        elif disposal >= 3:
            if frame > 0:
                dispose = (im[y0:y1, x0:x1].copy(), extent)
            elif trns is not None:
                dispose = (trns, extent)
        if frame == 0:
            fill = trns if trns is not None else 0
            base = np.full((sh, sw), fill, np.uint8)
            base[y0:y1, x0:x1] = np.where(known, idx, fill)
            im = base
            first_pal = pal
            if trns is not None:
                info_trns = trns
            yield (_colours(lut, im)[..., :3] if mode == "P" else im.copy())
        elif mode in ("RGB", "RGBA"):
            if not pal:
                lut = _lut(None)
            if trns is None and pal:
                # pixels the stream did not reach keep the fill, index 0
                idx = np.where(known, idx, 0).astype(np.uint8)
                keep = None
            else:
                keep = ~known if trns is None else (~known) | (idx == trns)
            new = _colours(lut, idx)[..., :im.shape[2]]
            region = im[y0:y1, x0:x1]
            if keep is None or not keep.any():
                region[...] = new
            else:
                region[...] = np.where(keep[..., None], region, new)
            yield im.copy()
        else:
            if pal:
                raise ValueError(f"{name}: a grey GIF whose later frame has "
                                 f"a colour palette is not supported")
            region = im[y0:y1, x0:x1]
            keep = (~known) if trns is None else (~known) | (idx == trns)
            region[...] = np.where(keep, region, idx)
            yield im.copy()
        frame += 1
    raise ValueError(f"{name}: GIF has no trailer")


def mimsave(path: str, frames: Iterable[np.ndarray], fps: float) -> None:
    """Write ``frames`` as a looping GIF at ``fps``."""
    data = encode(frames, fps)
    with open(path, "wb") as fh:
        fh.write(data)
