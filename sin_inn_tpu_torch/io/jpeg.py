"""JPEG reader of the port, in place of ``imageio.v2.imread`` on a JPEG.

:func:`imread` / :func:`decode` return what ``imageio.v2.imread`` returns
through Pillow and libjpeg-turbo's defaults: (H, W, 3) uint8 for a colour
file, (H, W) uint8 for a grey one, the EXIF orientation not applied. It
decodes baseline, extended and progressive Huffman JPEG with 8-bit samples,
one component (grey) or three (YCbCr, or RGB where an Adobe marker or the
component ids say so), any sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0, ...),
restart intervals and any number of scans; JFIF, EXIF, ICC and other
application markers are skipped. The arithmetic is libjpeg-turbo's:

  * the accurate integer IDCT (``jidctint.c``, "islow") with its 10-bit
    range limit;
  * fancy upsampling: the triangle filter for 2h1v and 2h2v (a component
    more than two samples wide; else each sample repeated), and for 1h2v;
    the edges replicated; other ratios repeat each sample;
  * the fixed-point YCbCr -> RGB tables of ``jdcolor.c``.

It raises ValueError, naming the file and the feature, on arithmetic
coding, lossless or hierarchical frames, 12-bit samples, CMYK / YCCK (four
components) and a file that ends before its last scan or its EOI marker;
and, naming the fault, on malformed headers where libjpeg stops too: a
Huffman table whose codes do not fit their lengths or whose DC values pass
15, a scan that names no component, a component twice or a table above 3,
and a progressive scan outside libjpeg's progression rules (Ss <= Se <= 63,
Se = 0 in a DC scan, one component in an AC scan, Al = Ah - 1 in a
refinement, Al <= 13). A sequential frame's scan values Ss, Se, Ah and Al
are ignored, as libjpeg ignores them.

The Huffman decoding, the IDCT, the upsampling and the colour conversion
are ``io/codec.cpp``'s (C++ built with ``g++`` on first use); where ``g++``
is absent a numpy / Python route gives the same arrays (slowly), and
``codec.route_counts()`` tells which ran.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Optional

import numpy as np

from sin_inn_tpu_torch.io import codec

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)
_SOF_KIND = {0xC0: "baseline", 0xC1: "extended", 0xC2: "progressive"}
_SOF_UNSUPPORTED = {
    0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
    0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded "
    "hierarchical", 0xCF: "arithmetic-coded hierarchical lossless"}


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q: Optional[np.ndarray] = None     # latched at its first scan
        self.coef: Optional[np.ndarray] = None  # (rows, per row, 64) int16


def imread(path: str) -> np.ndarray:
    """Read a JPEG file as ``imageio.v2.imread`` does (module docstring)."""
    with open(path, "rb") as fh:
        return decode(fh.read(), name=str(path))


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> the array ``imageio.v2.imread`` gives for them."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[int, bytes] = {}       # class * 4 + id -> 16 counts + values
    comps: List[_Component] = []
    frame = None
    restart = 0
    adobe: Optional[int] = None
    jfif = False
    pos = 2
    lib = codec.loaded()
    codec.count("numpy" if lib is None else "native")

    def truncated():
        return ValueError(f"{name}: JPEG data is truncated")

    while True:
        # next marker, past fill bytes
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise truncated()
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > len(data):
            raise truncated()
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        if len(seg) != seglen - 2:
            raise truncated()
        pos += seglen
        if m in _SOF_UNSUPPORTED:
            raise ValueError(f"{name}: {_SOF_UNSUPPORTED[m]} JPEG is not "
                             f"supported")
        if m in _SOF_KIND:
            frame = _read_sof(seg, m, name, comps)
        elif m == 0xC4:
            _read_dht(seg, huff, name)
        elif m == 0xDB:
            _read_dqt(seg, qt, name)
        elif m == 0xDD:
            if len(seg) != 2:
                raise ValueError(f"{name}: bad JPEG restart interval")
            (restart,) = struct.unpack(">H", seg)
        elif m == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            pos = _scan(buf, data, pos, seg, frame, comps, qt, huff, restart,
                        lib, name)
            if pos < 0:
                raise truncated()
    if frame is None or any(c.coef is None for c in comps):
        raise truncated()
    return _output(frame, comps, jfif, adobe, lib, name)


def _read_sof(seg: bytes, m: int, name: str, comps: List[_Component]):
    if len(seg) < 6:
        raise ValueError(f"{name}: bad JPEG frame header")
    prec, h, w, n = struct.unpack(">BHHB", seg[:6])
    if prec != 8:
        raise ValueError(f"{name}: {prec}-bit JPEG samples are not "
                         f"supported (8-bit only)")
    if n == 4:
        raise ValueError(f"{name}: CMYK / YCCK JPEG (4 components) is not "
                         f"supported")
    if n not in (1, 3):
        raise ValueError(f"{name}: JPEG with {n} components is not "
                         f"supported")
    if h == 0 or w == 0:
        raise ValueError(f"{name}: JPEG of size {w} x {h} (a DNL marker) "
                         f"is not supported")
    if len(seg) != 6 + 3 * n:
        raise ValueError(f"{name}: bad JPEG frame header")
    comps.clear()
    for i in range(n):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    if n == 1:          # one component: its own sampling does not matter
        comps[0].h = comps[0].v = 1
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if c.h not in (1, 2, 3, 4) or c.v not in (1, 2, 3, 4) or \
                hmax % c.h or vmax % c.v:
            raise ValueError(f"{name}: JPEG sampling {c.h}x{c.v} of "
                             f"{hmax}x{vmax} is not supported")
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    for c in comps:
        c.dw, c.dh = -(-w * c.h // hmax), -(-h * c.v // vmax)
        c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)      # blocks it really has
        c.aw, c.ah = mcux * c.h, mcuy * c.v            # blocks it holds
        c.coef = None
    return {"kind": _SOF_KIND[m], "h": h, "w": w, "hmax": hmax,
            "vmax": vmax, "mcux": mcux, "mcuy": mcuy}


def _read_dht(seg: bytes, huff: Dict[int, bytes], name: str) -> None:
    p = 0
    while p < len(seg):
        tc, th = seg[p] >> 4, seg[p] & 15
        counts = seg[p + 1:p + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or len(counts) < 16 or n > 256 or \
                p + 17 + n > len(seg):
            raise ValueError(f"{name}: bad JPEG Huffman table")
        vals = seg[p + 17:p + 17 + n]
        # libjpeg's JERR_BAD_HUFF_TABLE: the canonical codes must fit their
        # lengths, and a DC table's values are bit counts of at most 15
        code = 0
        for ln, k in enumerate(counts, 1):
            code += k
            if code >= 1 << ln:
                raise ValueError(f"{name}: bad JPEG Huffman table (more "
                                 f"codes than fit their lengths)")
            code <<= 1
        if tc == 0 and any(v > 15 for v in vals):
            raise ValueError(f"{name}: bad JPEG Huffman table (a DC value "
                             f"above 15)")
        huff[tc * 4 + th] = bytes(counts) + bytes(vals) + bytes(256 - n)
        p += 17 + n


def _read_dqt(seg: bytes, qt: Dict[int, np.ndarray], name: str) -> None:
    p = 0
    while p < len(seg):
        pq, tq = seg[p] >> 4, seg[p] & 15
        size = 128 if pq else 64
        if tq > 3 or p + 1 + size > len(seg):
            raise ValueError(f"{name}: bad JPEG quantisation table")
        raw = np.frombuffer(seg[p + 1:p + 1 + size], ">u2" if pq else np.uint8)
        table = np.empty(64, np.uint16)
        table[ZIGZAG[:64]] = raw
        qt[tq] = table
        p += 1 + size


def _scan(buf, data, pos, seg, frame, comps, qt, huff, restart, lib, name):
    ns = seg[0] if seg else 0
    if not 1 <= ns <= len(comps) or len(seg) != 4 + 2 * ns:
        raise ValueError(f"{name}: bad JPEG scan header ({ns} components)")
    sel = []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        match = [c for c in comps if c.id == cid]
        if not match:
            raise ValueError(f"{name}: JPEG scan names component {cid}, "
                             f"which the frame lacks")
        if any(c is match[0] for c, _, _ in sel):
            raise ValueError(f"{name}: JPEG scan names component {cid} "
                             f"twice")
        if tables >> 4 > 3 or tables & 15 > 3:
            raise ValueError(f"{name}: JPEG scan names Huffman tables "
                             f"{tables >> 4} / {tables & 15} (0-3 only)")
        sel.append((match[0], tables >> 4, tables & 15))
    ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    if frame["kind"] != "progressive":
        # libjpeg warns of other values in a sequential frame and ignores them
        ss, se, ah, al = 0, 63, 0, 0
    elif (se != 0 if ss == 0 else ss > se or se > 63 or ns != 1) or \
            (ah != 0 and al != ah - 1) or al > 13:
        # libjpeg's JERR_BAD_PROGRESSION
        raise ValueError(f"{name}: bad JPEG progression (Ss={ss}, Se={se}, "
                         f"Ah={ah}, Al={al}, {ns} components)")
    for c, td, ta in sel:
        if c.coef is None:
            c.coef = np.zeros((c.ah, c.aw, 64), np.int16)
        if c.q is None:
            if c.tq not in qt:
                raise ValueError(f"{name}: JPEG quantisation table {c.tq} "
                                 f"is missing")
            c.q = qt[c.tq].copy()
        if frame["kind"] != "progressive":
            need = [td, 4 + ta]
        elif ss == 0:
            need = [] if ah else [td]       # a DC refinement reads raw bits
        else:
            need = [4 + ta]
        for t in need:
            if t not in huff:
                raise ValueError(f"{name}: JPEG Huffman table {t % 4} "
                                 f"({'AC' if t >= 4 else 'DC'}) is missing")
    tables = bytearray(8 * 272)
    for t, body in huff.items():
        tables[t * 272:(t + 1) * 272] = body
    info = np.array([[i, c.h, c.v, c.aw, c.ah, c.bw, c.bh, td, ta]
                     for i, (c, td, ta) in enumerate(sel)], np.int32)
    if ns == 1:     # a lone component's blocks are its units, 1 x 1
        info[0, 1] = info[0, 2] = 1
    if lib is None:
        return _scan_python(data, pos, info, [c.coef for c, _, _ in sel],
                            bytes(tables), ss, se, ah, al, restart,
                            frame["mcux"], frame["mcuy"])
    ptrs = (ctypes.c_void_p * ns)(*[c.coef.ctypes.data for c, _, _ in sel])
    tab = np.frombuffer(bytes(tables), np.uint8)
    end = lib.jpeg_scan(codec.ptr(buf), len(data), pos, ns, codec.ptr(info),
                        ptrs, codec.ptr(tab), ss, se, ah, al, restart,
                        frame["mcux"], frame["mcuy"])
    if end == -2:       # codec.cpp's own guard; the checks above come first
        raise ValueError(f"{name}: bad JPEG Huffman table or scan header")
    return end


def _output(frame, comps, jfif, adobe, lib, name) -> np.ndarray:
    h, w = frame["h"], frame["w"]
    planes = []
    for c in comps:
        plane = np.empty((c.ah * 8, c.aw * 8), np.uint8)
        if lib is None:
            _idct_numpy(c.coef, c.q, plane)
        else:
            lib.jpeg_idct(codec.ptr(c.coef), codec.ptr(c.q), c.aw, c.ah,
                          codec.ptr(plane))
        rh, rv = frame["hmax"] // c.h, frame["vmax"] // c.v
        if rh == rv == 1:
            planes.append(np.ascontiguousarray(plane[:h, :w]))
            continue
        full = np.empty((h, w), np.uint8)
        if lib is None:
            _upsample_numpy(plane, c.dw, c.dh, rh, rv, full)
        else:
            lib.jpeg_upsample(codec.ptr(plane), plane.shape[1], c.dw, c.dh,
                              rh, rv, codec.ptr(full), w, h)
        planes.append(full)
    if len(planes) == 1:
        return planes[0]
    ids = tuple(c.id for c in comps)
    rgb = (adobe == 0) if adobe is not None and not jfif else (
        not jfif and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1)
    out = np.empty((h, w, 3), np.uint8)
    if lib is None:
        out[:] = _ycc_rgb_numpy(*planes)
    else:
        lib.jpeg_ycc_rgb(codec.ptr(planes[0]), codec.ptr(planes[1]),
                         codec.ptr(planes[2]), h * w, codec.ptr(out))
    return out


# -- the numpy / Python route --------------------------------------------------

class _PyBits:
    """codec.cpp's ``Bits``: bytes past a marker or the end read as 0."""

    def __init__(self, data: bytes, pos: int):
        self.d, self.n, self.pos = data, len(data), pos
        self.acc = self.bits = 0
        self.at_marker = self.truncated = False

    def _byte(self) -> int:
        if self.at_marker:
            return 0
        d, p = self.d, self.pos
        if p >= self.n or (d[p] == 0xFF and p + 1 >= self.n):
            self.truncated = self.at_marker = True
            return 0
        if d[p] == 0xFF:
            if d[p + 1] == 0:
                self.pos += 2
                return 0xFF
            self.at_marker = True
            return 0
        self.pos += 1
        return d[p]

    def get(self, k: int) -> int:
        while self.bits < k:
            self.acc = (self.acc << 8) | self._byte()
            self.bits += 8
        self.bits -= k
        v = self.acc >> self.bits
        self.acc &= (1 << self.bits) - 1
        return v

    def peek16(self) -> int:
        while self.bits < 16:
            self.acc = (self.acc << 8) | self._byte()
            self.bits += 8
        return self.acc >> (self.bits - 16)

    def skip(self, k: int) -> None:
        self.bits -= k
        self.acc &= (1 << self.bits) - 1

    def restart(self) -> None:
        self.acc = self.bits = 0
        d, p = self.d, self.pos
        if not self.truncated and p + 1 < self.n and d[p] == 0xFF and \
                0xD0 <= d[p + 1] <= 0xD7:
            self.pos += 2
        self.at_marker = False


def _py_table(body: bytes):
    """{(length, code): value} of a table's canonical codes."""
    counts, vals = body[:16], body[16:]
    lookup = {}
    code = k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            lookup[(ln, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return lookup


def _py_decode(br: _PyBits, table) -> int:
    top = br.peek16()
    for ln in range(1, 17):
        v = table.get((ln, top >> (16 - ln)))
        if v is not None:
            br.skip(ln)
            return v
    br.skip(16)          # a corrupt code: libjpeg warns and takes 0
    return 0


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _scan_python(data, pos, info, coefs, tables, ss, se, ah, al, restart,
                 mcux, mcuy) -> int:
    tabs = [_py_table(tables[t * 272:(t + 1) * 272]) for t in range(8)]
    br = _PyBits(data, pos)
    dc_pred = [0] * 4
    eob = [0]
    progressive = not (ss == 0 and se == 63 and ah == 0 and al == 0)
    zz = ZIGZAG.tolist()

    def block(c, blk):
        dc, ac = tabs[info[c][7]], tabs[4 + info[c][8]]
        if not progressive:
            s = _py_decode(br, dc)
            dc_pred[c] += _extend(br.get(s), s)
            blk[0] = dc_pred[c]
            k = 1
            while k < 64:
                rs = _py_decode(br, ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[zz[k]] = _extend(br.get(s), s)
                else:
                    if r != 15:
                        break
                    k += 15
                k += 1
            return
        if ss == 0:
            if ah == 0:
                s = _py_decode(br, dc)
                dc_pred[c] += _extend(br.get(s), s)
                blk[0] = dc_pred[c] * (1 << al)
            elif br.get(1):
                blk[0] |= 1 << al
            return
        if ah == 0:
            if eob[0] > 0:
                eob[0] -= 1
                return
            k = ss
            while k <= se:
                rs = _py_decode(br, ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[zz[k]] = _extend(br.get(s), s) * (1 << al)
                elif r == 15:
                    k += 15
                else:
                    eob[0] = (1 << r) + (br.get(r) if r else 0) - 1
                    break
                k += 1
            return
        p1, m1 = 1 << al, -(1 << al)

        def refine(i):
            if br.get(1) and (blk[i] & p1) == 0:
                blk[i] += p1 if blk[i] >= 0 else m1

        k = ss
        if eob[0] == 0:
            while k <= se:
                rs = _py_decode(br, ac)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if br.get(1) else m1
                elif r != 15:
                    eob[0] = (1 << r) + (br.get(r) if r else 0)
                    break
                while k <= se:
                    i = zz[k]
                    if blk[i] != 0:
                        refine(i)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    blk[zz[k]] = s
                k += 1
        if eob[0] > 0:
            while k <= se:
                if blk[zz[k]] != 0:
                    refine(zz[k])
                k += 1
            eob[0] -= 1

    todo = [restart]

    def next_unit():
        if restart:
            if todo[0] == 0:
                br.restart()
                dc_pred[:] = [0] * 4
                eob[0] = 0
                todo[0] = restart
            todo[0] -= 1

    # decode into Python lists of each touched block, then store
    def run(c, by, bx):
        blk = coefs[c][by, bx].tolist()
        block(c, blk)
        coefs[c][by, bx] = blk

    if len(info) == 1:
        for by in range(info[0][6]):
            for bx in range(info[0][5]):
                next_unit()
                run(0, by, bx)
                if br.truncated:
                    return -1
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                next_unit()
                for c in range(len(info)):
                    for v in range(info[c][2]):
                        for hh in range(info[c][1]):
                            run(c, my * info[c][2] + v, mx * info[c][1] + hh)
                if br.truncated:
                    return -1
    p = br.pos
    while p + 1 < len(data) and not (data[p] == 0xFF and data[p + 1] != 0
                                     and not 0xD0 <= data[p + 1] <= 0xD7):
        p += 1
    return p if p + 1 < len(data) else -1


_FIX = {k: v for k, v in (("0298", 2446), ("0390", 3196), ("0541", 4433),
                          ("0765", 6270), ("0899", 7373), ("1175", 9633),
                          ("1501", 12299), ("1847", 15137), ("1961", 16069),
                          ("2053", 16819), ("2562", 20995), ("3072", 25172))}


def _idct_1d(x):
    """The islow butterfly along axis 1 of (N, 8, M) int64 -> its 8 outputs
    before the final descale, as codec.cpp orders them."""
    F = _FIX
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * F["0541"]
    tmp2, tmp3 = z1 + z3 * -F["1847"], z1 + z2 * F["0765"]
    tmp0 = (x[:, 0] + x[:, 4]) * (1 << 13)
    tmp1 = (x[:, 0] - x[:, 4]) * (1 << 13)
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F["1175"]
    tmp0, tmp1 = tmp0 * F["0298"], tmp1 * F["2053"]
    tmp2, tmp3 = tmp2 * F["3072"], tmp3 * F["1501"]
    z1, z2 = z1 * -F["0899"], z2 * -F["2562"]
    z3, z4 = z3 * -F["1961"] + z5, z4 * -F["0390"] + z5
    tmp0, tmp1 = tmp0 + z1 + z3, tmp1 + z2 + z4
    tmp2, tmp3 = tmp2 + z2 + z3, tmp3 + z1 + z4
    return np.stack([t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
                     t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3], 1)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_numpy(coef: np.ndarray, q: np.ndarray, plane: np.ndarray) -> None:
    bh, bw = coef.shape[:2]
    x = (coef.reshape(-1, 8, 8).astype(np.int64)
         * q.reshape(8, 8).astype(np.int64))           # (N, row u, col v)
    # pass 1 along columns: axis 1 of (N, 8 rows, 8 cols)
    ws = _descale(_idct_1d(x), 11)
    # a column with no AC coefficient takes its DC alone, as libjpeg's does
    dc_only = (coef.reshape(-1, 8, 8)[:, 1:, :] == 0).all(1)
    ws = np.where(dc_only[:, None, :], (x[:, 0, :] * 4)[:, None, :], ws)
    # pass 2 along rows
    out = _descale(_idct_1d(ws.transpose(0, 2, 1)), 18)
    out = out.transpose(0, 2, 1) & 1023
    lim = np.empty(1024, np.uint8)
    i = np.arange(1024)
    lim[:] = np.where(i < 128, i + 128, np.where(i < 512, 255,
                                                  np.where(i < 896, 0,
                                                           i - 896)))
    plane[:] = lim[out].reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(bh * 8, bw * 8)


def _upsample_numpy(plane, dw, dh, rh, rv, out) -> None:
    h, w = out.shape
    p = plane[:dh, :dw].astype(np.int64)
    pad = np.pad(p, 1, mode="edge")
    if rh == 2 and dw > 2 and rv in (1, 2) or (rh == 1 and rv == 2):
        if rv == 2:
            cur = np.repeat(pad[1:-1], 2, 0)                 # rows r, r
            nb = np.empty_like(cur)
            nb[0::2], nb[1::2] = pad[:-2], pad[2:]           # r - 1, r + 1
            if rh == 1:
                bias = np.tile([1, 2], dh)[:, None]
                full = (cur[:, 1:-1] * 3 + nb[:, 1:-1] + bias) >> 2
                out[:] = full[:h, :w]
                return
            cs = cur * 3 + nb                                # column sums
            ev = (cs[:, 1:-1] * 3 + cs[:, :-2] + 8) >> 4
            od = (cs[:, 1:-1] * 3 + cs[:, 2:] + 7) >> 4
        else:
            ev = (pad[1:-1, 1:-1] * 3 + pad[1:-1, :-2] + 1) >> 2
            od = (pad[1:-1, 1:-1] * 3 + pad[1:-1, 2:] + 2) >> 2
        full = np.empty((ev.shape[0], 2 * dw), np.int64)
        full[:, 0::2], full[:, 1::2] = ev, od
        out[:] = full[:h, :w]
        return
    ys = np.minimum(np.arange(h) // rv, dh - 1)
    xs = np.minimum(np.arange(w) // rh, dw - 1)
    out[:] = p[ys][:, xs]


def _ycc_rgb_numpy(y, cb, cr) -> np.ndarray:
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (int(1.40200 * 65536 + 0.5) * x + half) >> 16
    cb_b = (int(1.77200 * 65536 + 0.5) * x + half) >> 16
    cr_g = -int(0.71414 * 65536 + 0.5) * x
    cb_g = -int(0.34414 * 65536 + 0.5) * x + half
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
