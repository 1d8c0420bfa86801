"""ctypes binding of the native C++ batch loader (``native/loader.cpp``).

Counterpart of ``sin_inn_tpu/data/native.py``. The port reads the same
source, unchanged, and builds its own copy of the library on first use with
``g++`` and the flags of ``native/Makefile`` into ``sin_inn_tpu_torch/build``
(listed in ``.gitignore``), under a name that carries a hash of the source
and the flags; ``native/`` itself is left to the JAX package. It exposes:

  * :func:`gather_windows`: the channel-concat LR windows in one pass;
  * :func:`gather_frames`: a batch of whole frames;
  * :class:`Prefetcher`: batches assembled ahead by a background thread,
    double buffered.

This is host code, not a kernel. Where ``g++`` is absent, :func:`available`
is False and ``data/sr_video.py`` takes its numpy route; a compiler that is
present but fails on the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "build"
# native/Makefile's CXXFLAGS, -shared and its link line
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-lpthread",)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path(source: Path, stem: str, flags=CXX_FLAGS,
                 libs=()) -> Path:
    """Where ``source`` builds: ``BUILD_DIR``, under a name that carries a
    hash of the source and the flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(tuple(flags) + tuple(libs)).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def _target() -> Path:
    return library_path(SOURCE, "libsininn_loader", CXX_FLAGS, LIBS)


def build_library(source: Path, stem: str, cxx: str,
                  flags=CXX_FLAGS, libs=()) -> Path:
    """Build ``source`` with ``cxx`` at :func:`library_path` once; returns
    the path. A compiler that fails raises."""
    out = library_path(source, stem, flags, libs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *flags, "-o", str(tmp), str(source), *libs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{source.name} build failed ({cxx} exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)    # atomic: parallel builds race harmlessly
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library(SOURCE, "libsininn_loader",
                                                  cxx, CXX_FLAGS, LIBS)))
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_windows.argtypes = [u8p, i64, i64, i64, i64, i64p, i64,
                                       i64, u8p]
        lib.gather_windows.restype = None
        lib.gather_frames.argtypes = [u8p, i64, i64, i64, i64p, i64, u8p]
        lib.gather_frames.restype = None
        lib.prefetcher_create.argtypes = [u8p, i64, i64, i64, i64, u8p, i64,
                                          i64, i64, i64p, i64p, i64, i64, i64]
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_next.argtypes = [ctypes.c_void_p, u8p, u8p]
        lib.prefetcher_next.restype = i64
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.prefetcher_destroy.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the native loader is built (or can be): ``g++`` is found."""
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8(a: np.ndarray) -> np.ndarray:
    if a.dtype != np.uint8 or a.ndim != 4:
        raise ValueError(f"expected (n, h, w, c) uint8 frames, got "
                         f"{a.dtype} {a.shape}")
    return np.ascontiguousarray(a)


def _indices(idx: np.ndarray, n: int) -> np.ndarray:
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"frame index out of range [0, {n})")
    return idx


def gather_windows(lr: np.ndarray, window_idx: np.ndarray) -> np.ndarray:
    """lr: (N, h, w, c) uint8; window_idx: (B, T) -> (B, h, w, T*c) uint8,
    each pixel's channels frame by frame."""
    lib = _load()
    lr = _u8(lr)
    n, h, w, c = lr.shape
    idx = _indices(window_idx, n)
    b, t = idx.shape
    out = np.empty((b, h, w, t * c), np.uint8)
    lib.gather_windows(_u8p(lr), n, h, w, c, _i64p(idx), b, t, _u8p(out))
    return out


def gather_frames(frames: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """frames: (N, H, W, C) uint8; idx: (B,) -> (B, H, W, C) uint8."""
    lib = _load()
    frames = _u8(frames)
    n, h, w, c = frames.shape
    idx = _indices(idx, n).reshape(-1)
    out = np.empty((len(idx), h, w, c), np.uint8)
    lib.gather_frames(_u8p(frames), h, w, c, _i64p(idx), len(idx), _u8p(out))
    return out


class Prefetcher:
    """Batches of ``order``'s samples, ``batch`` at a time, assembled ahead
    by a background thread (double buffered): ``{"hr", "lr"}`` uint8 numpy
    arrays, the last batch possibly short. ``window_idx`` (S, T) holds each
    sample's LR window, ``hr_idx`` (S,) its HR frame."""

    _handle = None

    def __init__(self, lr: np.ndarray, hr: np.ndarray,
                 window_idx: np.ndarray, hr_idx: np.ndarray,
                 order: np.ndarray, batch: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++)")
        self._lib = lib
        # the C++ thread reads these buffers: keep them alive with self
        self._lr = _u8(lr)
        self._win = _indices(window_idx, self._lr.shape[0])
        n_samples, t = self._win.shape
        # the worker takes a sample's id as its HR row: gather the HR frames
        # in sample order once
        self._hr = np.ascontiguousarray(_u8(hr)[np.asarray(hr_idx)])
        self._order = _indices(order, n_samples)
        self.batch = int(batch)
        n, lh, lw, lc = self._lr.shape
        _, hh, hw, hc = self._hr.shape
        self._shapes = (lh, lw, t * lc, hh, hw, hc)
        self._handle = lib.prefetcher_create(
            _u8p(self._lr), n, lh, lw, lc, _u8p(self._hr), hh, hw, hc,
            _i64p(self._win), _i64p(self._order), len(self._order), t,
            self.batch)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._handle:
            raise StopIteration
        lh, lw, lcw, hh, hw, hc = self._shapes
        lr_out = np.empty((self.batch, lh, lw, lcw), np.uint8)
        hr_out = np.empty((self.batch, hh, hw, hc), np.uint8)
        n = self._lib.prefetcher_next(self._handle, _u8p(lr_out),
                                      _u8p(hr_out))
        if n <= 0:
            self.close()
            raise StopIteration
        return {"hr": hr_out[:n], "lr": lr_out[:n]}

    def close(self) -> None:
        if self._handle:
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
