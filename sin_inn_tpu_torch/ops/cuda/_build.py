"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``sin_inn_tpu_torch/csrc`` has a plain C interface and is
compiled on first use into ``sin_inn_tpu_torch/build`` (listed in
``.gitignore``) as a shared library whose name carries a hash of the source
and the flags, so an edited source never loads a stale build. The target is
``sm_90a`` (Hopper with ``wgmma``/``setmaxnreg``). :func:`build_all` starts one
nvcc per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

SOURCES = {"coupling_1x1": "coupling_1x1.cu",
           "coupling_1x1_bwd": "coupling_1x1_bwd.cu",
           "gather_region": "gather_region.cu",
           "splat_region": "splat_region.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float     # 0.0 when an existing build was reused
    log: str           # nvcc's output (ptxas register / spill report)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) \
            + [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "sin_inn_tpu_torch are compiled on first use")


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile every named source not built yet, all nvcc runs in parallel."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Built] = {}
    running = {}
    for name in names:
        out = _target(name)
        if out.exists():
            done[name] = Built(out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = Built(out, seconds, log)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return done


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built if needed."""
    return ctypes.CDLL(str(build_all([name])[name].path))
