"""Metrics writer: local JSONL always, wandb only when asked for.

Counterpart of ``sin_inn_tpu/core/metrics.py``. Scalars go to
``<directory>/<run_name>.metrics.jsonl`` (one record per ``log``) and the
hyperparameters to ``<run_name>.config.json``. wandb is imported only when
``use_wandb`` is set (scalars, sample frames, the flow and occlusion
videos), and a missing or failing wandb leaves the local logs alone;
``log_artifact`` writes a metadata sidecar beside an artifact.
Single-process runs are always the primary process (multi-GPU runs come
with their slice).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricsWriter:
    def __init__(self, directory: str, run_name: str = "run",
                 use_wandb: bool = False, wandb_project: Optional[str] = None,
                 hyperparams: Optional[Dict[str, Any]] = None):
        self.directory = directory
        self._t0 = time.time()
        self._wandb = None
        os.makedirs(directory, exist_ok=True)
        self.jsonl_path = os.path.join(directory, f"{run_name}.metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project or "sin-inn",
                                         name=run_name,
                                         config=hyperparams or {})
            except Exception:
                self._wandb = None
        if hyperparams is not None:
            with open(os.path.join(directory, f"{run_name}.config.json"),
                      "w") as f:
                json.dump({k: _to_py(v) for k, v in hyperparams.items()},
                          f, indent=2, default=str)

    def log(self, step: int, scalars: Dict[str, Any]):
        rec = {"step": int(step), "time": time.time() - self._t0}
        rec.update({k: _to_py(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_artifact(self, path: str, metadata: Dict[str, Any]):
        """Write a metadata JSON sidecar beside an artifact file."""
        with open(path + ".json", "w") as f:
            json.dump({k: _to_py(v) for k, v in metadata.items()}, f,
                      indent=2)

    @property
    def wants_media(self) -> bool:
        """True when media logging would reach wandb."""
        return self._wandb is not None

    def log_media(self, step: int, name: str, frames, fps: int = 4):
        """Log a video (``frames``: (T, H, W, C) uint8) to wandb when
        enabled; the local GIFs are the callers' own."""
        if self._wandb is None:
            return
        import numpy as np
        import wandb

        arr = np.asarray(frames)
        if arr.ndim == 3:
            arr = arr[None]
        # wandb.Video takes (T, C, H, W)
        self._wandb.log({name: wandb.Video(arr.transpose(0, 3, 1, 2),
                                           fps=fps, format="gif")},
                        step=step)

    def log_image(self, step: int, name: str, image):
        """Log one image to wandb when enabled."""
        if self._wandb is None:
            return
        import numpy as np
        import wandb

        self._wandb.log({name: wandb.Image(np.asarray(image))}, step=step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
