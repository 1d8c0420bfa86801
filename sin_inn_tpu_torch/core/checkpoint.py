"""Checkpoint store with latest-scan resume semantics, over ``torch.save``.

Counterpart of ``sin_inn_tpu/core/checkpoint.py``: each checkpoint is a
directory ``step_%010d`` under the store's directory, holding ``state.pt``;
restore takes the highest step unless one is named. Files are written to a
temporary name and renamed into place, so a crash never leaves a half
checkpoint under a step name. Loading uses ``weights_only=True``: tensors,
lists, dicts, numbers and strings only.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"


class CheckpointStore:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, state: Any) -> str:
        """Write ``state`` (anything ``torch.save`` takes with
        ``weights_only`` loading) as checkpoint ``step``."""
        path = self._path(step)
        tmp = tempfile.mkdtemp(prefix=".tmp_step_", dir=self.directory)
        try:
            torch.save(state, os.path.join(tmp, _FILE))
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return path

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _FILE)):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, map_location=None
                ) -> Tuple[Optional[Any], Optional[int]]:
        """Returns (state, step), or (None, None) when no checkpoint exists."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        state = torch.load(os.path.join(self._path(step), _FILE),
                           map_location=map_location, weights_only=True)
        return state, step
