"""Typed SR config with derived-field validation.

A copy of the reference package's ``SRConfig`` (``sin_inn_tpu/core/config.py``)
with three differences:

* ``device`` picks where entry points run: ``"cuda"`` (the default) or
  ``"cpu"``. A CUDA request without a card raises; nothing falls back.
* ``use_kernel`` replaces ``use_pallas``: ``"auto"`` routes every 1x1 GLOW
  coupling through the fused kernels (except in ``float32_highest``),
  ``"off"`` keeps them on plain convolutions.
* The multi-chip, profiling, auto-tuning and checkpoint-import fields are
  left out until their slices are ported.
* ``donate_state`` has no counterpart: the Adam step updates the
  parameters and its moments in place, so no second copy of the state is
  ever made.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

COMPUTE_DTYPES = ("float32", "bfloat16", "float32_highest")


def _octaves(scale: int) -> int:
    """Number of per-octave stages: ``(scale - 1).bit_length()``."""
    return (scale - 1).bit_length()


@dataclass(frozen=True)
class SRConfig:
    """Config for the INN space-time super-resolution pipeline."""

    # Dataset
    dataset: str = "datasets/adobe240f"
    scene: str = "IMG_0028_binning_4x"
    suffix: str = "default"
    fps: int = 10                 # HR fps; LR frames are assumed 120 fps
    lr_window: int = 10           # LR frames on either side of one HR frame
    batch_size: int = 8
    val_batch_size: int = 40

    # Architecture
    architecture: str = "SRF"     # 'SRF' | 'IRN'
    scale: int = 4
    num_coupling: int = 4
    clamp_srf: float = 1.2        # GLOW soft-clamp
    clamp_irn: float = 1.0        # InvBlockExp clamp
    hidden_channels: int = 256    # conv subnet width
    dense_gc: int = 32            # DenseBlock growth channels

    # Training
    epochs: int = 10_000
    save_iter: int = 100
    print_iter: int = 10
    learning_rate: float = 1e-4
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    weight_decay: float = 1e-5
    lambda_fwd_rec: float = 1.0
    lambda_fwd_mmd: float = 0.0
    lambda_latent_nll: float = 0.0
    lambda_bwd_rec: float = 1.0
    lambda_bwd_mmd: float = 0.0
    random_seed: int = 0

    # TCR (transformation-consistency regularization)
    lambda_bwd_tcr: float = 0.0
    rotation: float = 5.0         # degrees
    translation: float = 5.0      # pixels
    tcr_iters: int = 5
    tcr_stop_grad: bool = False

    # Inference
    temp: float = 0.8             # latent sampling temperature

    # Runtime
    working_dir: str = "experiments"
    resume_state: Optional[str] = None
    # subnet convolution precision (ops/subnet.py states the mapping):
    # 'float32' (TF32 convolutions), 'bfloat16' (bf16 conv inputs, fp32
    # outputs) or 'float32_highest' (full fp32, TF32 off)
    compute_dtype: str = "float32"
    # fused kernels for the 1x1-subnet GLOW couplings: 'auto' | 'off'
    use_kernel: str = "auto"
    # torch device string; entry points never fall back from 'cuda'
    device: str = "cuda"
    # per-coupling activation recompute in the backward (torch checkpoint)
    remat: bool = False

    def __post_init__(self):
        if self.architecture not in ("SRF", "IRN"):
            raise ValueError(f"unknown architecture {self.architecture!r}")
        if self.scale < 2 or (self.scale & (self.scale - 1)) != 0:
            raise ValueError(f"scale must be a power of two >= 2, got {self.scale}")
        if self.lr_window < 0:
            raise ValueError("lr_window must be >= 0")
        if self.z_dims <= 0:
            raise ValueError(
                f"lr_dims={self.lr_dims} >= total INN channels "
                f"{self.total_dims}; shrink lr_window or raise scale"
            )
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {self.compute_dtype!r}")
        if self.use_kernel not in ("auto", "off"):
            raise ValueError(f"use_kernel must be 'auto' or 'off', got "
                             f"{self.use_kernel!r}")

    # ---- derived fields ----

    @property
    def octaves(self) -> int:
        return _octaves(self.scale)

    @property
    def num_squeezes(self) -> int:
        """Initial squeeze + one per octave."""
        return 1 + self.octaves

    @property
    def total_dims(self) -> int:
        """Channel count after all squeezes of a 3-channel input."""
        return 3 * 4 ** self.num_squeezes

    @property
    def lr_dims(self) -> int:
        """(2*lr_window+1) RGGB LR frames stacked on channels."""
        return (2 * self.lr_window + 1) * 4

    @property
    def z_dims(self) -> int:
        return self.total_dims - self.lr_dims

    @property
    def clamp(self) -> float:
        return self.clamp_srf if self.architecture == "SRF" else self.clamp_irn

    @property
    def exp_name(self) -> str:
        return f"{self.scene}_{self.architecture}_{self.suffix}"

    def replace(self, **kw) -> "SRConfig":
        return dataclasses.replace(self, **kw)
