"""Typed SR and flow configs with derived-field validation.

``SRConfig`` is a copy of the reference package's ``SRConfig``
(``sin_inn_tpu/core/config.py``) with these differences:

* ``device`` picks where entry points run: ``"cuda"`` (the default) or
  ``"cpu"``. A CUDA request without a card raises; nothing falls back.
* ``use_kernel`` replaces ``use_pallas``: ``"auto"`` routes every 1x1 GLOW
  coupling through the fused kernels (except in ``float32_highest``),
  ``"off"`` keeps them on plain convolutions.
* The multi-chip fields are left out until their slice is ported.
* ``donate_state`` has no counterpart: the Adam step updates the
  parameters and its moments in place, so no second copy of the state is
  ever made.

``FlowConfig`` is the reference's ``FlowConfig`` narrowed to the fields
that the ``flow`` operations read, with the same ``device`` field and
``use_kernel`` in place of ``use_pallas``. With
both window bounds set, the splat and the metric warps run the windowed
kernels on CUDA tensors and their plain versions on CPU tensors: the local
ones (K5 local, K6 local) when the local row bound is set, else the static
ones (K5, K6); ``use_kernel="off"`` takes the windowed forms of
``ops/warp.py`` and ``ops/splat.py`` instead. ``flow_producer`` names the
pseudo-GT producer of a video without GT flow (the port's RAFT, a Python
callable or a command template). The multi-chip fields come with the code
that reads them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar, Optional, Tuple

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
    # seed params from a reference torch / Lightning checkpoint
    # (models/torch_import.py); a framework checkpoint on disk (resume)
    # takes precedence over the import
    import_torch: Optional[str] = None
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
    # --profile N: one torch.profiler trace of N train steps after a warm-up,
    # into <checkpoints>/trace (a Chrome trace TensorBoard reads)
    profile_steps: int = 0
    # auto-tuning before the fit (the reference enables Lightning's
    # auto_lr_find / auto_scale_batch_size): train/tuner.py
    auto_lr: bool = False
    auto_batch: bool = False

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


@dataclass(frozen=True)
class FlowConfig:
    """Config for fitting an INR to a video's optical flow and serving it.

    The reference's ``FlowConfig`` (``sin_inn_tpu/core/config.py``)
    narrowed to the fields ``flow train``, ``flow test`` and ``flow
    interpolate`` read, with the same defaults."""

    WINDOW_BOUND_KEYS: ClassVar[Tuple[str, ...]] = (
        "splat_max_dy", "splat_max_dx", "splat_local_dy", "splat_local_dx")

    # Data
    input_video: str = "../datasets/sintel/training/final/alley_1"
    name: str = "temp"
    end: Optional[int] = None
    step: Optional[int] = None
    size: int = 436
    batch: int = 1
    test_size: int = 436
    test_batch: int = 1
    # precomputed GT flow directory (.flo/.npy per frame pair)
    flow_dir: Optional[str] = None
    # pseudo-GT producer when the video has no GT flow:
    # 'raft:<ckpt.pth>[@iters]' (models/raft.py on ``device``),
    # 'py:<module>:<fn>', or a '{f1} {f2} {out}' command template
    # (data/flow_media.py resolve_producer)
    flow_producer: Optional[str] = None

    # Network
    net: str = "RBF"
    domain_dim: int = 3
    num_frequencies: int = 256
    std: float = 25.0
    num_layers: int = 3
    hidden_dim: int = 256
    output_channels: int = 4
    num_frequencies_pe: int = 4
    std_rbf: float = 12.0
    # Progressive nets (PFF, PRBF, ...): the spatially adaptive controller
    # on a spatial_res^3 cell grid instead of the linear coarse-to-fine ramp
    spatially_adaptive: bool = False
    spatial_res: int = 50
    # progress threshold of both controllers: a cell (spatial) or the whole
    # ramp (linear, 0 = never) stops once its loss is under it
    controller_epsilon: float = 1e-3

    # Train
    epochs: int = 1000
    val_iter: Optional[int] = None
    lr: float = 1e-4
    loss_l1: float = 1.0
    loss_census: float = 0.1
    loss_ssim: float = 0.0
    census_width: int = 3
    loss_smooth1: float = 0.1
    edge_constant: float = 150.0
    edge_func: str = "gauss"     # 'exp' | 'gauss'
    # Occlusion masks of the training loss and of ``flow test``
    occl: Optional[str] = "wang"  # 'brox' | 'wang' | None
    occl_thresh: float = 0.7
    random_seed: int = 0
    # Window bounds of the splat and the metric warps, in pixels: taps of
    # flows beyond |flow_y| <= splat_max_dy - 1, |flow_x| <= splat_max_dx - 1
    # are dropped. 'auto' = size-scaled (resolve_splat_bounds), None/'off' =
    # the exact scatter and the exact warp, an int pins the bound. Both
    # bounds set route the splat and the warps to the windowed kernels;
    # dy alone windows the splat's rows (splat_windowed) and keeps the warp
    # exact.
    splat_max_dy: "Optional[int] | str" = "auto"
    splat_chunk: int = 2          # row chunk of the windowed splat
    splat_max_dx: "Optional[int] | str" = "auto"
    splat_col_chunk: int = 256    # column block of the windowed warp
    resample_chunk: int = 8       # row chunk of the windowed warp
    # Local-window row bound of the kernels: each 128 x 128 tile's window is
    # recentred vertically on the tile's mean flow (ops/offsets.py), so this
    # bounds only the deviation |flow_y - tile mean| (64 -> 32 rows of half
    # window at Sintel size). 'auto' = half the resolved global dy, moved by
    # the train loop's GT-flow probe and window refit; engaged only with
    # both global bounds and when smaller than dy; an int pins; None/'off' =
    # the static windows. The global dy caps the offsets.
    splat_local_dy: "Optional[int] | str" = "auto"
    # Local-window column bound: the windows also recentre horizontally on
    # the 128-quantized tile mean. 'auto' = off unless the GT probe engages
    # it; an int pins (needs the row-local path and a narrower window).
    splat_local_dx: "Optional[int] | str" = "auto"
    # Refit at every save of the 'auto' bounds from the measured flow and
    # deviation: widen as soon as the flow nears a window, tighten once it
    # has settled (from epoch max(epochs // 5, 2), against the running
    # maximum). 'auto' = on when any bound is 'auto'; 'off' = static.
    window_refit: str = "auto"

    # Runtime
    results_dir: str = "results"
    checkpoints_dir: str = "checkpoints"
    compute_dtype: str = "float32"
    # the fused and windowed kernels: 'auto' | 'off' ('off' takes ordinary
    # autograd through the plain INR, with a dense per-point mask under the
    # spatial controller, and the windowed forms resample2d_windowed and
    # softsplat_windowed_with_coverage for the warps and splats, as the
    # reference's use_pallas='off'). On the card 'auto' raises for widths
    # the kernel cannot take; it never gives way to 'off' by itself. The two
    # routes
    # agree to rounding in float32 only: in bfloat16 the fused forward rounds
    # the products' operands and accumulates in fp32, the plain one casts the
    # activations
    use_kernel: str = "auto"
    # torch device string; entry points never fall back from 'cuda'
    device: str = "cuda"
    # --profile N: one torch.profiler trace of N train steps after a warm-up,
    # into <checkpoints>/trace
    profile_steps: int = 0
    # seed params, encoding buffers and the controller mask from a reference
    # torch / Lightning flow checkpoint (models/torch_import.py); a framework
    # checkpoint on disk (resume) takes precedence over the import
    import_torch: Optional[str] = None

    def __post_init__(self):
        if self.edge_func not in ("exp", "gauss"):
            raise ValueError(f"edge_func must be 'exp' or 'gauss', got "
                             f"{self.edge_func}")
        if self.use_kernel not in ("auto", "off"):
            raise ValueError(f"use_kernel must be 'auto' or 'off', got "
                             f"{self.use_kernel!r}")
        if self.occl not in ("brox", "wang", None):
            raise ValueError(f"occl must be 'brox'|'wang'|None, got {self.occl}")
        for name in self.WINDOW_BOUND_KEYS:
            v = getattr(self, name)
            if isinstance(v, str) and v not in ("auto", "off"):
                raise ValueError(f"{name} must be an int, 'auto', 'off' or "
                                 f"None, got {v!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {self.compute_dtype!r}")
        if self.window_refit not in ("auto", "off"):
            raise ValueError(f"window_refit must be 'auto' or 'off', got "
                             f"{self.window_refit!r}")
        if (self._bound_off(self.splat_max_dy)
                and isinstance(self.splat_max_dx, int)
                and self.splat_max_dx > 0):
            raise ValueError(
                "splat_max_dx requires splat_max_dy (the windowed metric "
                "warps engage only with both bounds set)")

    @staticmethod
    def _bound_off(v) -> bool:
        return v is None or v == "off" or v == 0

    @property
    def bounds_resolved(self) -> bool:
        """No window bound, global or local, is left on 'auto' or 'off'."""
        return not any(isinstance(getattr(self, k), str)
                       for k in self.WINDOW_BOUND_KEYS)

    def resolve_splat_bounds(self, h: int, w: int) -> "FlowConfig":
        """Materialize the window bounds for a known frame size: ints, or
        None for the exact routes and the static windows.

        'auto' picks ceil(dim/8) rounded up to a multiple of 16 (Sintel
        436x1024 -> dy=64, dx=128) and takes the exact scatter for frames
        under 128 px, unless splat_max_dx was pinned to an int. The local
        row bound 'auto' is half the global dy rounded up to 8 (32 at
        Sintel size), engaged only with both global bounds and when smaller
        than dy; the local column bound 'auto' resolves off (only the GT
        probe engages it), a pinned one engages only on the row-local path
        and when it narrows the window at 128-column granularity.
        Idempotent for resolved bounds."""
        def auto(dim):
            eighth = -(-dim // 8)                       # ceil(dim / 8)
            return max(16, (eighth + 15) // 16 * 16)    # to multiple of 16

        dy, dx = self.splat_max_dy, self.splat_max_dx
        dx_pinned = isinstance(dx, int) and not self._bound_off(dx)
        if dy == "auto":
            dy = None if (min(h, w) < 128 and not dx_pinned) else auto(h)
        elif self._bound_off(dy):
            dy = None
        if dx == "auto":
            dx = None if dy is None else auto(w)
        elif self._bound_off(dx):
            dx = None
        if dy is None:
            dx = None

        ldy = self.splat_local_dy
        if ldy == "auto":
            ldy = None if dy is None else max(8, -(-(dy // 2) // 8) * 8)
        elif self._bound_off(ldy):
            ldy = None
        if ldy is not None and (dy is None or dx is None or ldy >= dy):
            ldy = None

        ldx = self.splat_local_dx
        if ldx == "auto" or self._bound_off(ldx):
            ldx = None
        if ldx is not None and (
                ldy is None
                or -(-(128 + 2 * ldx) // 128) >= -(-(128 + 2 * dx) // 128)):
            ldx = None
        return self.replace(splat_max_dy=dy, splat_max_dx=dx,
                            splat_local_dy=ldy, splat_local_dx=ldx)

    @property
    def effective_val_iter(self) -> int:
        """The validation cadence in epochs; off (never reached) unless
        ``val_iter`` is set, as in the reference."""
        return self.val_iter if self.val_iter else self.epochs + 1

    def replace(self, **kw) -> "FlowConfig":
        return dataclasses.replace(self, **kw)
