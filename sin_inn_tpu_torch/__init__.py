"""PyTorch / CUDA port of the single-video INN super-resolution framework.

Runs on NVIDIA Hopper cards (``sm_90a``). The JAX package ``sin_inn_tpu``
is the reference this package is tested against; nothing here imports it or
JAX. Public functions keep the reference's NHWC layout and names. The port
does everything the JAX package does:

- ``sr train``, ``sr test`` and ``sr export`` for the SRF and the IRN, with
  the reference checkpoint exchange (``models/torch_import.py``,
  ``--import-torch``), the fused 1x1 GLOW coupling forward and inverse and
  their backward passes as hand-written CUDA kernels
  (``ops/cuda/coupling.py``, ``csrc/coupling_1x1.cu``,
  ``csrc/coupling_1x1_bwd.cu``), and the GLOW coupling with 3x3-conv
  subnets as CUDA kernels reached through its own module
  (``ops/cuda/coupling3x3.py``, ``csrc/coupling_3x3.cu``,
  ``csrc/coupling_3x3_bwd.cu``);
- the flow pipeline on the global and local windows, ``flow train``,
  ``flow test``, ``flow interpolate``, ``flow export``, ``flow summarize``
  and ``flow sintel`` (with the flow half of ``--import-torch``), for every
  INR of the registry, the progressive ones under their linear or spatially
  adaptive controller (``models/controllers.py``), with the windowed splat
  and gather and the fused INR's forward and backward as hand-written CUDA
  kernels (``ops/cuda/splat.py``, ``ops/cuda/gather.py``,
  ``ops/cuda/inr.py``; ``csrc/splat_region.cu``, ``csrc/gather_region.cu``,
  ``csrc/inr_fwd.cu``, ``csrc/inr_bwd.cu``);
- RAFT (``models/raft.py``) and the pseudo-GT producer behind
  ``--flow-producer`` (``data/flow_media.py``), and the scene-space
  multi-view gather with its ``scene-space`` command (``scene_space/``);
- the tooling of both training commands: the auto-tuner
  (``train/tuner.py``), the profiler with the program's spans and counters
  (``core/profiler.py``) and the native batch loader (``data/native.py``);
- data preparation and the ``prepare`` command (``data/prepare.py``);
- PNG frames read and written, GIFs read and written, JPEG scene images
  read and frames resized by its own code (``io/png.py``, ``io/gif.py``,
  ``io/jpeg.py``, ``io/resize.py``, host loops in ``io/codec.cpp``), so
  the commands need no imageio or cv2; only a video file that is not a GIF
  still needs imageio (and its ffmpeg);
- data and tensor parallelism over ``torch.distributed``, one process per
  GPU (``parallel/mesh.py``, ``parallel/sharding.py``, the mesh flags of
  ``sr train`` and ``flow train``), and the multi-scene launcher
  (``parallel/launcher.py``);
- the polynomial encoding (``ops/encodings.py``) and the dense block's
  measurement forms (``ops/subnet.py``); ``examples/pair_flow_torch.py``.
"""
