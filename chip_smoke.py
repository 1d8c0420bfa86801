#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sin_inn_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (``CUDA_HOME`` or ``/usr/local/cuda``); imports
nothing of JAX or of the JAX package. Phases:

1. the card: its name, and nvidia-smi's name and power limit;
2. the build: every CUDA source of the port, one nvcc each, in parallel;
3. the kernels against their plain PyTorch versions, at the shapes the SRF
   flagship path gives them (batch 40, HR 352x640: C=48 and C=192), fp32
   (max abs error <= 1e-4 + 1e-4 |plain|: fp32 sums over K=256 in another
   order, atanf against torch.atan) and one bf16-storage case (one bf16
   rounding step, forward at C=48 and inverse at C=192), the
   forward-inverse round trip, median times, each launch's tile height
   (warps a block) and its rate of TF32 work (3xTF32: three TF32 products
   a product). Then at the training shapes (batch 8, HR 352x640): K1 and
   K2 checked the same way (K2 on the plain forward's output, the round
   trip within 1e-4) and timed, and
   K3 and K4 (the backward kernels, each with its gradient reduction)
   against their plain versions with fp32 matmuls (dx within
   1e-4 + 1e-4 |plain|; each weight and bias gradient within 1e-3 of the
   largest |plain| of it, since the sums over 10^5 rows run in another
   order; both plus ``relu_gate_slack`` over the relu gates the launch set
   otherwise than the plain version at a pre-activation within 1e-5 of 0:
   the kernels' 3xTF32 recompute may gate such a one either way, and the
   gate carries its row's downstream terms), one bf16-storage case, two
   planted faults of the gradient slots that the checks must reject, and
   median times;
4. the path: a 102-frame synthetic 352x640 video, a seeded state saved and
   restored through the checkpoint store, ``sr test`` frames over both
   40-window batches and the eval step over the val split, on ``cuda`` in
   the ``float32`` compute mode. Launch counts are reset before and read
   after each, and must show that every 1x1 coupling ran in a kernel.
5. train: a 204-frame synthetic 352x640 video (16 training windows),
   ``run_sr_train`` at the flagship config (batch 8, 2 epochs = 4 steps,
   val metrics and checkpoints every epoch), then a resume to 3 epochs;
   launch counts of one train step (4 K1, 4 K2, 4 K3, 4 K4 and a reduction
   per K3/K4) and of one step with TCR (5 iterations) and both MMD terms
   (4, 44, 4, 44); the gradients of the kernel route against the cuDNN
   route (``use_kernel="off"``) on one batch with the same noise (each leaf
   within a normwise relative error of 2e-2, the TF32 rounding of the
   convolutions; the loss within 1e-3); train frames/s over 10 steps.
6. the windowed splat (K5) and gather (K6) against their plain versions at
   the flow path's shapes (1 x 436 x 1024; K6 C=3, K5 C=5; dy=64, dx=128),
   on a seeded smooth flow that leaves the window in part of the frame, so
   the drop rule runs: K6 within 1e-5 + 1e-5 |plain| (it repeats the plain
   arithmetic), K5 and its coverage channel within 1e-5 + 1e-5 |plain| (its
   fixed-point sums against the plain fp32 sums in another order), two K5
   launches bitwise equal; device time per call (torch.profiler:
   every kernel and memset of the call) of each kernel and of its plain
   version, and each kernel's median time between CUDA events (which
   includes the host's launch path); then the local-window kernels, K6
   local (C=3, resample coordinates) and K5 local (C=5), at local dy 32, dx
   128, cap_y 64, on the tile offsets of a seeded flow with a drift of
   10-40 px per 128 x 128 tile, +-4 px of detail and a stripe of 45 px more
   that leaves the local window: the same limits, two K5 local launches
   bitwise equal, the same times, and the time of ``tile_flow_offsets``
   itself. K6 local, ``grid_sample`` on the same
   flow, K6 and ``grid_sample`` on K6's flow are timed in turns in one loop
   (200 launches each, the device time of each launch): the medians are
   the two K6 rows' ms and library_ms, and each one's spread is printed;
7. the flow path: a 6-frame synthetic 436x1024 video and a seeded
   full-width ``RBF`` INR (E = 512, MLP 512-256-256-256-4) saved and
   restored through the checkpoint store; ``flow_test_outputs`` over the 5
   pairs (finite flows, Wang masks in {0, 1}, no K5/K6 launch: the
   occlusion map is the exact scatter) and ``interpolate_frames`` at factor
   2 (exactly 2 K5 + 2 K6 launches per mid-frame), each timed as frames/s;
   alpha = 0 and 1 reproduce the endpoint frames within 1e-5; one mid-frame
   and K5 on its splat input timed at the path's flow scale and at 16x it
   (flows of Sintel magnitude, some beyond the window); the card against
   the CPU on a small crop (flows within 1e-3 px, frames within 1e-3). The
   phase never sets ``allow_tf32`` and checks that it stays off, and the
   RBF encoding of the full pose grid is bitwise the same with it on. Then
   one mid-frame from a checkpoint whose sidecar names local windows (dy
   64, dx 128, local dy 32): exactly 2 K5 local + 2 K6 local launches,
   within 1e-4 of the static windows' mid-frame.
8. the training kernels of the flow path against their plain versions: the
   gather kernel's gradient mode (K6 grads) at 1 x 436 x 1024 with C = 3 and
   resample coordinates (the warp's backward) and C = 5 and raw coordinates
   (the splat's backward), on phase 6's flow and on zero flow (where every
   tap distance is 0 or 1 and both derivatives must be exactly 0 in raw
   coordinates): out, dfx, dfy within 1e-5 + 1e-5 |plain|; K6 local grads
   in both modes on phase 6's local flow, the same limits; each of the four
   K6 grads rows timed in turns with ``grid_sampler_2d_backward`` on the
   same flow and payload asking for the grid gradient only (no window; 200
   launches each): its library_ms; the fused INR
   backward (K7 backward, constant mask) at N = 446,464 for the ``RBF`` and
   ``FFN`` nets at default widths: every weight and bias gradient within
   1e-3 of the largest |plain| of its leaf in fp32 (sums over 446,464 rows
   in another order), the bf16 operand mode within 1e-3 of the largest
   |plain| of the bf16 plain version and within a normwise 2e-2 of the
   fp32 plain result (two bf16 roundings per product, and the relu gates
   they flip), two launches bitwise equal; times of each (the kernel and
   its plain version in turns, 200 calls each for ``RBF``, with their
   spread), the scratch size; and a net whose widths the kernel cannot
   take (hidden 512) is
   refused on the card with a ValueError, not handed to autograd;
9. ``flow train``: the 6-frame 436x1024 video through ``run_flow_train`` at
   the ``FlowConfig`` defaults (RBF, batch 1, Wang occlusion, bounds dy 64,
   dx 128, local dy 32, the window refit on) for 2 epochs = 10 steps, every
   one on the local windows (K5 local 2, K6 local 2, K6 local grads 4, K7
   backward 1 and its reduction a step); the refit at the second save
   tightens the bounds to the seeded net's few-px flows, and the sidecar
   records the refitted bounds and the monitor's history; a resume to 3
   epochs from the checkpoint with the optimizer state, on the refitted
   bounds (its launches follow them); finite losses, the metrics file; at
   the resolved defaults, one step's launches exactly K5 local 2, K6 local
   2, K6 local grads 4, K7 backward 1 (and one reduction), no static K5/K6
   and K1-K4 0; the parameter gradients of that step against
   ``use_kernel="off"`` (autograd through the plain INR and the windowed
   forms, no kernel launch) within a normwise 1e-3; the same step twice from
   the same state, loss and gradients bitwise equal (else the first op whose
   output differs is named); one whole step under
   ``torch.cuda.set_sync_debug_mode("error")`` (the offsets and the
   monitors make the host wait for nothing); train pairs/s and step ms over
   10 steps after 2 warm-up steps and the peak memory, for the local
   windows, the static windows and ``use_kernel="off"``, and
   the memory each holds between its forward and its backward (the kernel
   route keeps no (N, 512) tensor); ``flow test`` on the trained checkpoint
   with no kernel launch at all.
10. the fused INR's forward kernel (K7 forward) and the new modes of K7
    backward against their plain versions at N = 446,464 for the progressive
    nets ``PFF`` and ``PRBF`` at default widths (mask length 515, MLP
    515-256-256-256-4) under a seeded spatial-controller state that is not
    the initial one (cell values in [0, 1], ``spatial_res`` 50): the forward
    in the ``const``, ``slab`` and ``point`` mask modes and for a
    non-progressive net within 1e-4 + 1e-4 |plain| in fp32 (sums over up to
    515 channels in another order, 3xTF32 products) and normwise within 1e-5
    (one-pass TF32 would give about 1e-4), ``slab`` and ``point``
    within the same of each other, the bf16 operand mode within a normwise
    5e-3 of the bf16 plain version and 2e-2 of the fp32 one in every mode
    (a pre-activation at a bf16 tie may round either way under another
    order of sums, so the share of points beyond 1e-4 + 1e-4 |plain| is
    printed, not gated), two launches bitwise equal in both operand modes,
    timed in turns with its plain version; the backward with every leaf,
    the coordinate rows among them, within 1e-3 of its largest |plain|, two
    launches bitwise equal; times (the kernel and its plain version in
    turns), bounds, scratch size;
11. the progressive path, on the static windows (``splat_local_dy="off"``,
    so that one train path keeps the static K5, K6 and K6 grads launches):
    ``run_flow_train`` for ``PFF`` with the spatial controller on the
    6-frame 436x1024 video (2 epochs = 10 steps, a block
    advance each, then a resume to 3 epochs with the controller state from
    the checkpoint); one transition of each controller with
    ``torch.cuda.set_sync_debug_mode("error")`` (nothing waits for the
    card), the spatial one on a state with half its cells out of progress,
    whose mask rows must stay; launch counts of one step exactly K7 forward
    1, K7 backward 1 (and one reduction), K5 2, K6 2, K6 grads 4, K1-K4 0;
    the gradients against ``use_kernel="off"`` (the dense (N, 515) mask and
    autograd) within a normwise 1e-3; pairs/s, step ms and peak memory of
    both routes over 10 steps after 2 warm-ups at the default schedule (a
    block every 8 steps); 5 steps of ``PFF`` with the linear controller (K7
    forward 0, K7 backward 1 a step); ``flow test`` and one interpolated
    mid-frame from the spatial checkpoint (K7 forward 1 a pair, the peak
    memory under one (N, 512) tensor over what is held), their ms and the
    train step's, each with the device's busy share of one traced call; the
    card against the CPU on a small crop (flows within 1e-3 px).
12. K8, the GLOW coupling with 3x3-conv subnets, through its module
    (``ops/cuda/coupling3x3.py``; no entry point reaches it, as in the JAX
    package): the seeded flagship SRF at batch 8 walked layer by layer, so
    each of its four 3x3 couplings (two per octave, C = 48 and 192) gets its
    real input. The path: ``fused_glow3_forward``, ``fused_glow3_inverse``
    and the banded op's forward and backward on each coupling, with exact
    launch counts (2 K8 forward per coupling direction, 2 K8 backward and 2
    reductions per banded backward). Then, TF32 off: every half launch,
    both flags, within 1e-4 + 1e-4 |plain| of its plain version and 1e-5
    of its norm (a gate one-pass TF32 fails), bitwise the same over two
    launches; the whole coupling both ways within 1e-4 + 1e-4 |ref| of the
    cuDNN route; inverse(forward) within 1e-4; K8 backward's dx_in and
    dx_aff within 1e-4 + 1e-4 |plain|
    and each weight and bias leaf within 1e-3 of its largest |plain|, both
    flags, bitwise the same over two calls; the gradients through
    ``make_fused_coupling3_banded`` and ``make_fused_coupling3`` within a
    normwise 1e-3 of autograd of the cuDNN route. A conv1 pre-activation
    within 1e-5 of 0 may be gated either way by two fp32 implementations:
    the terms it gates (``relu_gate_slack``) are added to the dx_in, dW1 and
    db1 limits, elementwise and normwise. Times (CUDA events) of
    one half at each octave: K8 forward at batch 8 and 40, K8 backward at
    batch 8, their plain versions, and the cuDNN route of the same half
    (and of its VJP) in the port's ``float32`` mode (TF32) and with TF32
    off. A whole ``sr train`` step at the flagship launches no K8.
13. IRN and the checkpoint exchange: ``run_sr_train`` at the IRN flagship
    (``SRConfig`` defaults with ``architecture="IRN"``, batch 8, HR
    352x640, a 204-frame synthetic video) for 4 steps and a resume to 6;
    train frames/s and ms/step over 10 steps after 2 warm-ups, peak memory;
    ``sr test`` frames/s; the card against the CPU on a crop (1e-3); no
    kernel launch anywhere on the IRN path. Then ``run_sr_export`` of phase
    5's SRF checkpoint and of the IRN checkpoint, each imported with
    ``--import-torch`` into a fresh experiment: the inverse pass within 1e-5
    of the exported run's and the first 40 ``sr test`` frames within one
    level.
14. the tooling of ``sr train`` at the SRF flagship (HR 352x640, float32,
    the 204-frame video): ``SRDataset.gather`` takes the native loader
    (``data/native.py``) and its bytes equal numpy's at lr_window 10,
    batch 8; ``find_batch_size`` from batch 8 (limit 512) returns the
    largest batch that ran, twice it ran out of memory or passed the limit,
    and ``torch.cuda.memory_allocated`` is back within 64 MiB of its value
    before the probe (the batch, its peak memory and the error are
    printed); a ``RuntimeError`` planted in the step at batch 32 propagates
    out of it; ``find_lr`` over its five LRs x 8 steps at batch 8 (4 K1-K4
    launches a step; each LR's score and the pick printed); and
    ``run_sr_train`` with ``profile_steps=3`` (6 steps): its trace holds
    exactly 3 x 4 events of each of K1-K4 by CUDA symbol.
15. the flow exchange and the dataset entry points at Sintel size:
    ``run_flow_train`` with ``profile_steps=2`` on the RBF net and the
    default local windows (its trace holds 2 x each step's launches of K7
    backward, K5 local, K6 local and K6 local grads, by CUDA symbol); the
    RBF checkpoint through
    ``run_flow_export``, ``torch.load`` and a fresh net with
    ``import_torch``: a pair's flows bitwise equal; a PFF spatial
    checkpoint of 5 steps the same way: within 1e-5 + 1e-5 |ref| (the mask
    travels as counts), one K7 forward launch a pair on each side; the
    Sintel core (``sintel_scene_flows``) on two 6-frame scenes, one from
    its checkpoint and one from the ``--import-torch`` weights: 5 ``.flo``
    files each that ``read_flo`` reads back bitwise equal to the returned
    flows and to ``flow_test_outputs``' flows; the summarize core
    (``normalized_aepe``) over both scenes with synthetic GT; sintel
    pairs/s.

16. RAFT, the pseudo-GT producer (``models/raft.py``; no port kernel, none
    launched): the committed goldens ``tests/goldens/raft_{basic,small}.npz``
    on the card with TF32 off through ``load_torch_weights`` of the goldens'
    seeded release-schema checkpoint (``raft_state_dict_np``, a copy of
    ``tools/goldens.py``'s draw), both lookups, within 2e-3 + 1e-2
    |golden|; the matmul lookup against the take lookup within 1e-5 + 1e-5
    |take|; both variants at 436x1024 (padded to 440x1024), 20 iterations,
    batch 1 and 4, both lookups, the TF32 route and TF32 off: ms a pair
    (CUDA events, median of 10 after 2 warm-ups), peak memory, the TF32
    route within a normwise 2e-2 of TF32 off.
17. ``flow train --flow-producer raft:<ckpt>@20``: phase 9's 6-frame
    436x1024 video through ``run_flow_train`` for 1 epoch; 5 ``.flo`` files
    in the cache the JAX package names the same, ``flow_scale`` 1, the
    attached flow equal to the producer's; the probe of the RAFT flow must
    engage the local windows, and the 5 steps launch exactly K5 local 2, K6
    local 2, K6 local grads 4, K7 backward 1 (and a reduction) each; a
    second run reuses the cache with no ``raft_flow`` call; the producer's
    pairs/s with the ``.flo`` writes.
18. the scene-space gather (``scene_space/gather.py``; no port kernel) on
    ``synth_scene(24, 480, 640)``, patch 3: the windowed one-hot read
    within 1e-5 + 1e-5 |exact| of the exact gather, the drift guard
    silent, both forms' ms (median of 5 after a warm-up) and peak memory;
    the card within 1e-5 of the CPU on ``synth_scene(4, 64, 224)`` with the
    side-plane filter off.
19. distributed (``parallel/``) in a world of one on this card, NCCL:
    ``initialize_distributed`` at an explicit ``127.0.0.1`` coordinator,
    ``make_mesh(1, 1)`` (``resolve_mesh`` gives None for 1 x 1, as JAX
    does); the data-parallel ``sr train`` step at the SRF flagship (batch 8,
    HR 352x640, phase 5's batch and draws: the gradients all-reduced over
    the data group) against the non-distributed step from the same seeded
    state, both on cuDNN's deterministic algorithms: the loss within 1e-6
    relative and every updated param within 1e-6, then a step with both
    MMD terms (over the gathered batch) the same way; the spread of two
    non-distributed steps on the default algorithms beside it; its exact
    K1-K4 launches; both steps' frames/s (default algorithms); then
    ``run_scenes`` over two synthetic 128x256 scenes with GT flow (K5 / K6
    and K7 backward launched), ``aggregate_aepe`` against the frame-weighted
    mean of the two EPEs. The process group is destroyed after it. More
    than one rank runs only on CPU processes (the tests' gloo worlds).
20. convergence on the kernel route, through ``tools/validate_torch.py``
    (loaded by its path): the flow shift fixture (4 frames of a 2 px/frame
    moving texture at 436x1024, the 3 pairs a step, flow scale 1, RBF, LAMB
    lr 3e-3, static windows dy 64 / dx 128; the init of seed 1: seed 0's
    stays in the zero-flow basin past 300, as it does in the JAX package)
    for 300 iterations: the EPE
    against the analytic GT >= 1.5 px at the first step and <= 0.10 px at
    iteration 300 (the JAX package's record reads 0.041 there), one step's
    launches exactly K5 2, K6 2, K6 grads 4, K7 backward 1 and its
    reduction; then the SRF flagship (4x, 4 couplings, LR window 10, batch
    8) on a 360x640 synthetic video for 120 epochs: the train loss lower at
    the last milestone than at the first, the val HR-PSNR up by >= 0.4 dB,
    one step's launches K1-K4 4 each and 8 reductions. The trajectories
    are printed.

Any failed check exits non-zero. The line before the last is a JSON object
with each kernel's numbers; K1-K4's, K7's and K8's ``bound_ms`` counts
their products as they run, three TF32 products each on the tensor cores
(3xTF32), with the fp32 rate's bound beside it (``fp32_bound_ms``); K5's
rows carry the bytes of their scratch (the max partials). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH, HR_H, HR_W = 40, 352, 640
TRAIN_BATCH = 8
NUM_FRAMES = 102
TRAIN_FRAMES = 204
HIDDEN = 256
CLAMP = 1.2
# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
REPLACES = {
    "fused_glow_forward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:82",
    "fused_glow_inverse_1x1": "sin_inn_tpu/ops/pallas/coupling.py:111",
    "fused_glow_backward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:256",
    "fused_glow_inverse_backward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:412",
    "splat_region": "sin_inn_tpu/ops/pallas/splat.py:57",
    "gather_region": "sin_inn_tpu/ops/pallas/gather.py:79",
    "gather_region_grads": "sin_inn_tpu/ops/pallas/gather.py:148",
    "fused_inr_backward": "sin_inn_tpu/ops/pallas/inr.py:181",
    "fused_inr_forward": "sin_inn_tpu/ops/pallas/inr.py:156",
    "splat_region_local": "sin_inn_tpu/ops/pallas/splat.py:276",
    "gather_region_local": "sin_inn_tpu/ops/pallas/gather.py:334",
    "gather_region_local_grads": "sin_inn_tpu/ops/pallas/gather.py:334",
    "K8 fwd": "sin_inn_tpu/ops/pallas/coupling3x3.py:231",
    "K8 bwd": "sin_inn_tpu/ops/pallas/coupling3x3.py:381",
}
SOURCES = {
    "fused_glow_forward_1x1": "sin_inn_tpu_torch/csrc/coupling_1x1.cu",
    "fused_glow_inverse_1x1": "sin_inn_tpu_torch/csrc/coupling_1x1.cu",
    "fused_glow_backward_1x1": "sin_inn_tpu_torch/csrc/coupling_1x1_bwd.cu",
    "fused_glow_inverse_backward_1x1":
        "sin_inn_tpu_torch/csrc/coupling_1x1_bwd.cu",
    "splat_region": "sin_inn_tpu_torch/csrc/splat_region.cu",
    "gather_region": "sin_inn_tpu_torch/csrc/gather_region.cu",
    "gather_region_grads": "sin_inn_tpu_torch/csrc/gather_region.cu",
    "fused_inr_backward": "sin_inn_tpu_torch/csrc/inr_bwd.cu",
    "fused_inr_forward": "sin_inn_tpu_torch/csrc/inr_fwd.cu",
    "splat_region_local": "sin_inn_tpu_torch/csrc/splat_region.cu",
    "gather_region_local": "sin_inn_tpu_torch/csrc/gather_region.cu",
    "gather_region_local_grads": "sin_inn_tpu_torch/csrc/gather_region.cu",
    "K8 fwd": "sin_inn_tpu_torch/csrc/coupling_3x3.cu",
    "K8 bwd": "sin_inn_tpu_torch/csrc/coupling_3x3_bwd.cu",
}
COUPLING = ("fused_glow_forward_1x1", "fused_glow_inverse_1x1",
            "fused_glow_backward_1x1", "fused_glow_inverse_backward_1x1")
BACKWARD = ("fused_glow_backward_1x1", "fused_glow_inverse_backward_1x1")
FLOW_H, FLOW_W = 436, 1024     # Sintel
FLOW_FRAMES = 6
DY, DX = 64, 128               # resolve_splat_bounds at 436x1024
LDY, CAPY = 32, 64             # its local row bound and the offsets' cap
FLOW_TRAIN_EPOCHS = 2
SCENE = (24, 480, 640)         # the scene gather's frames, height, width


RAFT_SEED = {"basic": 5, "small": 7}   # the committed goldens' draws


class SmokeFailure(Exception):
    pass


def raft_state_dict_np(variant: str = "basic"):
    """The goldens' deterministic RAFT checkpoint in the official release
    schema (``module.`` prefix, OIHW kernels, ``num_batches_tracked``),
    drawn from numpy's ``RandomState`` in the order of the sorted schema, as
    ``tools/goldens.py`` ``raft_state_dict_np`` draws it (a CPU test holds
    the two bitwise equal); built from the port's schema."""
    from sin_inn_tpu_torch.models.raft import param_schema

    rng = np.random.RandomState(RAFT_SEED[variant])
    sd = {}
    for name, shape in sorted(param_schema(variant).items()):
        if name.endswith("running_var"):
            arr = rng.rand(*shape) + 0.5
        elif name.endswith(("running_mean", "bias")):
            arr = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:               # batch-norm weight
            arr = rng.rand(*shape) + 0.5
        else:                               # conv kernel, drawn HWIO
            o, i, kh, kw = shape
            arr = 0.3 * rng.randn(kh, kw, i, o) / np.sqrt(max(kh * kw * i, 1))
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"module.{name}"] = np.asarray(arr, np.float32)
        if name.endswith("running_mean"):
            base = name[: -len("running_mean")]
            sd[f"module.{base}num_batches_tracked"] = np.asarray(100, np.int64)
    return sd


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def check_counts(counts, what: str, **want) -> None:
    """Every kernel's count is ``want``'s, or 0 where ``want`` names none."""
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full and set(want) <= set(counts),
          f"{what}: launches {counts}, want {full}")


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: every kernel and memset it launches,
    traced by torch.profiler over ``reps`` calls. A small kernel's event
    time is mostly the host's launch path; this is the card's share. Every
    call queues the same device work, so a trace whose device events are
    not a whole multiple of the calls lost some: it is taken again, up to
    three times."""
    from torch.profiler import ProfilerActivity, profile

    from sin_inn_tpu_torch.core.profiler import settle

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            settle("cuda")
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in evs)
        if seen >= reps and seen % reps == 0:
            break
    check(seen >= reps and seen % reps == 0,
          f"the profiler saw {seen} device events over {reps} calls")
    total_us = sum(e.self_device_time_total for e in evs)
    check(total_us > 0, "the profiler saw no device time")
    return total_us / reps / 1e3


def _spread(ts):
    """Median and spread (min, 10th and 90th percentiles, max) of times."""
    ts = sorted(ts)
    at = lambda f: ts[min(len(ts) - 1, int(f * len(ts)))]
    return {"median_ms": statistics.median(ts), "min_ms": ts[0],
            "p10_ms": at(0.1), "p90_ms": at(0.9), "max_ms": ts[-1],
            "n": len(ts)}


def interleaved_device_ms(fns, reps: int):
    """Device time of each launch of several calls taken in turns (A B C A
    B C ...) ``reps`` times under torch.profiler, each call one kernel: per
    name the median over its launches and their spread. In turns, so that
    a drift of the card's clock or of its neighbours' load falls on all of
    them alike. A trace that lost a device event would shift every later
    launch onto the wrong name, so one that does not hold exactly one event
    a call is taken again, up to three times (``settle`` keeps the first
    launches from being lost, ``core/profiler.py``)."""
    from torch.profiler import ProfilerActivity, profile

    from sin_inn_tpu_torch.core.profiler import settle

    names = list(fns)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle("cuda")
            for _ in range(reps):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if len(evs) == reps * len(names):
            break
    check(len(evs) == reps * len(names),
          f"interleaved timing: {len(evs)} device events for "
          f"{reps} x {len(names)} calls of one kernel each")
    times = {n: [] for n in names}
    kernels = {n: set() for n in names}
    for i, e in enumerate(evs):
        times[names[i % len(names)]].append(e.device_time_total / 1e3)
        kernels[names[i % len(names)]].add(e.name)
    check(all(len(k) == 1 for k in kernels.values()),
          f"interleaved timing: the calls' kernels mixed: {kernels}")
    return {n: _spread(ts) for n, ts in times.items()}


def device_busy(fn, traces: int = 3):
    """(wall ms, device-busy ms, kernel launches) of one call of ``fn``
    traced by torch.profiler after a warm-up call: the device's kernel time
    (one stream, so no two kernels overlap) against the wall time. A trace
    can lose device events (see ``device_ms``), so the call is traced
    ``traces`` times and the trace with the most launches is kept."""
    from torch.profiler import ProfilerActivity, profile

    from sin_inn_tpu_torch.core.profiler import settle

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            settle("cuda")
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        got = (wall, sum(e.self_device_time_total for e in evs) / 1e3,
               sum(e.count for e in evs))
        if best is None or got[2] > best[2]:
            best = got
    check(best[2] > 0, "the profiler saw no device time")
    return best


def _busy_line(what: str, t) -> str:
    return (f"{what}: traced wall {t[0]:.3f} ms, device busy {t[1]:.3f} ms "
            f"({100 * t[1] / t[0]:.1f}%) over {t[2]} kernel launches")


def interleaved_event_ms(fns, reps: int):
    """Time of each call of several (each many kernels) taken in turns,
    ``reps`` times, between CUDA events around the call: per name the
    median and the spread."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    marks = {n: [] for n in fns}
    for _ in range(reps):
        for n, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            marks[n].append((start, end))
    torch.cuda.synchronize()
    return {n: _spread([a.elapsed_time(b) for a, b in ms])
            for n, ms in marks.items()}


def _spread_line(name, t):
    return (f"{name} median {t['median_ms']:.4f} ms (min {t['min_ms']:.4f}, "
            f"p10 {t['p10_ms']:.4f}, p90 {t['p90_ms']:.4f}, max "
            f"{t['max_ms']:.4f}; {t['n']} launches)")


def coupling_cost(m: int, c: int, hidden: int, elem_bytes: int):
    """FLOP and bytes one coupling launch needs: four matmuls per pixel;
    x read once, y written once, each weight and bias read once."""
    len1 = c // 2
    len2 = c - len1
    flops = 2 * m * hidden * (len2 + 2 * len1 + len1 + 2 * len2)
    weights = (len2 * hidden + hidden + hidden * 2 * len1 + 2 * len1
               + len1 * hidden + hidden + hidden * 2 * len2 + 2 * len2)
    return flops, 2 * m * c * elem_bytes + 4 * weights


def backward_cost(m: int, c: int, hidden: int, elem_bytes: int,
                  inverse: bool):
    """FLOP and bytes of one K4 (``inverse``) or K3 launch with its
    reduction: K4 18 H C FLOP per pixel (recompute, dx chain and weight
    gradients, 6 H C each), K3 2 H len2 fewer (its chain never reads t1);
    x and g read once, dx written once, each weight read once and each
    weight gradient written once."""
    fwd, _ = coupling_cost(m, c, hidden, elem_bytes)
    flops = 3 * fwd - (0 if inverse else 2 * m * hidden * (c - c // 2))
    weights = (coupling_cost(1, c, hidden, 4)[1] - 2 * c * 4) // 4
    return flops, 3 * m * c * elem_bytes + 2 * 4 * weights


def coupling_bounds(flops: int, nbytes: int):
    """The bounds of a K1-K4 launch in ms: its bytes at the memory rate, its
    products at the fp32 rate, and at the TF32 rate in one pass and in the
    three TF32 products a product that the kernels take (3xTF32: what their
    ``bound_ms`` reads)."""
    return {"flop": flops, "bytes": nbytes,
            "fp32_bound_ms": flops / PEAK_FP32 * 1e3,
            "tf32_bound_ms": flops / PEAK_TF32 * 1e3,
            "tf32x3_bound_ms": 3 * flops / PEAK_TF32 * 1e3,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3}


def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi_line)
    return name, smi_line


def phase_build():
    from sin_inn_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    for name, b in built.items():
        print(f"[build] {name}: {b.seconds:.1f} s -> {b.path.name}")
        for kernel, regs, stack, st, ld in ptxas_report(b.log):
            print(f"[build]   {regs} registers, {stack} B stack, spill "
                  f"stores {st} B, loads {ld} B: {kernel[:90]}")
    print(f"[build] all sources: {wall:.1f} s wall")


def ptxas_report(log: str):
    """(kernel, registers, stack bytes, spill stores, spill loads) of each
    entry function in nvcc's ``-Xptxas -v`` output, demangled where
    ``c++filt`` is on the path."""
    rows = []
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        nums = [int(v) for v in spill.groups()] if spill else [-1] * 3
        rows.append((name, int(regs.group(1)) if regs else -1, *nums))
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", ""),) + r[1:]
                    for n, r in zip(names, rows)]
    return rows


def _coupling_params(gen, c: int, dev):
    from sin_inn_tpu_torch.ops import subnet as S

    len1 = c // 2
    len2 = c - len1
    p = {"s1": S.conv_subnet_init(gen, len1, 2 * len2, 1, HIDDEN),
         "s2": S.conv_subnet_init(gen, len2, 2 * len1, 1, HIDDEN)}
    return {s: {k: {n: t.to(dev) for n, t in conv.items()}
                for k, conv in sub.items()} for s, sub in p.items()}


def phase_kernels(dev):
    """K1/K2 against the plain versions at both flagship octave shapes."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    torch.backends.cuda.matmul.allow_tf32 = False
    gen_w = torch.Generator().manual_seed(1234)
    gen_x = torch.Generator(device=dev).manual_seed(4321)
    shapes = [(BATCH, HR_H // 4, HR_W // 4, 48),     # octave 1
              (BATCH, HR_H // 8, HR_W // 8, 192)]    # octave 2
    rows = {n: [] for n in COUPLING[:2]}
    with torch.inference_mode():
        for shape in shapes:
            c = shape[-1]
            len1 = c // 2
            p = _coupling_params(gen_w, c, dev)
            x = torch.randn(shape, generator=gen_x, device=dev)
            y = K.fused_glow_forward_1x1(p, x, CLAMP, len1)
            y_plain = K.fused_glow_forward_1x1_plain(p, x, CLAMP, len1)
            x_back = K.fused_glow_inverse_1x1(p, y_plain, CLAMP, len1)
            x_plain = K.fused_glow_inverse_1x1_plain(p, y_plain, CLAMP, len1)
            trip = K.fused_glow_inverse_1x1(p, y, CLAMP, len1)
            torch.cuda.synchronize()
            errs = {
                "fused_glow_forward_1x1": (y - y_plain).abs(),
                "fused_glow_inverse_1x1": (x_back - x_plain).abs(),
            }
            refs = {"fused_glow_forward_1x1": y_plain,
                    "fused_glow_inverse_1x1": x_plain}
            for n, e in errs.items():
                check(bool(torch.isfinite(e).all()), f"{n} C={c}: non-finite")
                ok = bool((e <= 1e-4 + 1e-4 * refs[n].abs()).all())
                check(ok, f"{n} C={c}: max abs err {e.max().item():.3e} "
                          f"exceeds 1e-4 + 1e-4|plain|")
            trip_err = (trip - x).abs().max().item()
            check(trip_err <= 1e-4, f"round trip C={c}: {trip_err:.3e} > 1e-4")
            m = x.numel() // c
            flops, nbytes = coupling_cost(m, c, HIDDEN, 4)
            for n, fn, plain, inp in (
                    ("fused_glow_forward_1x1", K.fused_glow_forward_1x1,
                     K.fused_glow_forward_1x1_plain, x),
                    ("fused_glow_inverse_1x1", K.fused_glow_inverse_1x1,
                     K.fused_glow_inverse_1x1_plain, y_plain)):
                ms = median_ms(lambda: fn(p, inp, CLAMP, len1), 20)
                plain_ms = median_ms(lambda: plain(p, inp, CLAMP, len1), 10)
                rows[n].append({
                    "shape": list(shape), "M": m, "C": c,
                    "max_abs_err": errs[n].max().item(),
                    "ms": ms, "plain_ms": plain_ms,
                    "warps": K.coupling_plan(c, len1, HIDDEN)[0],
                    "tf32_work_tflops": 3 * flops / ms / 1e9,
                    **coupling_bounds(flops, nbytes),
                    "round_trip_err": trip_err,
                })
            del y, y_plain, x_back, x_plain, trip, errs, refs
        # bf16 storage: the octave-1 forward and the octave-2 inverse
        bf16_err = 0.0
        for shape, fn, plain in (
                (shapes[0], K.fused_glow_forward_1x1,
                 K.fused_glow_forward_1x1_plain),
                (shapes[1], K.fused_glow_inverse_1x1,
                 K.fused_glow_inverse_1x1_plain)):
            c = shape[-1]
            p = _coupling_params(gen_w, c, dev)
            xb = torch.randn(shape, generator=gen_x,
                             device=dev).to(torch.bfloat16)
            yb = fn(p, xb, CLAMP, c // 2)
            check(yb.dtype == torch.bfloat16, f"bf16 C={c}: out {yb.dtype}")
            yb_plain = plain(p, xb, CLAMP, c // 2).float()
            e = (yb.float() - yb_plain).abs()
            # both round fp32 results to bf16: at most one rounding step apart
            check(bool((e <= 1e-4 + 2.0 ** -7 * yb_plain.abs()).all()),
                  f"bf16 {fn.__name__} C={c}: max abs err "
                  f"{e.max().item():.3e}")
            bf16_err = max(bf16_err, e.max().item())
    print(f"[kernels] bf16-storage K1 C=48 and K2 C=192: max abs err "
          f"{bf16_err:.3e}")
    for n, rs in rows.items():
        for r in rs:
            print(f"[kernels] {n} C={r['C']} M={r['M']}: {r['ms']:.3f} ms "
                  f"({r['warps']} warps a block, {r['tf32_work_tflops']:.1f} "
                  f"TFLOP/s of TF32 work; plain {r['plain_ms']:.3f} ms; "
                  f"bounds 3xTF32 {r['tf32x3_bound_ms']:.3f} / fp32 "
                  f"{r['fp32_bound_ms']:.3f} / bytes "
                  f"{r['bytes_bound_ms']:.3f} ms) max abs err "
                  f"{r['max_abs_err']:.3e}, round trip "
                  f"{r['round_trip_err']:.3e}")
    return rows, bf16_err


def _time_reduction(K, dev, m: int, c: int, len1: int):
    """Median ms of the gradient reduction alone at one K3/K4 launch's
    size (its chunks and slot size as the wrapper would take them)."""
    lib = K._bwd_lib()
    chunks = lib.sininn_coupling_1x1_bwd_chunks(m, c, len1, HIDDEN)
    check(chunks > 0, "backward grid query failed")
    slot = lib.sininn_coupling_1x1_bwd_slot_floats(c, len1, HIDDEN)
    part = torch.zeros((chunks, slot), device=dev)
    run = lambda: K.reduce_weight_grads(part)
    return median_ms(run, 20), chunks, slot


def _grad_margins(dp, rp, dx, rx, step: float, slack):
    """How much of each backward limit is used, each error taken beyond the
    terms of the relu gates within rounding of 0 (``slack``:
    ``K.relu_gate_slack``): (dx's max abs error, the largest dx error over
    1e-4 + step |plain|, and for each leaf of ``K.LEAVES`` (its error over
    1e-3 of its largest |plain|, its largest slack over that limit)). A
    limit holds at a use of at most 1."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    sp, sdx = slack
    leaves = []
    for a, b, sl in zip(K.param_leaves(dp), K.param_leaves(rp),
                        K.param_leaves(sp)):
        check(a.shape == b.shape, f"grad of shape {tuple(a.shape)}, want "
                                  f"{tuple(b.shape)}")
        lim = 1e-3 * b.abs().max().item()
        leaves.append((((a - b).abs() - sl).max().item() / lim,
                       sl.max().item() / lim))
    dx, rx = dx.float(), rx.float()
    e = (dx - rx).abs()
    check(bool(torch.isfinite(e).all()), "non-finite dx")
    dx_use = ((e - sdx) / (1e-4 + step * rx.abs())).max().item()
    return e.max().item(), dx_use, leaves


def _grads_close(dp, rp, dx, rx, step: float, what: str, slack):
    """Checks the backward tolerances, each plus the terms of the relu
    gates within rounding of 0 (``slack``: ``K.relu_gate_slack``); returns
    ``_grad_margins``."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    err, dx_use, leaves = _grad_margins(dp, rp, dx, rx, step, slack)
    for (s, c, k), (use, _) in zip(K.LEAVES, leaves):
        check(use <= 1.0, f"{what} grad {s}.{c}.{k}: max abs err beyond the "
                          f"gate slack is {use:.3g} of its limit")
    check(dx_use <= 1.0, f"{what}: dx max abs err {err:.3e} exceeds 1e-4 + "
                         f"{step:g}|plain| + gate slack")
    return err, dx_use, leaves


def _gate_report(K, p, x, g, len1: int, inverse: bool, gates) -> dict:
    """The relu gates a K3 / K4 launch (``gates``: ``K.backward_relu_gates``)
    set otherwise than the plain version: how many, and the largest
    |pre-activation| among them."""
    c = x.shape[-1]
    _, _, z = K._plain_rows(p, x.reshape(-1, c).float(),
                            g.reshape(-1, c).float(), CLAMP, len1, inverse)
    flips = [gi != (zi > 0) for gi, zi in zip(gates, z)]
    far = max((zi.abs()[f].max().item() if f.any() else 0.0)
              for zi, f in zip(z, flips))
    return {"flipped_gates": sum(int(f.sum()) for f in flips),
            "flip_max_abs_z": far}


def _planted_faults(K, n: str, p, x, g, len1: int, reference, slack):
    """The worst leaf's error beyond the gate slack over its limit, for K3's
    or K4's result (``n``) with a fault planted in the gradient slots before
    the reduction: the last chunk's slot zeroed (a chunk dropped), or chunk
    0's s2.conv1.b negated. The checks must reject each (a use above 1)."""
    rp, rx = reference
    at = (x.shape[-1] - len1) * HIDDEN      # b2a follows w2a in a slot
    faults = {"last chunk dropped": lambda q: q[-1].zero_(),
              "chunk 0 s2.conv1.b negated":
                  lambda q: q[0, at:at + HIDDEN].neg_()}
    real = K.reduce_weight_grads
    uses = {}
    for what, edit in faults.items():
        def planted(partials):
            edit(partials)
            return real(partials)

        planted.launches = 0
        K.reduce_weight_grads = planted
        try:
            dp, dx = getattr(K, n)(p, x, g, CLAMP, len1)
        finally:
            K.reduce_weight_grads = real
        _, _, leaves = _grad_margins(dp, rp, dx, rx, 1e-4, slack)
        uses[what] = max(use for use, _ in leaves)
        check(uses[what] > 1.0, f"{n}: the checks pass a result with its "
                                f"{what} (worst leaf {uses[what]:.3g} of "
                                f"its limit)")
    return uses


def phase_train_kernels(dev):
    """K1/K2 timed and K3/K4 checked and timed at the training shapes."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    torch.backends.cuda.matmul.allow_tf32 = False
    gen_w = torch.Generator().manual_seed(5678)
    gen_x = torch.Generator(device=dev).manual_seed(8765)
    shapes = [(TRAIN_BATCH, HR_H // 4, HR_W // 4, 48),     # octave 1
              (TRAIN_BATCH, HR_H // 8, HR_W // 8, 192)]    # octave 2
    rows = {n: [] for n in COUPLING}
    for shape in shapes:
        c = shape[-1]
        len1 = c // 2
        m = math.prod(shape[:-1])
        p = _coupling_params(gen_w, c, dev)
        x = torch.randn(shape, generator=gen_x, device=dev)
        g = torch.randn(shape, generator=gen_x, device=dev)
        flops, nbytes = coupling_cost(m, c, HIDDEN, 4)
        with torch.inference_mode():
            # K1 on x, K2 on the plain forward's y, and the round trip
            y_plain = K.fused_glow_forward_1x1_plain(p, x, CLAMP, len1)
            trip = K.fused_glow_inverse_1x1(
                p, K.fused_glow_forward_1x1(p, x, CLAMP, len1), CLAMP, len1)
            trip_err = (trip - x).abs().max().item()
            check(trip_err <= 1e-4, f"round trip C={c} batch {TRAIN_BATCH}: "
                                    f"{trip_err:.3e} > 1e-4")
            for n, fn, plain, inp in (
                    ("fused_glow_forward_1x1", K.fused_glow_forward_1x1,
                     K.fused_glow_forward_1x1_plain, x),
                    ("fused_glow_inverse_1x1", K.fused_glow_inverse_1x1,
                     K.fused_glow_inverse_1x1_plain, y_plain)):
                ref = plain(p, inp, CLAMP, len1)
                e = (fn(p, inp, CLAMP, len1) - ref).abs()
                check(bool(torch.isfinite(e).all()),
                      f"{n} C={c} batch {TRAIN_BATCH}: non-finite")
                check(bool((e <= 1e-4 + 1e-4 * ref.abs()).all()),
                      f"{n} C={c} batch {TRAIN_BATCH}: max abs err "
                      f"{e.max().item():.3e} exceeds 1e-4 + 1e-4|plain|")
                ms = median_ms(lambda: fn(p, inp, CLAMP, len1), 20)
                rows[n].append({
                    "shape": list(shape), "M": m, "C": c,
                    "max_abs_err": e.max().item(),
                    "ms": ms,
                    "plain_ms": median_ms(lambda: plain(p, inp, CLAMP, len1),
                                          10),
                    "warps": K.coupling_plan(c, len1, HIDDEN)[0],
                    "tf32_work_tflops": 3 * flops / ms / 1e9,
                    **coupling_bounds(flops, nbytes),
                    "round_trip_err": trip_err,
                })
                del ref, e
            del y_plain, trip
        for n, fn, plain in (
                ("fused_glow_backward_1x1", K.fused_glow_backward_1x1,
                 K.fused_glow_backward_1x1_plain),
                ("fused_glow_inverse_backward_1x1",
                 K.fused_glow_inverse_backward_1x1,
                 K.fused_glow_inverse_backward_1x1_plain)):
            inverse = n == BACKWARD[1]
            bflops, bbytes = backward_cost(m, c, HIDDEN, 4, inverse)
            (dp, dx), gates = K.backward_relu_gates(p, x, g, CLAMP, len1,
                                                    inverse)
            rp, rx = plain(p, x, g, CLAMP, len1)
            torch.cuda.synchronize()
            slack = K.relu_gate_slack(p, x, g, CLAMP, len1, inverse, gates)
            err, dx_use, leaves = _grads_close(dp, rp, dx, rx, 1e-4,
                                               f"{n} C={c}", slack)
            # the bound over every gate within 1e-5 of 0, for comparison
            _, _, near = _grad_margins(
                dp, rp, dx, rx, 1e-4,
                K.relu_gate_slack(p, x, g, CLAMP, len1, inverse))
            report = _gate_report(K, p, x, g, len1, inverse, gates)
            grad_err = max((a - b).abs().max().item() for a, b in
                           zip(K.param_leaves(dp), K.param_leaves(rp)))
            del dp, dx, gates
            faults = _planted_faults(K, n, p, x, g, len1, (rp, rx), slack)
            del rp, rx, slack
            red_ms, chunks, slot = _time_reduction(K, dev, m, c, len1)
            rows[n].append({
                "shape": list(shape), "M": m, "C": c,
                "max_abs_err": err, "grad_max_abs_err": grad_err,
                "ms": median_ms(lambda: fn(p, x, g, CLAMP, len1), 10),
                "reduce_ms": red_ms, "chunks": chunks,
                "partials_mb": chunks * slot * 4 / 1e6,
                "scratch_mb": K._bwd_lib()
                .sininn_coupling_1x1_bwd_scratch_floats(
                    int(inverse), m, c, len1, HIDDEN) * 4 / 1e6,
                "dx_limit_use": dx_use,
                "leaf_limit_use": [u for u, _ in leaves],
                "slack_over_limit": [sl for _, sl in leaves],
                "near_slack_over_limit": [sl for _, sl in near],
                "planted_fault_use": faults, **report,
                "plain_ms": median_ms(lambda: plain(p, x, g, CLAMP, len1),
                                      5),
                **coupling_bounds(bflops, bbytes),
            })
        del x, g
    # one bf16-storage case: K3 at octave 1
    c = 48
    p = _coupling_params(gen_w, c, dev)
    xb = torch.randn(shapes[0], generator=gen_x, device=dev).bfloat16()
    gb = torch.randn(shapes[0], generator=gen_x, device=dev).bfloat16()
    (dp, dx), gates = K.backward_relu_gates(p, xb, gb, CLAMP, c // 2)
    rp, rx = K.fused_glow_backward_1x1_plain(p, xb, gb, CLAMP, c // 2)
    check(dx.dtype == torch.bfloat16, f"bf16 K3 returned dx in {dx.dtype}")
    # both round fp32 results to bf16: at most one rounding step apart
    bf16_err, _, _ = _grads_close(
        dp, rp, dx, rx, 2.0 ** -7, "bf16 K3 C=48",
        K.relu_gate_slack(p, xb, gb, CLAMP, c // 2, gates=gates))
    print(f"[kernels] bf16-storage K3 C=48: dx max abs err {bf16_err:.3e}")
    for n, rs in rows.items():
        for r in rs:
            extra = (f", reduction {r['reduce_ms']:.3f} ms over "
                     f"{r['chunks']} slots ({r['partials_mb']:.1f} MB), "
                     f"scratch {r['scratch_mb']:.1f} MB, "
                     f"grads max abs err {r['grad_max_abs_err']:.3e}"
                     if "reduce_ms" in r else
                     f", {r['warps']} warps a block, "
                     f"{r['tf32_work_tflops']:.1f} TFLOP/s of TF32 work, "
                     f"round trip {r['round_trip_err']:.3e}")
            print(f"[kernels] batch {TRAIN_BATCH}: {n} C={r['C']} "
                  f"M={r['M']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} "
                  f"ms; bounds 3xTF32 {r['tf32x3_bound_ms']:.3f} / fp32 "
                  f"{r['fp32_bound_ms']:.3f} / bytes "
                  f"{r['bytes_bound_ms']:.3f} ms) max abs err "
                  f"{r['max_abs_err']:.3e}{extra}")
            if "reduce_ms" not in r:
                continue
            fmt = lambda v: " ".join(f"{u:.3g}" for u in v)
            print(f"[kernels]   {r['flipped_gates']} relu gates set "
                  f"otherwise than the plain version (largest |z| "
                  f"{r['flip_max_abs_z']:.2e}); limit used, dx "
                  f"{r['dx_limit_use']:.3g}, leaves "
                  f"{fmt(r['leaf_limit_use'])}; slack / limit, leaves "
                  f"{fmt(r['slack_over_limit'])} (over every gate within "
                  f"1e-5 of 0: {fmt(r['near_slack_over_limit'])}); "
                  f"planted faults, worst leaf / limit: "
                  + ", ".join(f"{k} {v:.3g}"
                              for k, v in r["planted_fault_use"].items()))
    return rows, bf16_err


def phase_path(dev, card: str):
    """SRF flagship `sr test` frames and eval on cuda, with launch counts."""
    import os.path as path

    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data.sr_video import make_datasets
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.models.inn import (build_inn_spec, inn_apply,
                                              params_to)
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import sr as SR

    counts = {}
    with tempfile.TemporaryDirectory() as work:
        cfg = SRConfig(scene="chip_smoke", device="cuda",
                       compute_dtype="float32", working_dir=work)
        check(cfg.val_batch_size == BATCH and cfg.lr_dims == 84
              and cfg.total_dims == 192 and cfg.octaves == 2,
              "SRConfig defaults are not the flagship SRF widths")
        t0 = time.perf_counter()
        video = synthetic_sr_video(cfg, num_frames=NUM_FRAMES, h=HR_H, w=HR_W)
        print(f"[path] synthetic video: hr {video.hr.shape}, lr "
              f"{video.lr.shape} in {time.perf_counter() - t0:.1f} s")

        init = R.named_fold(R.root_generator(cfg.random_seed), "init")
        spec, state = SR.create_state(init, cfg)
        store = CheckpointStore(path.join(LP.sr_dirs(cfg, "train"),
                                          "checkpoints"))
        store.save(1, state.state_dict())
        other = R.named_fold(R.root_generator(cfg.random_seed + 1), "init")
        spec, restored, _, step = LP._sr_create_and_restore(
            cfg, other, require="checkpoint missing")
        check(step == 1, f"restored step {step}, saved 1")
        same = all(torch.equal(a, b)
                   for pa, pb in zip(state.params, restored.params)
                   if pa is not None
                   for s in pa for c in pa[s] for a, b in
                   zip(pa[s][c].values(), pb[s][c].values()))
        check(same, "restored params differ from the saved ones")
        state = restored
        n_1x1 = sum(1 for l in spec if l.kind == "glow" and l.kernel == 1)
        check(n_1x1 == 4 and all(l.use_kernel for l in spec
                                 if l.kind == "glow"),
              "spec does not route the 1x1 couplings to the kernels")

        # sr test: one warm-up pass, then the counted and timed pass
        frames = np.stack(list(LP.sr_test_frames(cfg, video, state, spec)))
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = np.stack(list(LP.sr_test_frames(cfg, video, state, spec)))
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_counts = K.launch_counts()
        n_test = math.ceil(len(frames) / cfg.val_batch_size)
        check(frames.dtype == np.uint8 and frames.shape == (80, HR_H, HR_W, 3),
              f"test frames {frames.dtype} {frames.shape}, want uint8 "
              f"(80, {HR_H}, {HR_W}, 3)")
        check_counts(test_counts, f"sr test over {n_test} batches "
                                  "(4 inverse per batch)",
                     fused_glow_inverse_1x1=4 * n_test)
        fps = len(frames) / test_s
        print(f"[path] sr test: {len(frames)} frames in {n_test} batches, "
              f"{test_s:.3f} s, {fps:.2f} frames/s on {card}; launches "
              f"{test_counts}")

        # eval over the val split
        _, _, val = make_datasets(video, cfg)
        val_batches = val.device_cache(cfg.val_batch_size, dev)
        eval_step = SR.make_eval_step(spec, cfg)
        val_gen = R.named_fold(R.root_generator(cfg.random_seed, dev), "val")
        K.reset_launch_counts()
        metrics = [eval_step(state.params, vb, R.step_fold(val_gen, i))
                   for i, vb in enumerate(val_batches)]
        torch.cuda.synchronize()
        eval_counts = K.launch_counts()
        nb = len(val_batches)
        check_counts(eval_counts, f"eval over {nb} batches (4 each per "
                                  "batch)",
                     fused_glow_forward_1x1=4 * nb,
                     fused_glow_inverse_1x1=4 * nb)
        for i, m in enumerate(metrics):
            vals = {k: v.item() for k, v in m.items()}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"eval batch {i}: non-finite metric {vals}")
            print(f"[path] eval batch {i} ({val_batches[i]['hr'].shape[0]} "
                  f"windows): {vals}")
        add_counts(counts, test_counts)
        add_counts(counts, eval_counts)

        # invertibility at depth, float32 with TF32 convolutions
        with torch.inference_mode():
            hr = val_batches[0]["hr"].float() / 255.0
            rec = inn_apply(spec, state.params,
                            inn_apply(spec, state.params, hr), rev=True)
            inv_err = (rec - hr).abs().max().item()
        check(inv_err <= 1e-3, f"inverse(forward(hr)) error {inv_err:.3e} "
                               "> 1e-3")
        print(f"[path] invertibility at depth: max abs err {inv_err:.3e}")

        # agreement with the CPU reference on a small input: full fp32 on
        # both sides (kernels off), so only the summation order differs
        small = SRConfig(scene="chip_smoke", device="cpu",
                         compute_dtype="float32_highest", working_dir=work)
        spec_hi = build_inn_spec(small)[0]
        lr_small = val_batches[0]["lr"][:2, :8, :8].float() / 255.0
        z = torch.randn((2, 8, 8, small.z_dims),
                        generator=torch.Generator().manual_seed(7))
        lr_z = torch.cat([lr_small.cpu(), z], dim=-1)
        with torch.inference_mode():
            ref = inn_apply(spec_hi, params_to(state.params, "cpu"), lr_z,
                            rev=True)
            got = inn_apply(spec_hi, state.params, lr_z.to(dev), rev=True)
            ref_err = (got.cpu() - ref).abs().max().item()
        check(ref_err <= 1e-3, f"cuda vs cpu inverse (float32_highest): "
                               f"{ref_err:.3e} > 1e-3")
        print(f"[path] cuda vs cpu reference (2x64x64, float32_highest): "
              f"max abs err {ref_err:.3e}")
        print(f"[path] peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts, fps


def _leaf_grads(params):
    from sin_inn_tpu_torch.models.inn import flat_params

    return [t.grad.detach().clone() for t in flat_params(params)]


def phase_train(dev, card: str, smi_line: str, work: str):
    """SRF flagship training on cuda: run_sr_train, resume, launch counts,
    gradient agreement with the cuDNN route, and train frames/s. The run's
    checkpoints stay in ``work`` for phase 13's export."""
    import os.path as path

    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data.sr_video import make_datasets, to_device
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.models.inn import build_inn_spec, params_to
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import sr as SR

    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {}
    stats = {}
    with contextlib.nullcontext(work):
        cfg = SRConfig(scene="chip_smoke_train", device="cuda",
                       compute_dtype="float32", working_dir=work,
                       batch_size=TRAIN_BATCH, epochs=2, print_iter=1,
                       save_iter=1)
        check(cfg.batch_size == TRAIN_BATCH and cfg.learning_rate == 1e-4
              and cfg.adam_betas == (0.9, 0.99) and cfg.weight_decay == 1e-5
              and cfg.total_dims == 192 and cfg.num_coupling == 4
              and cfg.hidden_channels == HIDDEN,
              "SRConfig defaults are not the flagship training config")
        t0 = time.perf_counter()
        video = synthetic_sr_video(cfg, num_frames=TRAIN_FRAMES, h=HR_H,
                                   w=HR_W)
        sup, unsup, _ = make_datasets(video, cfg)
        check(len(sup) >= 2 * TRAIN_BATCH,
              f"{len(sup)} training windows, want >= {2 * TRAIN_BATCH}")
        print(f"[train] synthetic video: hr {video.hr.shape}, "
              f"{len(sup)} training windows, in "
              f"{time.perf_counter() - t0:.1f} s")

        # run_sr_train: 2 epochs of 2 full batches, then resume to 3
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = LP.run_sr_train(cfg, video=video)
        torch.cuda.synchronize()
        run_counts = K.launch_counts()
        steps = out["state"].step
        m = out["metrics"]
        check(out["start_epoch"] == 0 and steps == 4,
              f"run_sr_train took {steps} steps from epoch "
              f"{out['start_epoch']}, want 4 from 0")
        check(all(math.isfinite(v) for v in m.values()),
              f"run_sr_train: non-finite metric {m}")
        ckpts = CheckpointStore(path.join(out["exp_dir"],
                                          "checkpoints")).latest_step()
        check(ckpts == 2, f"latest checkpoint {ckpts}, want 2")
        # 4 K1 + 4 K2 + 4 K3 + 4 K4 per step; 4 K1 + 4 K2 per eval batch
        evals = 2
        check_counts(run_counts, "run_sr_train (4 steps, 2 evals)",
                     fused_glow_forward_1x1=4 * steps + 4 * evals,
                     fused_glow_inverse_1x1=4 * steps + 4 * evals,
                     fused_glow_backward_1x1=4 * steps,
                     fused_glow_inverse_backward_1x1=4 * steps,
                     reduce_weight_grads=8 * steps)
        add_counts(counts, run_counts)
        print(f"[train] run_sr_train: {steps} steps in "
              f"{time.perf_counter() - t0:.1f} s; metrics {m}")

        K.reset_launch_counts()
        again = LP.run_sr_train(cfg.replace(epochs=3), video=video)
        torch.cuda.synchronize()
        add_counts(counts, K.launch_counts())
        st = again["state"]
        opt_steps = {int(v["step"]) for v in
                     st.optimizer.state_dict()["state"].values()}
        check(again["start_epoch"] == 2,
              f"resume started at epoch {again['start_epoch']}, want 2")
        check(st.step == 6 and opt_steps == {6},
              f"after resume: step {st.step}, optimizer steps {opt_steps}, "
              "want 6")
        check(math.isfinite(again["metrics"]["loss"]),
              f"resumed loss {again['metrics']['loss']}")
        print(f"[train] resumed at epoch 2: step {st.step}, optimizer step "
              f"{opt_steps}, loss {again['metrics']['loss']:.6g}")

        spec = again["spec"]
        batch = sup.device_cache(TRAIN_BATCH, dev)[0]
        b, h, w, _ = batch["lr"].shape
        step = SR.make_train_step(spec, cfg)
        gen = torch.Generator(device=dev).manual_seed(11)

        # one default step: launch counts
        K.reset_launch_counts()
        aux = step(st, batch, None, gen)
        torch.cuda.synchronize()
        one = K.launch_counts()
        check_counts(one, "one train step", fused_glow_forward_1x1=4,
                     fused_glow_inverse_1x1=4, fused_glow_backward_1x1=4,
                     fused_glow_inverse_backward_1x1=4,
                     reduce_weight_grads=8)
        add_counts(counts, one)

        # one step with TCR (5 iterations) and both MMD terms
        tcr_cfg = cfg.replace(lambda_bwd_tcr=1.0, tcr_iters=5,
                              lambda_fwd_mmd=1.0, lambda_bwd_mmd=1.0)
        tcr_step = SR.make_train_step(spec, tcr_cfg)
        unsup_batch = to_device(unsup.random_batch(TRAIN_BATCH), dev)
        K.reset_launch_counts()
        aux = tcr_step(st, batch, unsup_batch, gen)
        torch.cuda.synchronize()
        tcr = K.launch_counts()
        check_counts(tcr, "one TCR + MMD train step",
                     fused_glow_forward_1x1=4, fused_glow_inverse_1x1=44,
                     fused_glow_backward_1x1=4,
                     fused_glow_inverse_backward_1x1=44,
                     reduce_weight_grads=48)
        add_counts(counts, tcr)
        check(counts["reduce_weight_grads"] ==
              counts[BACKWARD[0]] + counts[BACKWARD[1]],
              f"launches {counts}: one reduction per K3/K4 launch")
        vals = {k: v.item() for k, v in aux.items()}
        check(all(math.isfinite(v) for v in vals.values()) and
              vals["tcr"] > 0, f"TCR + MMD step: loss terms {vals}")
        print(f"[train] one TCR (5 iters) + MMD step: {vals}; launches {tcr}")

        # gradients of the kernel route against the cuDNN route
        draws = SR.draw_sr_noise(torch.Generator(device=dev).manual_seed(3),
                                 cfg, b, h, w)
        routes = {}
        for route in ("auto", "off"):
            rcfg = cfg.replace(use_kernel=route)
            rspec, _ = build_inn_spec(rcfg)
            check(any(l.use_kernel for l in rspec) == (route == "auto"),
                  f"use_kernel={route} routes the wrong way")
            params = [None if p is None else
                      {s: {c: {k: t.detach().clone() for k, t in conv.items()}
                           for c, conv in sub.items()}
                       for s, sub in p.items()}
                      for p in params_to(st.params, dev)]
            rstate = SR.train_state(params, rcfg)
            loss, _ = SR.sr_loss(rstate.params, rspec, rcfg, batch, None,
                                 draws)
            loss.backward()
            routes[route] = (loss.item(), _leaf_grads(rstate.params))
        (la, ga), (lo, go) = routes["auto"], routes["off"]
        worst = max((a - o).norm().item() / max(o.norm().item(), 1e-30)
                    for a, o in zip(ga, go))
        loss_rel = abs(la - lo) / abs(lo)
        print(f"[train] kernel route vs cuDNN route: worst leaf normwise "
              f"relative error {worst:.3e} (limit 2e-2), loss {la:.7g} vs "
              f"{lo:.7g} (relative {loss_rel:.3e}, limit 1e-3)")
        check(worst <= 2e-2, f"gradient agreement: {worst:.3e} > 2e-2")
        check(loss_rel <= 1e-3, f"loss agreement: {loss_rel:.3e} > 1e-3")
        stats.update(grad_worst=worst, loss_rel=loss_rel)
        del routes, ga, go

        # throughput: 2 warm-up steps, then 10 timed
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            step(st, batch, None, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            aux = step(st, batch, None, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(math.isfinite(aux["loss"].item()), "non-finite loss")
        stats.update(frames_per_sec=10 * TRAIN_BATCH / dt,
                     ms_per_step=dt * 100,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        print(f"[train] {stats['frames_per_sec']:.2f} train frames/s, "
              f"{stats['ms_per_step']:.2f} ms/step (batch {TRAIN_BATCH}, "
              f"HR {HR_H}x{HR_W}, float32), peak device memory "
              f"{stats['peak_gib']:.2f} GiB, on {card} ({smi_line})")
        stats["cfg"] = cfg.replace(epochs=3)
        stats["batch"] = batch
    return counts, stats


def _window_flow(gen, dev):
    """A seeded smooth flow (1, 436, 1024, 2) that leaves the dy=64 /
    dx=128 window in part of the frame, plus a little noise."""
    ys = torch.linspace(0.0, math.pi, FLOW_H, device=dev)[None, :, None]
    xs = torch.linspace(0.0, 2 * math.pi, FLOW_W, device=dev)[None, None, :]
    noise = torch.randn((1, FLOW_H, FLOW_W, 2), generator=gen, device=dev)
    fx = 170.0 * torch.sin(xs + 0.5 * ys) + noise[..., 0]
    fy = 85.0 * torch.cos(xs - ys) + noise[..., 1]
    return torch.stack([fx, fy], -1).contiguous()


def _splat_scratch_bytes(values) -> int:
    """Bytes of the scratch one K5 launch on ``values`` allocates (its max
    partials: c + 1 words of 4 bytes a slot)."""
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    return 8 * K5._lib().sininn_splat_region_scratch(*values.shape)


def _close(got, ref, what: str) -> float:
    e = (got - ref).abs()
    check(bool(torch.isfinite(e).all()), f"{what}: non-finite")
    check(bool((e <= 1e-5 + 1e-5 * ref.abs()).all()),
          f"{what}: max abs err {e.max().item():.3e} exceeds "
          f"1e-5 + 1e-5|plain|")
    return e.max().item()


def phase_flow_kernels(dev):
    """K5/K6 against their plain versions at the flow path's shapes, with
    flows beyond the window; times, bounds and the library yardstick."""
    import torch.nn.functional as F

    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    gen = torch.Generator(device=dev).manual_seed(6)
    fl = _window_flow(gen, dev)
    out_y = (fl[..., 1].abs() > DY - 1).float().mean().item()
    out_x = (fl[..., 0].abs() > DX - 1).float().mean().item()
    check(out_y > 0.05 and out_x > 0.05,
          f"flow leaves the window at too few pixels ({out_y:.3f}, "
          f"{out_x:.3f})")
    img = torch.rand((1, FLOW_H, FLOW_W, 3), generator=gen, device=dev)
    metric = -20.0 * torch.rand((1, FLOW_H, FLOW_W, 1), generator=gen,
                                device=dev)
    e = metric.exp()
    cat = torch.cat([img * e, e, torch.ones_like(e)], -1).contiguous()
    coord = K6.resample_coord(FLOW_H, FLOW_W)
    px = FLOW_H * FLOW_W
    rows = {}
    with torch.inference_mode():
        got = K6.gather_region(img, fl, DY, DX, coord)
        ref = K6.gather_region_plain(img, fl, DY, DX, coord)
        torch.cuda.synchronize()
        err6 = _close(got, ref, "gather_region (K6)")
        # the library yardstick: grid_sample on resample2d's normalised
        # grid (NCHW input); the same function for flows in the window
        ys, xs = torch.meshgrid(
            torch.arange(FLOW_H, device=dev, dtype=torch.float32),
            torch.arange(FLOW_W, device=dev, dtype=torch.float32),
            indexing="ij")
        grid = torch.stack([(xs + fl[0, ..., 0]) / (FLOW_W - 1) * 2 - 1,
                            (ys + fl[0, ..., 1]) / (FLOW_H - 1) * 2 - 1],
                           -1)[None]
        nchw = img.permute(0, 3, 1, 2).contiguous()
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                    padding_mode="zeros",
                                    align_corners=False)
        nbytes = px * (3 + 2 + 3) * 4
        flops = px * (16 + 9 * 3)
        kern = lambda: K6.gather_region(img, fl, DY, DX, coord)
        # ms and library_ms: the interleaved loop of _local_flow_kernels
        static_calls = {"gather_region": kern, "grid_sample": lib}
        rows["gather_region"] = {
            "shape": [1, FLOW_H, FLOW_W, 3], "max_abs_err": err6,
            "plain_ms": device_ms(lambda: K6.gather_region_plain(
                img, fl, DY, DX, coord), 10),
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3}

        got = K5.splat_region(cat, fl, DY, DX)
        again = K5.splat_region(cat, fl, DY, DX)
        ref = K5.splat_region_plain(cat, fl, DY, DX)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "K5: two launches differ")
        err5 = _close(got, ref, "splat_region (K5)")
        cov_err = _close(got[..., 4:], ref[..., 4:], "K5 coverage channel")
        exact = (ref[..., 4:] - K5.splat_region_plain(
            cat[..., 4:].contiguous(), fl, 4 * DY, 4 * DX)).abs().max()
        check(exact.item() > 0.1, "the window dropped no tap")
        nbytes = px * (5 + 2 + 5) * 4
        flops = px * (16 + 12 * 5)
        kern = lambda: K5.splat_region(cat, fl, DY, DX)
        rows["splat_region"] = {
            "shape": [1, FLOW_H, FLOW_W, 5], "max_abs_err": err5,
            "coverage_max_abs_err": cov_err, "bitwise_repeatable": True,
            "scratch_bytes": _splat_scratch_bytes(cat),
            "ms": device_ms(kern, 50),
            "plain_ms": device_ms(lambda: K5.splat_region_plain(
                cat, fl, DY, DX), 10),
            "library_ms": None,
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3}
    rows.update(_local_flow_kernels(dev, img, cat, rows, static_calls))
    for n, r in rows.items():
        lib_s = ("" if r["library_ms"] is None
                 else f", grid_sample {r['library_ms']:.4f} ms")
        print(f"[flow kernels] {n} {r['shape']}: {r['ms']:.4f} ms on the "
              f"device, {r['event_ms']:.4f} ms between events (plain "
              f"{r['plain_ms']:.3f} ms{lib_s}; bound bytes "
              f"{r['bytes_bound_ms']:.4f} / fp32 {r['ops_bound_ms']:.4f} ms)"
              f" max abs err {r['max_abs_err']:.3e}")
    print(f"[flow kernels] flow beyond the window at {out_y:.1%} (y) and "
          f"{out_x:.1%} (x) of the pixels; K5 and K5 local: two launches "
          f"bitwise equal, scratch {rows['splat_region']['scratch_bytes']} "
          f"bytes a launch")
    return rows


def _local_flow(gen, dev):
    """A seeded flow (1, 436, 1024, 2) with a drift of 10-40 px per 128 x 128
    tile (a different one in each tile), +-4 px of smooth detail, and a
    16-column stripe of 45 px more in y that leaves the local row window
    (dy 32)."""
    hb, wb = -(-FLOW_H // 128), -(-FLOW_W // 128)
    drift = 10.0 + 30.0 * torch.rand((1, hb, wb, 2), generator=gen,
                                     device=dev)
    drift = drift.repeat_interleave(128, 1).repeat_interleave(128, 2)
    ys = torch.arange(FLOW_H, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(FLOW_W, device=dev, dtype=torch.float32)[None, None, :]
    detail = 4.0 * torch.stack([torch.sin(xs / 23.0 + ys / 31.0),
                                torch.cos(xs / 29.0 - ys / 19.0)], -1)
    stripe = 45.0 * ((xs >= 700) & (xs < 716)).float().expand(1, FLOW_H,
                                                              FLOW_W)
    fl = drift[:, :FLOW_H, :FLOW_W] + detail
    fl[..., 1] += stripe
    return fl.contiguous()


def _local_flow_kernels(dev, img, cat, rows_static, static_calls):
    """K6 local (C = 3, resample coordinates) and K5 local (C = 5) against
    their plain versions at 1 x 436 x 1024, local dy 32, dx 128, cap_y 64,
    on the offsets of a flow that leaves the local window in part; times,
    bounds and the offsets' own time. K6 local, grid_sample on the same
    flow, K6 static and grid_sample on the static row's flow
    (``static_calls``) are timed in turns in one loop, 200 launches each:
    the ms and library_ms of both K6 rows."""
    import torch.nn.functional as F

    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5
    from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

    fl = _local_flow(torch.Generator(device=dev).manual_seed(11), dev)
    offs = tile_flow_offsets(fl, 128, 128, CAPY, 0)
    dev_y = max(offs.dev_src[1].item(), offs.dev_out[1].item())
    check(dev_y > LDY - 1, f"the flow stays within the local window "
                           f"(deviation {dev_y:.1f} px)")
    check(offs.off_src[..., 1].abs().min().item() >= 8,
          "a tile of the local flow has no row offset")
    coord = K6.resample_coord(FLOW_H, FLOW_W)
    px = FLOW_H * FLOW_W
    rows = {}
    with torch.inference_mode():
        got = K6.gather_region_local(img, fl, offs.off_src, LDY, DX, CAPY, 0,
                                     coord)
        ref = K6.gather_region_plain(img, fl, LDY, DX, coord,
                                     off_src=offs.off_src)
        torch.cuda.synchronize()
        err = _close(got, ref, "gather_region_local (K6 local)")
        ys, xs = torch.meshgrid(
            torch.arange(FLOW_H, device=dev, dtype=torch.float32),
            torch.arange(FLOW_W, device=dev, dtype=torch.float32),
            indexing="ij")
        grid = torch.stack([(xs + fl[0, ..., 0]) / (FLOW_W - 1) * 2 - 1,
                            (ys + fl[0, ..., 1]) / (FLOW_H - 1) * 2 - 1],
                           -1)[None]
        nchw = img.permute(0, 3, 1, 2).contiguous()
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                    padding_mode="zeros",
                                    align_corners=False)
        # the static kernel's bytes plus the offsets read once
        nbytes = px * (3 + 2 + 3) * 4 + offs.off_src.numel() * 4
        flops = px * (16 + 9 * 3)
        kern = lambda: K6.gather_region_local(img, fl, offs.off_src, LDY, DX,
                                              CAPY, 0, coord)
        turns = interleaved_device_ms(
            {"gather_region_local": kern, "grid_sample (local flow)": lib,
             "gather_region": static_calls["gather_region"],
             "grid_sample (static flow)": static_calls["grid_sample"]}, 200)
        for n, t in turns.items():
            print(f"[flow kernels] in turns: {_spread_line(n, t)}")
        rows_static["gather_region"].update(
            ms=turns["gather_region"]["median_ms"],
            library_ms=turns["grid_sample (static flow)"]["median_ms"],
            turns={"kernel": turns["gather_region"],
                   "grid_sample": turns["grid_sample (static flow)"]})
        rows["gather_region_local"] = {
            "shape": [1, FLOW_H, FLOW_W, 3], "max_abs_err": err,
            "ms": turns["gather_region_local"]["median_ms"],
            "plain_ms": device_ms(lambda: K6.gather_region_plain(
                img, fl, LDY, DX, coord, off_src=offs.off_src), 10),
            "library_ms": turns["grid_sample (local flow)"]["median_ms"],
            "turns": {"kernel": turns["gather_region_local"],
                      "grid_sample": turns["grid_sample (local flow)"]},
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3}

        got = K5.splat_region_local(cat, fl, offs.off_out, offs.off_src, LDY,
                                    DX)
        again = K5.splat_region_local(cat, fl, offs.off_out, offs.off_src,
                                      LDY, DX)
        ref = K5.splat_region_local_plain(cat, fl, offs.off_out, LDY, DX)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "K5 local: two launches differ")
        err = _close(got, ref, "splat_region_local (K5 local)")
        dropped = (ref - K5.splat_region_plain(cat, fl, 4 * DY, 4 * DX)
                   ).abs().max().item()
        check(dropped > 0.1, "the local window dropped no tap")
        nbytes = px * (5 + 2 + 5) * 4 + offs.off_out.numel() * 4
        flops = px * (16 + 12 * 5)
        kern = lambda: K5.splat_region_local(cat, fl, offs.off_out,
                                             offs.off_src, LDY, DX)
        rows["splat_region_local"] = {
            "shape": [1, FLOW_H, FLOW_W, 5], "max_abs_err": err,
            "bitwise_repeatable": True,
            "scratch_bytes": _splat_scratch_bytes(cat),
            "ms": device_ms(kern, 50),
            "plain_ms": device_ms(lambda: K5.splat_region_local_plain(
                cat, fl, offs.off_out, LDY, DX), 10),
            "library_ms": None,
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3}
        off_ms = device_ms(lambda: tile_flow_offsets(fl, 128, 128, CAPY, 0),
                           20)
        off_event = median_ms(lambda: tile_flow_offsets(fl, 128, 128, CAPY,
                                                        0), 20)
    print(f"[flow kernels] local flow: deviation from the tile offsets up to "
          f"{dev_y:.1f} px (local dy {LDY}); tile_flow_offsets {off_ms:.4f} "
          f"ms on the device, {off_event:.4f} ms between events per flow")
    return rows


def _kernel_modules():
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import inr as K7
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    return K, K5, K6, K7, K8


def _all_counts():
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launch_counts())
    return counts


def _reset_all_counts():
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def phase_flow(dev, card: str, smi_line: str):
    """Flow serving at Sintel size: checkpoint round trip, the RBF encoding
    against the TF32 flag, flow test and interpolation with launch counts
    and frames/s, endpoint exactness, a mid-frame on flows of Sintel
    magnitude, and the card against the CPU on a small crop."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inr import (build_inr, flat_leaves,
                                              get_encoding, tree_to)
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train import loop as LP

    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    # the flow path itself never touches the TF32 flag: it is off here as
    # PyTorch leaves it (and as phases 3-5 set it), and the RBF encoding is
    # shown below not to depend on it
    tf32 = torch.backends.cuda.matmul
    check(not tf32.allow_tf32, "TF32 matmuls on at the start of the flow "
                                "phase")
    stats = {}
    with tempfile.TemporaryDirectory() as work:
        cfg = FlowConfig(device="cuda", checkpoints_dir=work + "/ck",
                         results_dir=work + "/results")
        check(cfg.net == "RBF" and cfg.num_frequencies == 256
              and cfg.hidden_dim == 256 and cfg.num_layers == 3
              and cfg.size == 436 and cfg.test_batch == 1
              and cfg.occl == "wang",
              "FlowConfig defaults are not the Sintel RBF config")
        t0 = time.perf_counter()
        media = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                               seed=1))
        check(media.flow_scale == FLOW_W / 5.0, "flow_scale is not W/5")
        scene = "chip_smoke"
        spec, params, consts = build_inr(
            R.named_fold(R.root_generator(cfg.random_seed), "init"),
            cfg.net, cfg, dev)
        check(spec.encoding_dim == 512 and [tuple(l["w"].shape) for l in
                                            params["mlp"]] ==
              [(512, 256), (256, 256), (256, 256), (256, 4)],
              "the RBF net is not E=512, MLP 512-256-256-256-4")
        CheckpointStore(LP.flow_ckpt_dir(cfg, scene)).save(
            7, LP.flow_state_dict(params, consts, 7))
        other = R.named_fold(R.root_generator(cfg.random_seed + 1), "init")
        spec, rp, rc, _, step, _, _ = LP._flow_create_and_restore(
            cfg, other, scene, require="checkpoint missing")
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flat_leaves({"p": params, "c": consts}),
            flat_leaves({"p": rp, "c": rc})))
        check(step == 7 and same, f"restore: step {step}, same {same}")
        params, consts = rp, rc
        print(f"[flow] synthetic video {media.video.shape}, RBF INR saved "
              f"and restored, in {time.perf_counter() - t0:.1f} s")

        # the RBF distance stays full fp32 whatever a user's process sets
        # the TF32 flag to: the encoding of the whole Sintel pose grid is
        # bitwise the same with TF32 matmuls allowed
        pts = FT.pose_grid(torch.tensor([0.2], device=dev), FLOW_H,
                           FLOW_W).reshape(-1, 3)
        with torch.inference_mode():
            enc_off = get_encoding(spec, params, consts, pts)
            try:
                tf32.allow_tf32 = True
                enc_on = get_encoding(spec, params, consts, pts)
            finally:
                tf32.allow_tf32 = False
        check(torch.equal(enc_off, enc_on),
              "the RBF encoding changes with allow_tf32: max abs diff "
              f"{(enc_off - enc_on).abs().max().item():.3e}")
        del pts, enc_off, enc_on
        print("[flow] RBF encoding of the 436x1024 grid: bitwise the same "
              "with allow_tf32 on and off")

        # flow test: one warm-up pass, then the counted and timed pass
        check(not tf32.allow_tf32, "TF32 matmuls on")
        LP.flow_test_outputs(cfg, media, spec, params, consts)
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = LP.flow_test_outputs(cfg, media, spec, params, consts)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_counts = _all_counts()
        pairs = FLOW_FRAMES - 1
        check_counts(test_counts, "flow test (the exact occlusion scatter)")
        f12, masks = out["flow12"], out["masks"]
        check(f12.shape == (pairs, FLOW_H, FLOW_W, 2)
              and bool(np.isfinite(f12).all()),
              f"flow test flows {f12.shape}, finite "
              f"{bool(np.isfinite(f12).all())}")
        check(masks.shape == (pairs, FLOW_H, FLOW_W, 1)
              and set(np.unique(masks)) <= {0.0, 1.0},
              f"occlusion masks {masks.shape} {np.unique(masks)[:5]}")
        stats["test_fps"] = pairs / test_s
        mag = np.sqrt((f12 ** 2).sum(-1))
        print(f"[flow] flow test: {pairs} pairs in {test_s:.3f} s, "
              f"|flow| mean {mag.mean():.2f} px, max {mag.max():.2f} px, "
              f"visible {masks.mean():.3f}; launches {test_counts}")

        # interpolation at factor 2: warm-up, then counted and timed
        check(not tf32.allow_tf32, "TF32 matmuls on")
        LP.interpolate_frames(cfg, media, spec, params, consts, 2)
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = LP.interpolate_frames(cfg, media, spec, params, consts, 2)
        torch.cuda.synchronize()
        interp_s = time.perf_counter() - t0
        interp_counts = _all_counts()
        check_counts(interp_counts, f"interpolation ({pairs} mid-frames, 2 "
                                    "K5 + 2 K6 each)",
                     splat_region=2 * pairs, gather_region=2 * pairs)
        u8 = (np.clip(media.video, 0, 1) * 255).astype(np.uint8)
        check(frames.shape == (2 * pairs + 1, FLOW_H, FLOW_W, 3)
              and frames.dtype == np.uint8
              and np.array_equal(frames[::2], u8),
              f"interpolated frames {frames.shape} {frames.dtype}")
        stats["interp_fps"] = pairs / interp_s
        stats["counts"] = interp_counts
        print(f"[flow] interpolation x2: {pairs} mid-frames ({len(frames)} "
              f"frames out) in {interp_s:.3f} s; launches {interp_counts}")

        # alpha = 0 and 1 reproduce the endpoints at full size on the card
        pair = torch.from_numpy(media.video[2:4]).to(dev)
        ends = []
        for alpha, want in ((0.0, pair[0]), (1.0, pair[1])):
            got = FT.frame_interp(spec, cfg, params, consts,
                                  float(media.times[2]), pair, alpha,
                                  media.flow_scale)
            ends.append((got - want).abs().max().item())
        check(max(ends) <= 1e-5, f"endpoint frames: max abs err {ends}")
        print(f"[flow] alpha 0 / 1 reproduce the endpoints: max abs err "
              f"{ends[0]:.3e} / {ends[1]:.3e}")

        # the seeded net's flows are a few px; the same net at 16x the
        # flow scale gives flows of Sintel magnitude (tens of px, some
        # beyond the window): one mid-frame timed, and K5 on its splat
        # input, beside the same at the path's scale
        t2 = float(media.times[2])
        for tag, sc in (("path", media.flow_scale),
                        ("x16", 16.0 * media.flow_scale)):
            with torch.inference_mode():
                f01, _ = FT.flow_infer(spec, params, consts,
                                       torch.tensor([t2], device=dev), sc,
                                       FLOW_H, FLOW_W)
                mid = FT.frame_interp(spec, cfg, params, consts, t2, pair,
                                      0.5, sc)
                check(bool(torch.isfinite(mid).all()),
                      f"mid-frame at flow scale {tag}: non-finite")
                frame0 = pair[0:1]
                m0 = (frame0 - K6.resample2d_region(pair[1:2], f01, DY, DX)
                      ).abs().mean(-1, keepdim=True)
                e = torch.exp(-20.0 * m0)
                cat = torch.cat([frame0 * e, e, torch.ones_like(e)],
                                -1).contiguous()
                half = (0.5 * f01).contiguous()
                mag = f01.norm(dim=-1)
                beyond = ((f01[..., 1].abs() > DY - 1)
                          | (f01[..., 0].abs() > DX - 1)).float().mean()
                stats[f"scale_{tag}"] = {
                    "flow_mean_px": mag.mean().item(),
                    "flow_max_px": mag.max().item(),
                    "beyond_window": beyond.item(),
                    "mid_frame_ms": median_ms(lambda: FT.frame_interp(
                        spec, cfg, params, consts, t2, pair, 0.5, sc), 10),
                    "k5_device_ms": device_ms(lambda: K5.splat_region(
                        cat, half, DY, DX), 20)}
            r = stats[f"scale_{tag}"]
            print(f"[flow] flow scale {tag} ({sc:.1f}): |flow| mean "
                  f"{r['flow_mean_px']:.2f} px, max {r['flow_max_px']:.2f} "
                  f"px, beyond the window at {r['beyond_window']:.2%}; "
                  f"mid-frame {r['mid_frame_ms']:.3f} ms between events, "
                  f"K5 {r['k5_device_ms']:.4f} ms on the device")

        # one mid-frame from a checkpoint whose sidecar names local windows
        # (dy 64, dx 128, local dy 32): K5 local and K6 local, 2 each
        ck = LP.flow_ckpt_dir(cfg, scene)
        LP._save_window_bounds(ck, cfg.replace(
            splat_max_dy=DY, splat_max_dx=DX, splat_local_dy=LDY,
            splat_local_dx=None), FLOW_H, FLOW_W)
        lcfg, found = LP._load_window_bounds(cfg, ck, FLOW_H, FLOW_W)
        lcfg = LP._inference_bounds(lcfg)
        check(found and (lcfg.splat_max_dy, lcfg.splat_max_dx,
                         lcfg.splat_local_dy) == (DY, DX, LDY),
              f"local sidecar applied as {lcfg}")
        _reset_all_counts()
        mid_l = FT.frame_interp(spec, lcfg, params, consts, t2, pair, 0.5,
                                media.flow_scale)
        torch.cuda.synchronize()
        local_counts = _all_counts()
        check_counts(local_counts, "one mid-frame from a local-window sidecar",
                     splat_region_local=2, gather_region_local=2)
        mid_s = FT.frame_interp(spec, cfg, params, consts, t2, pair, 0.5,
                                media.flow_scale)
        lerr = (mid_l - mid_s).abs().max().item()
        check(bool(torch.isfinite(mid_l).all()) and lerr <= 1e-4,
              f"local-window mid-frame against the static one: {lerr:.3e} "
              f"(flows within both windows; limit 1e-4)")
        add_counts(interp_counts, local_counts)
        stats["local_mid_frame_ms"] = median_ms(lambda: FT.frame_interp(
            spec, lcfg, params, consts, t2, pair, 0.5, media.flow_scale), 10)
        print(f"[flow] one mid-frame from a local-window sidecar (local dy "
              f"{LDY}): launches {local_counts}, "
              f"{stats['local_mid_frame_ms']:.3f} ms between events, against "
              f"the static windows {lerr:.3e}")

        # the card against the CPU on a small crop (kernel route pinned)
        small = cfg.replace(splat_max_dy=16, splat_max_dx=16)
        crop = np.ascontiguousarray(media.video[2:4, :40, :64])
        t2 = torch.tensor([float(media.times[2])])
        res = []
        for d in (dev, torch.device("cpu")):
            p_, c_ = tree_to(params, d), tree_to(consts, d)
            fl, _ = FT.flow_infer(spec, p_, c_, t2.to(d), 12.8, 40, 64)
            mid = FT.frame_interp(spec, small, p_, c_, float(t2),
                                  torch.from_numpy(crop).to(d), 0.5, 12.8)
            res.append((fl.cpu(), mid.cpu()))
        (fg, mg), (fc, mc) = res
        ferr = (fg - fc).abs().max().item()
        merr = (mg - mc).abs().max().item()
        check(ferr <= 1e-3 and merr <= 1e-3,
              f"card vs CPU on a 40x64 crop: flows {ferr:.3e} px, frame "
              f"{merr:.3e} (limits 1e-3)")
        print(f"[flow] card vs CPU (40x64 crop): flows max abs err "
              f"{ferr:.3e} px, mid-frame {merr:.3e}")
        check(not tf32.allow_tf32, "TF32 matmuls on")
        stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[flow] peak device memory {stats['peak_gib']:.2f} GiB, on {card} "
          f"({smi_line})")
    return stats


def inr_backward_cost(n: int, widths):
    """FLOP and bytes of one K7 backward launch with its reduction, for an
    MLP of ``widths`` = [E, H, ..., H, O] over n points (d = 3): the
    recompute of the hidden layers, every weight gradient, and the g chain
    through all layers but the first, 2 FLOP per multiply-add; x and g read
    once, each weight and bias read once and its gradient written once."""
    mats = [a * b for a, b in zip(widths[:-1], widths[1:])]
    flops = 2 * n * (sum(mats[:-1]) + sum(mats) + sum(mats[1:]))
    params = sum(mats) + sum(widths[1:])
    return flops, 4 * (n * (3 + widths[-1]) + 2 * params)


def inr_backward_bounds(flops: int, nbytes: int):
    """K7 backward's bounds in ms: its products as it runs them, three TF32
    products each on the tensor cores (3xTF32: ``ops_bound_ms``, what its
    ``bound_ms`` reads), at the fp32 rate beside it, and its bytes."""
    return {"ops_bound_ms": 3 * flops / PEAK_TF32 * 1e3,
            "fp32_bound_ms": flops / PEAK_FP32 * 1e3,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3}


def phase_flow_train_kernels(dev):
    """K6 grads and K7 backward against their plain versions at the flow
    train step's shapes; times, bounds, determinism."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.models.inr import build_inr
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import inr as K7
    from sin_inn_tpu_torch.train import flow as FT

    fl = _window_flow(torch.Generator(device=dev).manual_seed(6), dev)
    zero = torch.zeros_like(fl)
    gen = torch.Generator(device=dev).manual_seed(8)
    px = FLOW_H * FLOW_W
    grads_rows = []
    for c, coord, tag in ((3, K6.resample_coord(FLOW_H, FLOW_W), "resample"),
                          (5, K6.RAW, "raw")):
        a = torch.rand((1, FLOW_H, FLOW_W, c), generator=gen, device=dev)
        q = torch.randn((1, FLOW_H, FLOW_W, c), generator=gen, device=dev)
        err = 0.0
        for fname, f in (("window flow", fl), ("zero flow", zero)):
            got = K6.gather_region_grads(a, f, q, DY, DX, coord)
            ref = K6.gather_region_grads_plain(a, f, q, DY, DX, coord)
            torch.cuda.synchronize()
            for name, g_, r_ in zip(("out", "dfx", "dfy"), got, ref):
                err = max(err, _close(g_, r_, f"gather_region_grads C={c} "
                                              f"{tag}, {fname}, {name}"))
            if fname == "zero flow" and tag == "raw":
                # every tap distance is 0 or 1: dhat is 0 at both
                check(not bool(got[1].any()) and not bool(got[2].any()),
                      "K6 grads: zero flow in raw coordinates gives a "
                      "non-zero derivative")
                check(torch.equal(got[0], a), "K6 grads: zero flow in raw "
                                              "coordinates is not the identity")
        check(bool(K6.gather_region_grads(a, fl, q, DY, DX, coord)[1].any()),
              "K6 grads: no flow derivative on the window flow")
        nbytes = px * (3 * c + 2 + 2) * 4
        flops = px * (24 + 24 * c)
        kern = lambda: K6.gather_region_grads(a, fl, q, DY, DX, coord)
        turns = interleaved_device_ms(
            {"kernel": kern, "grid_sampler_2d_backward": _grid_grad_call(
                a, fl, q)}, 200)
        grads_rows.append({
            "shape": [1, FLOW_H, FLOW_W, c], "coord": tag,
            "max_abs_err": err, "ms": turns["kernel"]["median_ms"],
            "plain_ms": device_ms(lambda: K6.gather_region_grads_plain(
                a, fl, q, DY, DX, coord), 10),
            "library_ms": turns["grid_sampler_2d_backward"]["median_ms"],
            "library": "grid_sampler_2d_backward, grid gradient only; no "
                       "window", "turns": turns,
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3})
        r = grads_rows[-1]
        print(f"[flow train kernels] gather_region_grads {r['shape']} {tag}: "
              f"{r['ms']:.4f} ms on the device, {r['event_ms']:.4f} ms "
              f"between events (plain {r['plain_ms']:.3f} ms; "
              f"grid_sampler_2d_backward, grid gradient only, no window, "
              f"{r['library_ms']:.4f} ms; bound bytes "
              f"{r['bytes_bound_ms']:.4f} / fp32 {r['ops_bound_ms']:.4f} ms) "
              f"max abs err {r['max_abs_err']:.3e}")
        for n_, t in turns.items():
            print(f"[flow train kernels] gather_region_grads {tag} in turns: "
                  f"{_spread_line(n_, t)}")

    local_rows = _local_grads_kernels(dev, gen)

    inr_rows = []
    n = px
    pts = FT.pose_grid(torch.tensor([0.2], device=dev), FLOW_H,
                       FLOW_W).reshape(-1, 3).contiguous()
    # a smooth cotangent with a mean, as a loss gives (an iid zero-mean one
    # makes every gradient a sum that cancels, which measures rounding noise)
    mix = torch.randn((3, 4), generator=gen, device=dev)
    g = (1e-3 * (0.5 + torch.sin(2.0 * math.pi * (pts @ mix)))).contiguous()
    for net, kind in (("RBF", "rbf"), ("FFN", "ff")):
        cfg = FlowConfig(net=net, device="cuda")
        spec, params, consts = build_inr(
            R.named_fold(R.root_generator(8), "init"), net, cfg, dev)
        layers = [(l["w"], l["b"]) for l in params["mlp"]]
        widths = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
        check(widths == [512, 256, 256, 256, 4], f"{net} widths {widths}")
        mask = torch.ones(widths[0], device=dev)
        enc = consts["enc"]
        with torch.inference_mode():
            got = K7.fused_inr_backward(kind, enc, layers, pts, mask, g)
            again = K7.fused_inr_backward(kind, enc, layers, pts, mask, g)
            ref = K7.fused_inr_backward_plain(kind, enc, layers, pts, mask, g)
            torch.cuda.synchronize()
            same = all(torch.equal(a_, b_) for pa, pb in zip(got, again)
                       for a_, b_ in zip(pa, pb))
            check(same, f"K7 backward ({net}): two launches differ")
            err = 0.0
            for l, (pg, pr) in enumerate(zip(got, ref)):
                for name, a_, r_ in zip(("dW", "db"), pg, pr):
                    e = (a_ - r_).abs().max().item()
                    lim = 1e-3 * r_.abs().max().item()
                    check(math.isfinite(e) and e <= lim,
                          f"K7 backward ({net}) {name}_{l}: max abs err "
                          f"{e:.3e} exceeds 1e-3 max|plain| = {lim:.3e}")
                    err = max(err, e)
            got16 = K7.fused_inr_backward(kind, enc, layers, pts, mask, g,
                                          bf16=True)
            ref16 = K7.fused_inr_backward_plain(kind, enc, layers, pts, mask,
                                                g, bf16=True)
            # against fp32: two bf16 roundings per product and the relu
            # gates they flip
            rel16, lim16 = 0.0, 2e-2
            for l, (pg, pr, pb) in enumerate(zip(got16, ref, ref16)):
                for name, a_, r_, b_ in zip(("dW", "db"), pg, pr, pb):
                    rel = ((a_ - r_).norm() / r_.norm()).item()
                    check(math.isfinite(rel) and rel <= lim16,
                          f"K7 backward bf16 ({net}) {name}_{l}: normwise "
                          f"error {rel:.3e} against the fp32 plain result "
                          f"exceeds {lim16}")
                    rel16 = max(rel16, rel)
                    e = (a_ - b_).abs().max().item()
                    lim = 1e-3 * b_.abs().max().item()
                    check(e <= lim, f"K7 backward bf16 ({net}) {name}_{l}: "
                          f"max abs err {e:.3e} against the bf16 plain "
                          f"version exceeds {lim:.3e}")
            flops, nbytes = inr_backward_cost(n, widths)
            # the kernel and its plain version in turns: 200 each for the
            # path's net, 20 for the other
            turns = interleaved_event_ms({
                "kernel": lambda: K7.fused_inr_backward(
                    kind, enc, layers, pts, mask, g),
                "plain": lambda: K7.fused_inr_backward_plain(
                    kind, enc, layers, pts, mask, g)},
                200 if net == "RBF" else 20)
            row = {
                "shape": [n, 3], "net": net, "widths": widths,
                "max_abs_err": err, "bf16_normwise_err": rel16,
                "ms": turns["kernel"]["median_ms"],
                "bf16_ms": median_ms(lambda: K7.fused_inr_backward(
                    kind, enc, layers, pts, mask, g, bf16=True), 3),
                "plain_ms": turns["plain"]["median_ms"], "turns": turns,
                "library_ms": None, "bytes": nbytes, "flop": flops,
                "scratch_bytes": K7.scratch_bytes(layers, pts, kind, enc),
                **inr_backward_bounds(flops, nbytes)}
        inr_rows.append(row)
        print(f"[flow train kernels] fused_inr_backward {net} N={n}: "
              f"{row['ms']:.3f} ms with its reduction (bf16 operands "
              f"{row['bf16_ms']:.3f} ms; plain {row['plain_ms']:.3f} ms; "
              f"bound 3xTF32 {row['ops_bound_ms']:.3f} / fp32 "
              f"{row['fp32_bound_ms']:.3f} / bytes "
              f"{row['bytes_bound_ms']:.4f} ms; {flops / 1e9:.1f} GFLOP, "
              f"{3 * flops / row['ms'] / 1e9:.2f} TFLOP/s of TF32 work), "
              f"scratch {row['scratch_bytes'] / 2 ** 20:.1f} MiB, max abs err "
              f"{err:.3e}, bf16 normwise {rel16:.3e}, two launches bitwise "
              f"equal")
        for n_, t in turns.items():
            print(f"[flow train kernels] fused_inr_backward {net} in turns: "
                  f"{_spread_line(n_, t)}")

    # widths the kernel cannot take (a 32-row tile of 512 + 3 x 512 + 4
    # floats exceeds a block's shared memory): the model refuses on the card
    from sin_inn_tpu_torch.models.inr import inr_apply
    wide = FlowConfig(hidden_dim=512, device="cuda")
    spec, params, consts = build_inr(
        R.named_fold(R.root_generator(8), "init"), "RBF", wide, dev)
    for l in params["mlp"]:
        l["w"].requires_grad_(), l["b"].requires_grad_()
    before = K7.launch_counts()
    try:
        inr_apply(spec, params, consts, pts[:64])
    except ValueError as e:
        check("use-kernel off" in str(e), f"K7 refusal does not name the "
                                          f"way out: {e}")
    else:
        raise SmokeFailure("K7: a net with hidden 512 was not refused on "
                           "the card")
    check(K7.launch_counts() == before, "K7: the refused net launched")
    off = dataclasses.replace(spec, use_kernel="off")
    inr_apply(off, params, consts, pts[:64]).sum().backward()
    check(all(l["w"].grad is not None for l in params["mlp"]),
          "use_kernel='off' gave no gradient for the wide net")
    print("[flow train kernels] hidden 512 refused with use_kernel='auto', "
          "trained through autograd with use_kernel='off'")
    return {"gather_region_grads": grads_rows, "fused_inr_backward": inr_rows,
            "gather_region_local_grads": local_rows}


def _local_grads_kernels(dev, gen):
    """K6 local grads against its plain version at 1 x 436 x 1024, C = 3
    with resample coordinates (the warp's backward) and C = 5 raw (the
    splat's backward), local dy 32, dx 128, on phase 6's local flow."""
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

    fl = _local_flow(torch.Generator(device=dev).manual_seed(11), dev)
    off = tile_flow_offsets(fl, 128, 128, CAPY, 0).off_src
    px = FLOW_H * FLOW_W
    rows = []
    for c, coord, tag in ((3, K6.resample_coord(FLOW_H, FLOW_W), "resample"),
                          (5, K6.RAW, "raw")):
        a = torch.rand((1, FLOW_H, FLOW_W, c), generator=gen, device=dev)
        q = torch.randn((1, FLOW_H, FLOW_W, c), generator=gen, device=dev)
        got = K6.gather_region_local_grads(a, fl, q, off, LDY, DX, coord)
        ref = K6.gather_region_grads_plain(a, fl, q, LDY, DX, coord,
                                           off_src=off)
        torch.cuda.synchronize()
        err = max(_close(g_, r_, f"gather_region_local_grads C={c} {tag}, "
                                 f"{name}")
                  for name, g_, r_ in zip(("out", "dfx", "dfy"), got, ref))
        check(bool(got[1].any()), "K6 local grads: no flow derivative")
        nbytes = px * (3 * c + 2 + 2) * 4 + off.numel() * 4
        flops = px * (24 + 24 * c)
        kern = lambda: K6.gather_region_local_grads(a, fl, q, off, LDY, DX,
                                                    coord)
        turns = interleaved_device_ms(
            {"kernel": kern, "grid_sampler_2d_backward": _grid_grad_call(
                a, fl, q)}, 200)
        rows.append({
            "shape": [1, FLOW_H, FLOW_W, c], "coord": tag,
            "max_abs_err": err, "ms": turns["kernel"]["median_ms"],
            "plain_ms": device_ms(lambda: K6.gather_region_grads_plain(
                a, fl, q, LDY, DX, coord, off_src=off), 10),
            "library_ms": turns["grid_sampler_2d_backward"]["median_ms"],
            "library": "grid_sampler_2d_backward, grid gradient only; no "
                       "window", "turns": turns,
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3})
        r = rows[-1]
        print(f"[flow train kernels] gather_region_local_grads {r['shape']} "
              f"{tag}: {r['ms']:.4f} ms on the device, {r['event_ms']:.4f} ms "
              f"between events (plain {r['plain_ms']:.3f} ms; "
              f"grid_sampler_2d_backward, grid gradient only, no window, "
              f"{r['library_ms']:.4f} ms; bound bytes "
              f"{r['bytes_bound_ms']:.4f} / fp32 {r['ops_bound_ms']:.4f} ms) "
              f"max abs err {r['max_abs_err']:.3e}")
        for n_, t in turns.items():
            print(f"[flow train kernels] gather_region_local_grads {tag} in "
                  f"turns: {_spread_line(n_, t)}")
    return rows


def _grid_grad_call(a, fl, q):
    """The closest single PyTorch call to K6 grads: the backward of
    ``grid_sample`` (bilinear, zero padding) at the pixels moved by the
    flow, with the payload as the output's gradient, asking for the grid
    gradient only (``output_mask`` [False, True]): one kernel, and no
    window."""
    _, h, w, _ = a.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, device=a.device, dtype=torch.float32),
        torch.arange(w, device=a.device, dtype=torch.float32), indexing="ij")
    grid = torch.stack([(xs + fl[0, ..., 0]) / (w - 1) * 2 - 1,
                        (ys + fl[0, ..., 1]) / (h - 1) * 2 - 1],
                       -1)[None].contiguous()
    inp = a.permute(0, 3, 1, 2).contiguous()
    gout = q.permute(0, 3, 1, 2).contiguous()
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, inp, grid, 0, 0, False, [False, True])


def _op_trace(fn):
    """The aten ops ``fn`` runs (its backward too), each with a checksum
    of the bits of its floating outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    views = {4: torch.int32, 2: torch.int16}
    trace = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if "empty" not in name:    # uninitialised outputs
                sums = [t.detach().contiguous().view(
                            views[t.element_size()]).sum(dtype=torch.int64)
                        for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor) and t.numel()
                        and t.is_floating_point()
                        and t.element_size() in views]
                trace.append((name, sums))
            return out

    with Record():
        fn()
    return [(name, [int(v) for v in sums]) for name, sums in trace]


def _first_differing_op(fn) -> str:
    """The first op whose outputs differ between two runs of ``fn``."""
    a, b = _op_trace(fn), _op_trace(fn)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"op {i} of {len(a)}: {x[0]} (other run: {y[0]})"
    return f"none of {len(a)} ops (the kernels' own writes differ)"


def _leaf_norm_err(got, ref) -> float:
    return max(((a - b).norm() / b.norm()).item() for a, b in zip(got, ref))


def phase_flow_train(dev, card: str, smi_line: str):
    """``flow train`` at Sintel size through ``run_flow_train``: counts,
    resume, the kernel route's gradients against autograd's, rates and peak
    memory of both routes, then ``flow test`` on the trained checkpoint."""
    import os

    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inr import flat_leaves
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train import loop as LP

    stats = {}
    pairs = FLOW_FRAMES - 1
    with tempfile.TemporaryDirectory() as work:
        cfg = FlowConfig(device="cuda", checkpoints_dir=work + "/ck",
                         results_dir=work + "/results", name="smoke",
                         epochs=FLOW_TRAIN_EPOCHS)
        check(cfg.net == "RBF" and cfg.batch == 1 and cfg.occl == "wang"
              and cfg.use_kernel == "auto" and cfg.lr == 1e-4
              and cfg.compute_dtype == "float32",
              "FlowConfig defaults are not the Sintel RBF training config")
        media = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                               seed=1))
        scene = "chip_smoke"
        steps = FLOW_TRAIN_EPOCHS * pairs
        _reset_all_counts()
        t0 = time.perf_counter()
        out = LP.run_flow_train(cfg, media=media, scene=scene)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _all_counts()
        check_counts(counts, f"flow train, {steps} steps on the local windows",
                     splat_region_local=2 * steps,
                     gather_region_local=2 * steps,
                     gather_region_local_grads=4 * steps,
                     fused_inr_backward=steps, reduce_weight_grads=steps)
        keys = FlowConfig.WINDOW_BOUND_KEYS
        bounds = lambda c: tuple(getattr(c, k) for k in keys)
        res = cfg.resolve_splat_bounds(FLOW_H, FLOW_W)
        check(bounds(res) == (DY, DX, LDY, None),
              f"the defaults resolved to {bounds(res)}")
        # the refit at the second save tightens the 'auto' bounds to the
        # seeded net's few-px flows (after the last step of the run)
        eff = out["cfg"]
        check(bounds(eff) != bounds(res), f"the window refit did not fire: "
                                          f"{bounds(eff)}")
        check(out["state"].step == steps and out["start_epoch"] == 0,
              f"flow train: step {out['state'].step}")
        check(all(math.isfinite(v) for v in out["metrics"].values()),
              f"flow train metrics {out['metrics']}")
        ck = LP.flow_ckpt_dir(cfg, scene)
        with open(os.path.join(ck, "window_bounds.json")) as f:
            side = json.load(f)
        hist = side.pop("hist")
        check(side == {"fh": FLOW_H, "fw": FLOW_W, **dict(zip(keys,
                                                              bounds(eff)))}
              and set(hist) == {"fy", "fx", "dvy", "dvx"},
              f"sidecar {side}, hist {hist}")
        stats["refit"] = {"from": bounds(res), "to": bounds(eff),
                          "hist": hist}
        check(os.path.getsize(os.path.join(
            ck, f"{scene}_{cfg.name}.metrics.jsonl")) > 0, "no metrics file")
        saved, at = CheckpointStore(ck).restore(map_location=dev)
        check(at == FLOW_TRAIN_EPOCHS and set(saved) == {"params", "consts",
                                                         "opt", "step"}
              and saved["step"] == steps, f"checkpoint {at} {set(saved)}")
        print(f"[flow train] {steps} steps over {pairs} pairs in {run_s:.2f} "
              f"s with set-up; loss {out['metrics']['loss']:.5f}, psnr "
              f"{out['metrics']['psnr']:.2f} dB, max |flow| "
              f"{out['metrics']['flow_max_x']:.2f} / "
              f"{out['metrics']['flow_max_y']:.2f} px, deviation "
              f"{out['metrics']['flow_dev_x']:.2f} / "
              f"{out['metrics']['flow_dev_y']:.2f} px; launches {counts}; "
              f"window refit (dy, dx, local dy, local dx) {bounds(res)} -> "
              f"{bounds(eff)} from {hist}")

        # resume: one more epoch from the checkpoint, optimizer state kept,
        # on the refitted bounds of the sidecar
        _reset_all_counts()
        out2 = LP.run_flow_train(cfg.replace(epochs=FLOW_TRAIN_EPOCHS + 1),
                                 media=media, scene=scene)
        resume_counts = _all_counts()
        if eff.splat_local_dy:
            want = dict(splat_region_local=2 * pairs,
                        gather_region_local=2 * pairs,
                        gather_region_local_grads=4 * pairs)
        else:
            want = dict(splat_region=2 * pairs, gather_region=2 * pairs,
                        gather_region_grads=4 * pairs)
        check_counts(resume_counts, "the resumed epoch, on the refitted "
                                    "windows", fused_inr_backward=pairs,
                     reduce_weight_grads=pairs, **want)
        add_counts(counts, resume_counts)
        st = out2["state"]
        opt_steps = {s["step"] for s in st.optimizer.state.values()}
        check(out2["start_epoch"] == FLOW_TRAIN_EPOCHS
              and st.step == steps + pairs and opt_steps == {steps + pairs}
              and bounds(out2["cfg"]) == bounds(eff),
              f"resume: from epoch {out2['start_epoch']}, step {st.step}, "
              f"optimizer steps {opt_steps}, bounds {bounds(out2['cfg'])}")
        print(f"[flow train] resumed at epoch {out2['start_epoch']} to step "
              f"{st.step} with the optimizer state, on the bounds "
              f"{bounds(out2['cfg'])}; launches {resume_counts}")

        # one step at the resolved defaults (local windows): its launches,
        # and its gradients against use_kernel="off" (autograd through the
        # plain INR and the windowed forms)
        spec, consts = out2["spec"], out2["consts"]
        spec_off = dataclasses.replace(spec, use_kernel="off")
        res_off = res.replace(use_kernel="off")
        batch = LP._to_device_batch(media.sample(np.arange(2, 3)), dev)
        leaves = [t for _, t in flat_leaves(st.params)]

        def grads_of(sp, c):
            """(loss, gradients, GiB the graph holds for the backward)."""
            for t in leaves:
                t.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            loss, _ = FT.flow_loss(sp, c, st.params, consts, batch)
            held = (torch.cuda.memory_allocated(dev) - base) / 2 ** 30
            loss.backward()
            torch.cuda.synchronize()
            return loss.item(), [t.grad.clone() for t in leaves], held

        _reset_all_counts()
        loss_k, g_k, held_k = grads_of(spec, res)
        step_counts = _all_counts()
        check_counts(step_counts, "one flow train step", splat_region_local=2,
                     gather_region_local=2, gather_region_local_grads=4,
                     fused_inr_backward=1, reduce_weight_grads=1)
        # the same step again from the same state: with K5's fixed-point
        # sums every launch of the step is repeatable, and so is the step
        loss_k2, g_k2, _ = grads_of(spec, res)
        same = loss_k2 == loss_k and all(torch.equal(a, b)
                                         for a, b in zip(g_k, g_k2))
        if not same:
            first = _first_differing_op(lambda: grads_of(spec, res))
        check(same, f"two flow train steps from the same state differ; the "
                    f"first op whose output differs: {first if not same else ''}")
        print("[flow train] one step twice from the same state: loss and "
              "gradients bitwise equal")
        _reset_all_counts()
        loss_a, g_a, held_a = grads_of(spec_off, res_off)
        off_counts = _all_counts()
        check_counts(off_counts, "one step with use_kernel='off' (the "
                                 "windowed forms)")
        gerr = _leaf_norm_err(g_k, g_a)
        check(gerr <= 1e-3 and abs(loss_k - loss_a) <= 1e-5 * abs(loss_a),
              f"kernel route against autograd: gradients normwise {gerr:.3e} "
              f"(limit 1e-3), loss {loss_k} / {loss_a}")
        # the fused route keeps no (N, 512) encoding and no (N, 256)
        # activation between its forward and its backward
        stash = FLOW_H * FLOW_W * 512 * 4 / 2 ** 30
        check(held_a - held_k >= stash,
              f"held for the backward: kernel route {held_k:.2f} GiB, "
              f"autograd route {held_a:.2f} GiB: the difference is under "
              f"one (N, 512) fp32 tensor ({stash:.2f} GiB)")
        stats["grad_err"] = gerr
        stats["step_counts"] = step_counts
        stats["held_gib"] = {"kernel": held_k, "off": held_a}
        print(f"[flow train] one step: launches {step_counts}; gradients "
              f"against use_kernel='off' normwise {gerr:.3e}, loss "
              f"{loss_k:.6f} / {loss_a:.6f}; held between forward and "
              f"backward {held_k:.2f} GiB (kernel route) / {held_a:.2f} GiB "
              f"(use_kernel='off')")
        for t in leaves:
            t.grad = None

        # one whole step (offsets, monitors, LAMB) with the host forbidden
        # to wait for the card
        step = FT.make_flow_train_step(spec, res)
        step(st, consts, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = step(st, consts, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(bool(torch.isfinite(m["loss"])) and "flow_dev_y" in m,
              f"the step under set_sync_debug_mode: {sorted(m)}")
        print("[flow train] one local-window step with "
              "set_sync_debug_mode('error'): nothing waits for the card")

        # rates and peak memory of both routes, each on a fresh state
        cached = [LP._to_device_batch(b, dev) for b in media.batches(1)]
        for tag, sp, c in (("kernel", spec, res),
                           ("static", spec, res.replace(splat_local_dy=None)),
                           ("off", spec_off, res_off)):
            gen = R.named_fold(R.root_generator(cfg.random_seed), "init")
            _, state, cs = FT.create_flow_state(gen, cfg)
            step = FT.make_flow_train_step(sp, c)
            for i in range(2):
                step(state, cs, cached[i])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            events = []
            t0 = time.perf_counter()
            for i in range(10):
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
                m = step(state, cs, cached[i % pairs])
                b.record()
                events.append((a, b))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(m["loss"])), f"{tag} route: loss")
            stats[tag] = {
                "pairs_per_sec": 10 / wall,
                "step_ms": statistics.median(a.elapsed_time(b)
                                             for a, b in events),
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
            r = stats[tag]
            route = {"kernel": "use_kernel=auto, local windows",
                     "static": "use_kernel=auto, static windows",
                     "off": "use_kernel=off"}[tag]
            print(f"[flow train] {route}"
                  f": {r['pairs_per_sec']:.2f} pairs/s, {r['step_ms']:.2f} "
                  f"ms/step (batch 1, {FLOW_H}x{FLOW_W}, RBF, float32), peak "
                  f"device memory {r['peak_gib']:.2f} GiB, on {card} "
                  f"({smi_line})")
            del state, step

        # flow test serves the trained checkpoint: no kernel at all
        init = R.named_fold(R.root_generator(cfg.random_seed + 1), "init")
        spec_r, rp, rc, _, at, _, _ = LP._flow_create_and_restore(
            cfg, init, scene, require="checkpoint missing")
        check(at == FLOW_TRAIN_EPOCHS + 1, f"restored checkpoint {at}")
        _reset_all_counts()
        served = LP.flow_test_outputs(cfg, media, spec_r, rp, rc)
        check_counts(_all_counts(), "flow test on the trained checkpoint")
        check(served["flow12"].shape == (pairs, FLOW_H, FLOW_W, 2)
              and bool(np.isfinite(served["flow12"]).all()),
              "flow test on the trained checkpoint: flows")
        print(f"[flow train] flow test on the trained checkpoint: "
              f"{pairs} pairs, |flow| max "
              f"{np.abs(served['flow12']).max():.2f} px, no kernel launch")
    return counts, stats


def inr_forward_cost(n: int, widths, d: int, mode: str, wx=None):
    """FLOP and bytes of one K7 forward launch for a progressive MLP of
    ``widths`` = [E, H, ..., H, O] (+ d coordinate rows into the first
    layer) over n points: 2 FLOP per multiply-add of every layer, and in
    slab mode the mask rebuild of this run's wx (one multiply-add per
    non-zero weight and mask channel); x read once, out written once, each
    weight and bias read once, the mask's operands read once."""
    mats = [a * b for a, b in zip(widths[:-1], widths[1:])]
    flops = 2 * n * (sum(mats) + d * widths[1])
    params = sum(mats) + d * widths[1] + sum(widths[1:])
    nbytes = 4 * (n * (3 + widths[-1]) + params)
    e = widths[0]
    if mode == "slab":
        w, res = wx.shape
        nnz = int((wx != 0).sum().item())
        flops += 2 * (n // w) * nnz * (e + d)
        nbytes += 4 * ((n // w) * res * (e + d) + w * res)
    elif mode == "point":
        nbytes += 4 * n * (e + d)
    else:
        nbytes += 4 * (e + d)
    return flops, nbytes


def _spatial_masks(spec, dev, seed: int):
    """A seeded spatial-controller state that is not the initial one, and
    its mask for the 436x1024 pose grid at t = 0.2 as a vector (a cell's
    row), row slabs and the split pair."""
    from sin_inn_tpu_torch.models import controllers as C

    ccfg = C.SpatialConfig.create(spec, 50, block_iterations=8)
    check(ccfg.cells == 125000 and ccfg.k == 5, f"cell grid {ccfg}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = C.spatial_init(ccfg, dev)._replace(
        mask=torch.rand((ccfg.cells, ccfg.encoding_dim), generator=gen,
                        device=dev))
    times = torch.tensor([0.2], device=dev)
    slabs = C.spatial_grid_mask_slabs(ccfg, state, times, FLOW_H, FLOW_W)
    split = C.spatial_grid_mask_split(ccfg, state, times, FLOW_H, FLOW_W)
    check(tuple(slabs.enc.shape) == (FLOW_H, 50, 512)
          and tuple(slabs.wx.shape) == (FLOW_W, 50)
          and tuple(split[1].shape) == (FLOW_H * FLOW_W, 512),
          "mask operand shapes")
    return {"const": state.mask[777].clone(), "slab": slabs, "point": split}


def phase_prog_kernels(dev):
    """K7 forward in every mode and K7 backward in the new ones against
    their plain versions at the progressive path's shapes."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.models.inr import build_inr
    from sin_inn_tpu_torch.ops.cuda import inr as K7
    from sin_inn_tpu_torch.train import flow as FT

    n = FLOW_H * FLOW_W
    pts = FT.pose_grid(torch.tensor([0.2], device=dev), FLOW_H,
                       FLOW_W).reshape(-1, 3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(10)
    mix = torch.randn((3, 4), generator=gen, device=dev)
    g = (1e-3 * (0.5 + torch.sin(2.0 * math.pi * (pts @ mix)))).contiguous()
    fwd_rows, bwd_rows = [], []

    def close(got, ref, what):
        e = (got - ref).abs()
        check(bool(torch.isfinite(e).all()), f"{what}: non-finite")
        check(bool((e <= 1e-4 + 1e-4 * ref.abs()).all()),
              f"{what}: max abs err {e.max().item():.3e} exceeds "
              "1e-4 + 1e-4|plain|")
        return e.max().item()

    def forward_row(net, kind, enc, layers, widths, mode, mask, d_prog):
        with torch.inference_mode():
            out = K7.fused_inr_forward(kind, enc, layers, pts, mask)
            twice = K7.fused_inr_forward(kind, enc, layers, pts, mask)
            ref = K7.fused_inr_forward_plain(kind, enc, layers, pts, mask)
            out16 = K7.fused_inr_forward(kind, enc, layers, pts, mask,
                                         bf16=True)
            twice16 = K7.fused_inr_forward(kind, enc, layers, pts, mask,
                                           bf16=True)
            ref16 = K7.fused_inr_forward_plain(kind, enc, layers, pts, mask,
                                               bf16=True)
            torch.cuda.synchronize()
            check(out.shape == (n, 4), f"K7 forward output {out.shape}")
            check(torch.equal(out, twice) and torch.equal(out16, twice16),
                  f"K7 forward ({net}, {mode}): two launches differ")
            err = close(out, ref, f"K7 forward ({net}, {mode})")
            # 3xTF32 keeps fp32's accuracy: normwise a few 1e-7 from the
            # plain version, where one-pass TF32 gives about 1e-4
            rel = ((out - ref).norm() / ref.norm()).item()
            check(rel <= 1e-5, f"K7 forward ({net}, {mode}): normwise "
                               f"{rel:.3e} against the plain version exceeds "
                               "1e-5")
            # bf16 operands: a pre-activation at a bf16 tie may round
            # either way under the two sums' orders and carries a bf16 step
            # (2^-8 of it) to the output, so the elementwise limit is
            # reported, and the bf16 gates are normwise
            e16 = (out16 - ref16).abs()
            over16 = (e16 > 1e-4 + 1e-4 * ref16.abs()).any(1).float().mean()
            rel16 = ((out16 - ref16).norm() / ref16.norm()).item()
            rel32 = ((out16 - ref).norm() / ref.norm()).item()
            check(bool(torch.isfinite(out16).all()) and rel16 <= 5e-3
                  and rel32 <= 2e-2,
                  f"K7 forward bf16 ({net}, {mode}): normwise {rel16:.3e} "
                  f"against the bf16 plain version (limit 5e-3), {rel32:.3e} "
                  "against the fp32 one (limit 2e-2)")
            flops, nbytes = inr_forward_cost(
                n, widths, d_prog, mode,
                mask.wx if mode == "slab" else None)
            # the kernel (both operand modes) and its plain version in
            # turns: 20 each for the path's mode (PFF, slab), 5 for others
            turns = interleaved_event_ms({
                "kernel": lambda: K7.fused_inr_forward(
                    kind, enc, layers, pts, mask),
                "kernel_bf16": lambda: K7.fused_inr_forward(
                    kind, enc, layers, pts, mask, bf16=True),
                "plain": lambda: K7.fused_inr_forward_plain(
                    kind, enc, layers, pts, mask)},
                20 if (net, mode) == ("PFF", "slab") else 5)
            row = {
                "shape": [n, 3], "net": net, "mode": mode,
                "prog": bool(d_prog), "widths": widths, "max_abs_err": err,
                "normwise_err": rel, "bitwise_repeatable": True,
                "bf16_max_abs_err": e16.max().item(),
                "bf16_points_over_1e-4": over16.item(),
                "bf16_normwise_err": rel16, "bf16_vs_fp32_normwise": rel32,
                "ms": turns["kernel"]["median_ms"],
                "bf16_ms": turns["kernel_bf16"]["median_ms"],
                "plain_ms": turns["plain"]["median_ms"], "turns": turns,
                "library_ms": None, "bytes": nbytes, "flop": flops,
                "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
                # its products as it runs them: three TF32 products each
                # (3xTF32), one with bf16 operands; the fp32 rate beside
                "ops_bound_ms": 3 * flops / PEAK_TF32 * 1e3,
                "bf16_ops_bound_ms": flops / PEAK_TF32 * 1e3,
                "fp32_bound_ms": flops / PEAK_FP32 * 1e3}
        fwd_rows.append(row)
        print(f"[prog kernels] fused_inr_forward {net} {mode}"
              f"{'' if d_prog else ' (not progressive)'} N={n}: "
              f"{row['ms']:.3f} ms (bf16 operands {row['bf16_ms']:.3f} ms; "
              f"plain {row['plain_ms']:.3f} ms; bound 3xTF32 "
              f"{row['ops_bound_ms']:.3f} / fp32 {row['fp32_bound_ms']:.3f} "
              f"/ bf16 {row['bf16_ops_bound_ms']:.3f} / bytes "
              f"{row['bytes_bound_ms']:.4f} ms; {flops / 1e9:.1f} GFLOP, "
              f"{3 * flops / row['ms'] / 1e9:.2f} TFLOP/s of TF32 work), max "
              f"abs err {err:.3e}, normwise {rel:.3e}; bf16: max abs err "
              f"{row['bf16_max_abs_err']:.3e}, points over 1e-4 + "
              f"1e-4|plain| {100 * row['bf16_points_over_1e-4']:.3f}%, "
              f"normwise {rel16:.3e} (bf16 plain) / {rel32:.3e} (fp32 "
              f"plain); two launches bitwise equal; in turns: "
              + ", ".join(_spread_line(k, t) for k, t in turns.items()))
        return out

    def backward_row(net, kind, enc, layers, widths, mode, mask):
        with torch.inference_mode():
            got = K7.fused_inr_backward(kind, enc, layers, pts, mask, g)
            again = K7.fused_inr_backward(kind, enc, layers, pts, mask, g)
            ref = K7.fused_inr_backward_plain(kind, enc, layers, pts, mask, g)
            torch.cuda.synchronize()
            check(all(torch.equal(a_, b_) for pa, pb in zip(got, again)
                      for a_, b_ in zip(pa, pb)),
                  f"K7 backward ({net}, {mode}): two launches differ")
            err = 0.0
            for l, (pg, pr) in enumerate(zip(got, ref)):
                for name, a_, r_ in zip(("dW", "db"), pg, pr):
                    e = (a_ - r_).abs().max().item()
                    lim = 1e-3 * r_.abs().max().item()
                    check(a_.shape == r_.shape and math.isfinite(e)
                          and e <= lim,
                          f"K7 backward ({net}, {mode}) {name}_{l}: max abs "
                          f"err {e:.3e} exceeds 1e-3 max|plain| = {lim:.3e}")
                    err = max(err, e)
            # the coordinate rows' own gradient, the first three of dW_0
            e = (got[0][0][:3] - ref[0][0][:3]).abs().max().item()
            lim = 1e-3 * ref[0][0][:3].abs().max().item()
            check(got[0][0].shape[0] == 515 and 0 < lim and e <= lim,
                  f"K7 backward ({net}, {mode}) dwc: max abs err {e:.3e} "
                  f"exceeds {lim:.3e}")
            # on top of the constant-mask count of a non-progressive net:
            # the coordinate rows' product in the recompute and their
            # gradient, the mask rebuild, and the bytes of wc, dwc and the
            # mask's operands
            flops, nbytes = inr_backward_cost(n, widths)
            wx = mask.wx if mode == "slab" else None
            fwd_flops, fwd_bytes = inr_forward_cost(n, widths, 3, mode, wx)
            const_flops, const_bytes = inr_forward_cost(n, widths, 3, "const")
            flops += 4 * n * 3 * widths[1] + fwd_flops - const_flops
            nbytes += 8 * 3 * widths[1] + fwd_bytes - const_bytes
            # the kernel and its plain version in turns: 50 each for the
            # path's mode (PFF, slab), 10 for the others
            turns = interleaved_event_ms({
                "kernel": lambda: K7.fused_inr_backward(
                    kind, enc, layers, pts, mask, g),
                "plain": lambda: K7.fused_inr_backward_plain(
                    kind, enc, layers, pts, mask, g)},
                50 if (net, mode) == ("PFF", "slab") else 10)
            row = {
                "shape": [n, 3], "net": net, "mode": mode, "prog": True,
                "widths": widths, "max_abs_err": err,
                "ms": turns["kernel"]["median_ms"],
                "bf16_ms": median_ms(lambda: K7.fused_inr_backward(
                    kind, enc, layers, pts, mask, g, bf16=True), 3),
                "plain_ms": turns["plain"]["median_ms"], "turns": turns,
                "library_ms": None, "bytes": nbytes, "flop": flops,
                "scratch_bytes": K7.scratch_bytes(layers, pts, kind, enc,
                                                  mask),
                **inr_backward_bounds(flops, nbytes)}
        bwd_rows.append(row)
        print(f"[prog kernels] fused_inr_backward {net} {mode} N={n}: "
              f"{row['ms']:.3f} ms with its reduction (bf16 operands "
              f"{row['bf16_ms']:.3f} ms; plain {row['plain_ms']:.3f} ms; "
              f"bound 3xTF32 {row['ops_bound_ms']:.3f} / fp32 "
              f"{row['fp32_bound_ms']:.3f} / bytes "
              f"{row['bytes_bound_ms']:.4f} ms; {flops / 1e9:.1f} GFLOP, "
              f"{3 * flops / row['ms'] / 1e9:.2f} TFLOP/s of TF32 work), "
              f"scratch {row['scratch_bytes'] / 2 ** 20:.1f} MiB, max abs "
              f"err {err:.3e}, two launches bitwise equal; in turns: "
              f"{_spread_line('kernel', turns['kernel'])}, "
              f"{_spread_line('plain', turns['plain'])}")

    for net, kind, modes in (("PFF", "ff", ("slab", "point", "const")),
                             ("PRBF", "rbf", ("slab",))):
        cfg = FlowConfig(net=net, device="cuda")
        spec, params, consts = build_inr(
            R.named_fold(R.root_generator(10), "init"), net, cfg, dev)
        layers = [(l["w"], l["b"]) for l in params["mlp"]]
        widths = [512] + [w.shape[1] for w, _ in layers]
        check(spec.is_progressive and spec.encoding_dim == 515
              and [tuple(w.shape) for w, _ in layers] ==
              [(515, 256), (256, 256), (256, 256), (256, 4)],
              f"{net} is not mask length 515, MLP 515-256-256-256-4")
        enc = consts["enc"]
        masks = _spatial_masks(spec, dev, 11)
        outs = {}
        for mode in modes:
            outs[mode] = forward_row(net, kind, enc, layers, widths, mode,
                                     masks[mode], 3)
            backward_row(net, kind, enc, layers, widths, mode, masks[mode])
        if "point" in outs:
            # the same mask two ways: the rebuild sums its res terms in
            # another order than the producer's contraction
            close(outs["slab"], outs["point"],
                  f"K7 forward ({net}): slab against point mode")
        del masks, outs

    # the forward of a non-progressive net (constant mask, no coordinate rows)
    cfg = FlowConfig(net="RBF", device="cuda")
    spec, params, consts = build_inr(
        R.named_fold(R.root_generator(8), "init"), "RBF", cfg, dev)
    layers = [(l["w"], l["b"]) for l in params["mlp"]]
    forward_row("RBF", "rbf", consts["enc"], layers, [512, 256, 256, 256, 4],
                "const", torch.ones(512, device=dev), 0)
    return {"fused_inr_forward": fwd_rows, "fused_inr_backward": bwd_rows}


def phase_prog_path(dev, card: str, smi_line: str):
    """``flow train``, ``flow test`` and ``flow interpolate`` for ``PFF``
    under the spatial and the linear controller at Sintel size."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models import controllers as C
    from sin_inn_tpu_torch.models.inr import flat_leaves, tree_to
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train import loop as LP

    stats = {}
    pairs = FLOW_FRAMES - 1
    n = FLOW_H * FLOW_W
    with tempfile.TemporaryDirectory() as work:
        # the static windows (local dy off), so that one train path keeps
        # the static K5, K6 and K6 grads launches and their counts
        cfg = FlowConfig(net="PFF", spatially_adaptive=True, device="cuda",
                         checkpoints_dir=work + "/ck",
                         results_dir=work + "/results", name="pff_spatial",
                         epochs=FLOW_TRAIN_EPOCHS, splat_local_dy="off")
        check(cfg.spatial_res == 50 and cfg.controller_epsilon == 1e-3
              and cfg.batch == 1 and cfg.occl == "wang"
              and cfg.use_kernel == "auto" and cfg.compute_dtype == "float32",
              "FlowConfig defaults are not the Sintel PFF spatial config")
        media = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                               seed=1))
        scene = "chip_smoke"
        steps = FLOW_TRAIN_EPOCHS * pairs

        # the main path: run_flow_train, counts set to 0 just before it
        _reset_all_counts()
        t0 = time.perf_counter()
        out = LP.run_flow_train(cfg, media=media, scene=scene)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _all_counts()
        check_counts(counts, f"PFF spatial flow train, {steps} steps",
                     fused_inr_forward=steps, fused_inr_backward=steps,
                     reduce_weight_grads=steps, splat_region=2 * steps,
                     gather_region=2 * steps, gather_region_grads=4 * steps)
        st = out["state"]
        spec, consts, eff = out["spec"], out["consts"], out["cfg"]
        ccfg = st.ctrl_cfg
        check(spec.encoding_dim == 515 and isinstance(ccfg, C.SpatialConfig)
              and ccfg.cells == 125000 and ccfg.block_iterations == 1
              and isinstance(st.ctrl_state, C.SpatialState),
              f"controller {ccfg}")
        check(st.step == steps and all(math.isfinite(v)
                                       for v in out["metrics"].values()),
              f"PFF spatial flow train: step {st.step}, {out['metrics']}")
        # a block advance every step here: ten blocks of 6 channels opened
        # wherever a cell is in progress
        cs = st.ctrl_state
        first = C.spatial_init(ccfg, dev)
        check((cs.cur_block, cs.next_block, cs.iteration) ==
              (6 * (steps + 1), 6 * (steps + 2), 0),
              f"block pointers {cs.cur_block}, {cs.next_block}")
        opened = (cs.mask[:, 6:cs.cur_block] == 1.0).all(1)
        check(not torch.equal(cs.mask, first.mask)
              and bool((opened == cs.in_progress).all()
                       or cs.in_progress.all()),
              "the cell mask did not follow in_progress")
        saved, at = CheckpointStore(LP.flow_ckpt_dir(cfg, scene)).restore(
            map_location=dev)
        check(at == FLOW_TRAIN_EPOCHS and set(saved) == {
            "params", "consts", "opt", "step", "ctrl_state"}
            and saved["ctrl_state"]["kind"] == "spatial",
            f"checkpoint {at} {set(saved)}")
        print(f"[prog path] PFF --spatially-adaptive: {steps} steps in "
              f"{run_s:.2f} s with set-up; loss {out['metrics']['loss']:.5f}"
              f"; block pointer {cs.cur_block}, cells in progress "
              f"{cs.in_progress.float().mean().item():.3f}; launches "
              f"{counts}")

        # resume: one more epoch, the controller state from the checkpoint
        out2 = LP.run_flow_train(cfg.replace(epochs=FLOW_TRAIN_EPOCHS + 1),
                                 media=media, scene=scene)
        cs2 = out2["state"].ctrl_state
        check(out2["start_epoch"] == FLOW_TRAIN_EPOCHS
              and out2["state"].step == steps + pairs
              and cs2.cur_block == cs.cur_block + 6 * pairs,
              f"resume: from epoch {out2['start_epoch']}, step "
              f"{out2['state'].step}, block pointer {cs2.cur_block}")
        print(f"[prog path] resumed at epoch {out2['start_epoch']} with the "
              f"controller state: block pointer {cs.cur_block} -> "
              f"{cs2.cur_block}")
        st = out2["state"]

        # one transition of each controller with synchronisations forbidden;
        # the spatial one on a state with half its cells out of progress,
        # at the default schedule's block length, on a ramp step and on an
        # advance
        batch = LP._to_device_batch(media.sample(np.arange(2, 3)), dev)
        ccfg8 = dataclasses.replace(ccfg, block_iterations=8)
        half = torch.arange(ccfg.cells, device=dev) % 2 == 0
        loss, aux = FT.flow_loss(spec, eff, st.params, consts, batch, ccfg8,
                                 st.ctrl_state)
        lin_cfg = C.LinearConfig.create(spec, 1000, epsilon=1e-3)
        lin = C.linear_init(lin_cfg, dev)
        for it in (0, 7):
            probe = st.ctrl_state._replace(in_progress=half, iteration=it)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                after = FT.controller_step(ccfg8, probe, aux, batch)
                lin = FT.controller_step(lin_cfg, lin, aux, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            # cells out of progress keep their rows; the others ramp (to
            # 0.25 at iteration 1) or, at the advance, open the block where
            # the gate left them in progress (cells far from this pair's
            # time saw no loss in this block and leave)
            win = slice(probe.cur_block, probe.next_block)
            live = after.in_progress
            check(torch.equal(after.mask[~half], probe.mask[~half])
                  and bool(live.any()) and not bool(live[~half].any())
                  and bool((after.mask[live][:, win] >= 0.25).all())
                  and (it == 0 or torch.equal(after.mask[half & ~live],
                                              probe.mask[half & ~live])),
                  f"transition at iteration {it}: in_progress not followed")
            check(after.iteration == (it + 1) % 8 and after.cur_block ==
                  (probe.next_block if it == 7 else probe.cur_block),
                  f"transition at iteration {it}: counters")
        check(lin.iteration == 2 and bool(lin.mask[6:12].gt(0).all()),
              "linear transition")
        print("[prog path] one ramp step and one block advance of the "
              "spatial controller (half the cells out of progress: their "
              "rows stay) and two steps of the linear one with "
              "set_sync_debug_mode('error'): nothing waits for the card")
        del loss, aux, probe, after

        # one step's launches, and its gradients against the dense route
        spec_off = dataclasses.replace(spec, use_kernel="off")
        leaves = [t for _, t in flat_leaves(st.params)]

        def grads_of(sp):
            for t in leaves:
                t.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            loss, _ = FT.flow_loss(sp, eff, st.params, consts, batch, ccfg,
                                   st.ctrl_state)
            held = (torch.cuda.memory_allocated(dev) - base) / 2 ** 30
            loss.backward()
            torch.cuda.synchronize()
            return loss.item(), [t.grad.clone() for t in leaves], held

        _reset_all_counts()
        loss_k, g_k, held_k = grads_of(spec)
        step_counts = _all_counts()
        check_counts(step_counts, "one PFF spatial train step",
                     fused_inr_forward=1, fused_inr_backward=1,
                     reduce_weight_grads=1, splat_region=2, gather_region=2,
                     gather_region_grads=4)
        _reset_all_counts()
        loss_a, g_a, held_a = grads_of(spec_off)
        check_counts(_all_counts(), "one PFF spatial step, use_kernel='off'",
                     splat_region=2, gather_region=2, gather_region_grads=4)
        gerr = _leaf_norm_err(g_k, g_a)
        check(gerr <= 1e-3 and abs(loss_k - loss_a) <= 1e-5 * abs(loss_a),
              f"PFF spatial kernel route against the dense route: gradients "
              f"normwise {gerr:.3e} (limit 1e-3), loss {loss_k} / {loss_a}")
        stats.update(grad_err=gerr, step_counts=step_counts,
                     held_gib={"kernel": held_k, "off": held_a})
        print(f"[prog path] one step: launches {step_counts}; gradients "
              f"against use_kernel='off' normwise {gerr:.3e}, loss "
              f"{loss_k:.6f} / {loss_a:.6f}; held between forward and "
              f"backward {held_k:.2f} GiB (kernel route) / {held_a:.2f} GiB "
              f"(use_kernel='off')")
        for t in leaves:
            t.grad = None
        del g_k, g_a

        # rates and peak memory of both routes at the default schedule
        # (epochs 1000: a block every 8 steps), each on a fresh state
        cached = [LP._to_device_batch(b, dev) for b in media.batches(1)]
        tcfg = eff.replace(epochs=1000)
        for tag, sp in (("kernel", spec), ("off", spec_off)):
            gen = R.named_fold(R.root_generator(cfg.random_seed), "init")
            _, state, cs_ = FT.create_flow_state(gen, tcfg)
            check(state.ctrl_cfg.block_iterations == 8, "default schedule")
            step = FT.make_flow_train_step(sp, tcfg)
            for i in range(2):
                step(state, cs_, cached[i])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            events = []
            t0 = time.perf_counter()
            for i in range(10):
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
                m = step(state, cs_, cached[i % pairs])
                b.record()
                events.append((a, b))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(m["loss"]))
                  and state.ctrl_state.cur_block == 12, f"{tag} route")
            stats[tag] = {
                "pairs_per_sec": 10 / wall,
                "step_ms": statistics.median(a.elapsed_time(b)
                                             for a, b in events),
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
            r = stats[tag]
            if tag == "kernel":
                r["busy"] = device_busy(lambda: step(state, cs_, cached[0]))
            print(f"[prog path] PFF spatial, use_kernel="
                  f"{'auto' if tag == 'kernel' else tag}: "
                  f"{r['pairs_per_sec']:.2f} pairs/s, {r['step_ms']:.2f} "
                  f"ms/step (batch 1, {FLOW_H}x{FLOW_W}, float32), peak "
                  f"device memory {r['peak_gib']:.2f} GiB, on {card} "
                  f"({smi_line})")
            if tag == "kernel":
                print("[prog path] " + _busy_line("one PFF spatial train "
                                                  "step", r["busy"]))
            del state, step

        # PFF under the linear controller: a constant mask, so the plain
        # forward and K7 backward with the coordinate rows
        lcfg = cfg.replace(spatially_adaptive=False, name="pff_linear",
                           epochs=1)
        _reset_all_counts()
        lout = LP.run_flow_train(lcfg, media=media, scene=scene)
        torch.cuda.synchronize()
        lcounts = _all_counts()
        check_counts(lcounts, f"PFF linear flow train, {pairs} steps",
                     fused_inr_backward=pairs, reduce_weight_grads=pairs,
                     splat_region=2 * pairs, gather_region=2 * pairs,
                     gather_region_grads=4 * pairs)
        ls = lout["state"].ctrl_state
        check(isinstance(ls, C.LinearState) and ls.iteration == pairs
              and math.isfinite(lout["metrics"]["loss"])
              and float(ls.mask.sum()) > 6.0,
              f"PFF linear: iteration {ls.iteration}")
        lstep = FT.make_flow_train_step(lout["spec"], lout["cfg"])
        for i in range(2):
            lstep(lout["state"], lout["consts"], cached[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            lstep(lout["state"], lout["consts"], cached[i % pairs])
        torch.cuda.synchronize()
        stats["linear_pairs_per_sec"] = 10 / (time.perf_counter() - t0)
        print(f"[prog path] PFF linear controller: {pairs} steps, launches "
              f"{lcounts}; {stats['linear_pairs_per_sec']:.2f} pairs/s over "
              f"10 more steps, on {card} ({smi_line})")
        del lout, lstep
        add_counts(counts, lcounts)

        # serving from the spatial checkpoint: K7 forward once per pair, and
        # no (N, E) tensor: the peak stays under one (N, 512) fp32 tensor
        # over what is allocated before
        init = R.named_fold(R.root_generator(cfg.random_seed + 1), "init")
        spec_r, rp, rc, _, at, rcfg, rstate = LP._flow_create_and_restore(
            cfg, init, scene, require="checkpoint missing")
        check(at == FLOW_TRAIN_EPOCHS + 1 and rstate.cur_block == cs2.cur_block
              and torch.equal(rstate.mask, cs2.mask),
              f"restored checkpoint {at}, block pointer {rstate.cur_block}")
        del st, out, out2, cs, cs2, first, saved, cached
        LP.flow_test_outputs(cfg, media, spec_r, rp, rc, rcfg, rstate)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_all_counts()
        t0 = time.perf_counter()
        served = LP.flow_test_outputs(cfg, media, spec_r, rp, rc, rcfg,
                                      rstate)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        test_counts = _all_counts()
        check_counts(test_counts, "flow test from the spatial checkpoint",
                     fused_inr_forward=pairs)
        check(served["flow12"].shape == (pairs, FLOW_H, FLOW_W, 2)
              and bool(np.isfinite(served["flow12"]).all()),
              "flow test from the spatial checkpoint: flows")
        one = n * 512 * 4 / 2 ** 30
        check(peak < one, f"flow test from the spatial checkpoint took "
              f"{peak:.2f} GiB over what was held: an (N, 512) tensor is "
              f"{one:.2f} GiB")
        add_counts(counts, test_counts)
        stats["test_fps"] = pairs / test_s
        print(f"[prog path] flow test from the spatial checkpoint: {pairs} "
              f"pairs in {test_s:.3f} s, |flow| max "
              f"{np.abs(served['flow12']).max():.2f} px, launches "
              f"{test_counts}, peak {peak:.2f} GiB over the {base / 2**30:.2f}"
              f" GiB held (an (N, 512) tensor: {one:.2f} GiB)")
        pair = torch.from_numpy(media.video[2:4]).to(dev)
        t2 = float(media.times[2])
        _reset_all_counts()
        mid = FT.frame_interp(spec_r, cfg, rp, rc, t2, pair, 0.5,
                              media.flow_scale, rcfg, rstate)
        torch.cuda.synchronize()
        mid_counts = _all_counts()
        check_counts(mid_counts, "one mid-frame from the spatial checkpoint",
                     fused_inr_forward=1, splat_region=2, gather_region=2)
        check(mid.shape == (FLOW_H, FLOW_W, 3)
              and bool(torch.isfinite(mid).all()), "mid-frame")
        add_counts(counts, mid_counts)
        stats["mid_frame_ms"] = median_ms(lambda: FT.frame_interp(
            spec_r, cfg, rp, rc, t2, pair, 0.5, media.flow_scale, rcfg,
            rstate), 10)
        stats["pair_ms"] = median_ms(lambda: FT.flow_infer(
            spec_r, rp, rc, torch.tensor([t2], device=dev), media.flow_scale,
            FLOW_H, FLOW_W, rcfg, rstate), 10)
        stats["pair_busy"] = device_busy(lambda: FT.flow_infer(
            spec_r, rp, rc, torch.tensor([t2], device=dev), media.flow_scale,
            FLOW_H, FLOW_W, rcfg, rstate))
        stats["mid_frame_busy"] = device_busy(lambda: FT.frame_interp(
            spec_r, cfg, rp, rc, t2, pair, 0.5, media.flow_scale, rcfg,
            rstate))
        print(f"[prog path] from the spatial checkpoint: a pair's flows "
              f"{stats['pair_ms']:.3f} ms, a mid-frame "
              f"{stats['mid_frame_ms']:.3f} ms between events; launches of "
              f"one mid-frame {mid_counts}; on {card} ({smi_line})")
        print("[prog path] " + _busy_line("a pair's flows",
                                          stats["pair_busy"]))
        print("[prog path] " + _busy_line("a mid-frame",
                                          stats["mid_frame_busy"]))

        # the card against the CPU on a small crop (slab route on both)
        res = []
        t2t = torch.tensor([t2])
        for d in (dev, torch.device("cpu")):
            p_, c_ = tree_to(rp, d), tree_to(rc, d)
            s_ = rstate._replace(**{k: v.to(d) for k, v in
                                    rstate._asdict().items()
                                    if isinstance(v, torch.Tensor)})
            fl, _ = FT.flow_infer(spec_r, p_, c_, t2t.to(d), 12.8, 40, 64,
                                  rcfg, s_)
            res.append(fl.cpu())
        ferr = (res[0] - res[1]).abs().max().item()
        check(ferr <= 1e-3, f"card vs CPU on a 40x64 crop (PFF spatial): "
                            f"flows {ferr:.3e} px (limit 1e-3)")
        print(f"[prog path] card vs CPU (40x64 crop, slab route): flows max "
              f"abs err {ferr:.3e} px")
    return counts, stats


def k8_cost(m: int, cin: int, caff: int, hid: int, backward: bool = False):
    """FLOP and bytes of one K8 half launch over m pixels: two SAME 3x3
    convolutions a pixel (Cin -> hid -> 2 Caff); x_in and x_aff read once,
    y written once, each weight and bias read once. The backward recomputes
    both, adds the two transposed convolutions and the two weight products
    (three times the forward's FLOP), reads g besides and writes dx_in,
    dx_aff and each weight gradient once."""
    flops = 2 * m * 9 * hid * (cin + 2 * caff)
    weights = 9 * cin * hid + hid + 9 * hid * 2 * caff + 2 * caff
    if backward:
        return 3 * flops, 4 * (m * (2 * cin + 3 * caff) + 2 * weights)
    return flops, 4 * (m * (cin + 2 * caff) + weights)


def k8_bounds(flops: float, nbytes: float):
    """K8's bounds as it runs: every product three TF32 products on the
    tensor cores (3xTF32, ``ops_bound_ms``), with the fp32 rate's and one
    pass of TF32 beside it, and the bytes'."""
    return {"ops_bound_ms": 3 * flops / PEAK_TF32 * 1e3,
            "fp32_bound_ms": flops / PEAK_FP32 * 1e3,
            "tf32_bound_ms": flops / PEAK_TF32 * 1e3,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3}


def _half_conv_route(sub, x_in, x_aff, clamp: float, inverse: bool, compute):
    """One half coupling through the convolution route (cuDNN)."""
    from sin_inn_tpu_torch.ops import coupling as C
    from sin_inn_tpu_torch.ops import subnet as S

    r = S.conv_subnet_apply(sub, x_in, compute=compute)
    caff = x_aff.shape[-1]
    le = C.glow_log_e(r[..., :caff], clamp)
    t = r[..., caff:]
    return ((x_aff - t) * torch.exp(-le) if inverse
            else torch.exp(le) * x_aff + t)


def _trainable(p):
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    leaves = [t.detach().clone().requires_grad_(True)
              for t in K.param_leaves(p)]
    return K.params_from_leaves(leaves), leaves


def _coupling_gate_slack(p, inp, g, clamp: float, len1: int,
                         inverse: bool):
    """``relu_gate_slack`` of each half of a whole coupling's backward at
    ``inp`` for the cotangent g, aligned with [d inp] + the leaves
    (``K.LEAVES``): each subnet's conv1 weight and bias get their half's
    slack; d inp gets the dx_in slack of the half that takes that part of
    inp, and the other half's dx_in slack times e^clamp (the largest scale
    the affine step puts on it), to first order; the other leaves 0."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8

    a, b = inp[..., :len1], inp[..., len1:]
    ga, gb = g[..., :len1], g[..., len1:]
    with torch.no_grad():
        if inverse:     # x2 = half(s1, y1, y2); x1 = half(s2, x2, y1)
            x2 = K8.half_coupling_3x3_plain(p["s1"], a, b, clamp, True)
            last = ("s2", x2, a, ga)
        else:           # y1 = half(s2, x2, x1); y2 = half(s1, y1, x2)
            y1 = K8.half_coupling_3x3_plain(p["s2"], b, a, clamp)
            last = ("s1", y1, b, gb)
        _, dx_in, _ = K8.half_coupling_3x3_backward_plain(
            p[last[0]], *last[1:], clamp, inverse)
        first = (("s1", a, b, gb + dx_in) if inverse
                 else ("s2", b, a, ga + dx_in))
        slack, sdx = {}, {}
        for sub, x_in, x_aff, cot in (last, first):
            sdx[sub], sw, sb = K8.relu_gate_slack(p[sub], x_in, x_aff, cot,
                                                  clamp, inverse)
            slack[(sub, "conv1", "w")], slack[(sub, "conv1", "b")] = sw, sb
        scaled = sdx[last[0]] * math.exp(clamp)
        dinp = (torch.cat([sdx[first[0]], scaled], -1) if inverse
                else torch.cat([scaled, sdx[first[0]]], -1))
    return [dinp] + [slack.get(leaf, 0.0) for leaf in K.LEAVES]


def _normwise_worst(got, ref, slack=None, names=None):
    """The worst of (||a - b|| - ||slack||) / ||b|| over the leaves (the
    slack: each leaf's relu gate slack, or 0), and that leaf's name."""
    slack = slack or [0.0] * len(ref)
    names = names or [str(i) for i in range(len(ref))]
    return max((((a - b).norm().item()
                 - (s.norm().item() if torch.is_tensor(s) else 0.0))
                / max(b.norm().item(), 1e-30), n)
               for a, b, s, n in zip(got, ref, slack, names))


def phase_k8(dev, card: str, smi_line: str):
    """K8 on the seeded SRF flagship's four 3x3 couplings at batch 8."""
    from functools import partial

    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.models.inn import (build_inn_spec, init_inn,
                                              inn_apply, params_to)
    from sin_inn_tpu_torch.ops import coupling as C
    from sin_inn_tpu_torch.ops import subnet as S
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
    from sin_inn_tpu_torch.train import sr as SR

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SRConfig(device="cuda", batch_size=TRAIN_BATCH)
    spec, _ = build_inn_spec(cfg)
    init = R.named_fold(R.root_generator(cfg.random_seed), "init")
    params = params_to(init_inn(init, spec), dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    # each 3x3 coupling's real input: the spec walked layer by layer
    couplings = []
    x = torch.rand((TRAIN_BATCH, HR_H, HR_W, 3), generator=gen, device=dev)
    with torch.no_grad():
        for layer, p in zip(spec, params):
            if layer.kind == "glow" and layer.kernel == 3:
                couplings.append((layer, p, x))
            x = inn_apply([layer], [p], x)
    check([tuple(xin.shape) for _, _, xin in couplings] ==
          [(TRAIN_BATCH, HR_H // 4, HR_W // 4, 48)] * 2 +
          [(TRAIN_BATCH, HR_H // 8, HR_W // 8, 192)] * 2,
          "the flagship's 3x3 couplings are not at their octave shapes")

    # the path: whole couplings forward and inverse, and the banded op's
    # forward and backward, on each coupling; launch counts
    _reset_all_counts()
    runs = []
    for layer, p, xin in couplings:
        clamp, len1 = layer.clamp, layer.split_len1
        with torch.no_grad():
            y = K8.fused_glow3_forward(p, xin, clamp, len1)
            back = K8.fused_glow3_inverse(p, y, clamp, len1)
        q, leaves = _trainable(p)
        xg = xin.clone().requires_grad_(True)
        out = K8.make_fused_coupling3_banded(clamp, len1)[0](q, xg)
        g = torch.randn(out.shape, generator=gen, device=dev)
        out.backward(g)
        runs.append((y, back, out.detach(), g,
                     [xg.grad] + [t.grad for t in leaves]))
    torch.cuda.synchronize()
    counts = _all_counts()
    n = len(couplings)
    check_counts(counts, f"K8 path over {n} couplings (2 K8 forward per "
                         "direction, 2 K8 backward per banded backward)",
                 half_coupling_3x3=6 * n, half_coupling_3x3_backward=2 * n,
                 reduce_weight_grads=2 * n)

    subnet_hi = partial(S.conv_subnet_apply, compute="highest")
    errs = {"fwd": 0.0, "norm": 0.0, "whole": 0.0, "trip": 0.0, "dx": 0.0,
            "leaf": 0.0, "autograd": (0.0, ""), "slack": 0.0}

    def within(got, ref, what, slack=0.0):
        """max abs err; it must hold 1e-4 + 1e-4 |ref| + slack (the relu
        gate slack of K8.relu_gate_slack for dx_in, else 0)."""
        e = (got - ref).abs()
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        check(bool((e <= 1e-4 + 1e-4 * ref.abs() + slack).all()),
              f"{what}: max abs err {e.max().item():.3e} exceeds "
              f"1e-4 + 1e-4|ref| + gate slack")
        return e.max().item()

    def leaves_within(d, ref, slack, tag):
        """Each weight and bias gradient within 1e-3 of its largest |plain|
        plus conv1's relu gate slack."""
        for cv in ("conv1", "conv2"):
            for k in ("w", "b"):
                a, b = d[cv][k], ref[cv][k]
                sl = slack.get((cv, k), 0.0)
                e = ((a - b).abs() - sl).max().item()
                lim = 1e-3 * b.abs().max().item()
                check(a.shape == b.shape and e <= lim,
                      f"{tag} {cv}.{k}: {e:.3e} beyond the gate slack > "
                      f"{lim:.3e}")
                errs["leaf"] = max(errs["leaf"], e / max(
                    b.abs().max().item(), 1e-30))

    def conv_grads(p, inp, g, inverse):
        q, leaves = _trainable(p)
        xx = inp.clone().requires_grad_(True)
        out = (C.glow_coupling_inverse(q, xx, subnet_hi, clamp, len1)
               if inverse else
               C.glow_coupling_forward(q, xx, subnet_hi, clamp, len1)[0])
        out.backward(g)
        return [xx.grad] + [t.grad for t in leaves]

    for ci, ((layer, p, xin), (y, back, out_b, g, grads_b)) in enumerate(
            zip(couplings, runs)):
        clamp, len1 = layer.clamp, layer.split_len1
        what = f"coupling {ci} (C={xin.shape[-1]})"
        with torch.no_grad():
            x1, x2 = xin[..., :len1], xin[..., len1:]
            y1, y2 = y[..., :len1], y[..., len1:]
            x2b = back[..., len1:]
            halves = [("s2", x2, x1), ("s1", y1, x2)]
            inv_halves = [("s1", y1, y2), ("s2", x2b, y1)]
            for inverse, hs in ((False, halves), (True, inv_halves)):
                for sub, x_in, x_aff in hs:
                    got = K8.half_coupling_3x3(p[sub], x_in, x_aff, clamp,
                                               inverse)
                    again = K8.half_coupling_3x3(p[sub], x_in, x_aff, clamp,
                                                 inverse)
                    ref = K8.half_coupling_3x3_plain(p[sub], x_in, x_aff,
                                                     clamp, inverse)
                    tag = f"{what} half {sub} inverse={inverse}"
                    errs["fwd"] = max(errs["fwd"], within(got, ref, tag))
                    # normwise 1e-5: 3xTF32 lands near 1e-7, one-pass TF32
                    # near 1e-4 (tests/test_torch_port_coupling3x3_tc.py)
                    norm = ((got - ref).norm() / ref.norm()).item()
                    check(norm <= 1e-5, f"{tag}: normwise error {norm:.3e} "
                                        f"> 1e-5")
                    errs["norm"] = max(errs["norm"], norm)
                    check(torch.equal(got, again),
                          f"{tag}: two launches differ")
            ref_y = C.glow_coupling_forward(p, xin, subnet_hi, clamp,
                                            len1)[0]
            ref_x = C.glow_coupling_inverse(p, y, subnet_hi, clamp, len1)
            errs["whole"] = max(errs["whole"],
                                within(y, ref_y, f"{what} forward"),
                                within(back, ref_x, f"{what} inverse"))
            trip = (back - xin).abs().max().item()
            check(trip <= 1e-4, f"{what}: inverse(forward(x)) {trip:.3e}")
            errs["trip"] = max(errs["trip"], trip)
            check(torch.equal(out_b, y), f"{what}: the banded op's forward "
                                         "differs from fused_glow3_forward")
        # K8 backward against the plain backward, both flags, bitwise
        # repeatable
        for inverse, hs in ((False, halves), (True, inv_halves)):
            for sub, x_in, x_aff in hs:
                gh = torch.randn(x_aff.shape, generator=gen, device=dev)
                d1 = K8.half_coupling_3x3_backward(p[sub], x_in, x_aff, gh,
                                                   clamp, inverse)
                d2 = K8.half_coupling_3x3_backward(p[sub], x_in, x_aff, gh,
                                                   clamp, inverse)
                rd = K8.half_coupling_3x3_backward_plain(
                    p[sub], x_in, x_aff, gh, clamp, inverse)
                torch.cuda.synchronize()
                tag = f"{what} K8 backward {sub} inverse={inverse}"
                sdx, sw1, sb1 = K8.relu_gate_slack(p[sub], x_in, x_aff, gh,
                                                   clamp, inverse)
                errs["slack"] = max(errs["slack"], sdx.max().item())
                errs["dx"] = max(
                    errs["dx"],
                    within(d1[1], rd[1], f"{tag} dx_in", sdx),
                    within(d1[2], rd[2], f"{tag} dx_aff"))
                leaves_within(d1[0], rd[0], {("conv1", "w"): sw1,
                                             ("conv1", "b"): sb1}, tag)
                for cv in ("conv1", "conv2"):
                    for k in ("w", "b"):
                        check(torch.equal(d1[0][cv][k], d2[0][cv][k]),
                              f"{tag} {cv}.{k}: not bitwise repeatable")
                check(all(torch.equal(a, b) for a, b in zip(d1[1:], d2[1:])),
                      f"{tag}: dx not bitwise repeatable")
                del d1, d2, rd, sdx, sw1, sb1
        # gradients through both autograd ops against the conv route
        names = ["input"] + [".".join(leaf) for leaf in K.LEAVES]
        errs["autograd"] = max(errs["autograd"], _normwise_worst(
            grads_b, conv_grads(p, xin, g, False),
            _coupling_gate_slack(p, xin, g, clamp, len1, False), names))
        for inverse in (False, True):
            inp = y if inverse else xin
            ref = conv_grads(p, inp, g, inverse)
            slack = _coupling_gate_slack(p, inp, g, clamp, len1, inverse)
            for op in (K8.make_fused_coupling3_banded(clamp, len1),
                       K8.make_fused_coupling3(clamp, len1, "highest")):
                q, leaves = _trainable(p)
                xx = inp.clone().requires_grad_(True)
                op[int(inverse)](q, xx).backward(g)
                worst = _normwise_worst([xx.grad] + [t.grad for t in leaves],
                                        ref, slack, names)
                check(worst[0] <= 1e-3, f"{what} autograd op inverse="
                                        f"{inverse}: gradient of {worst[1]}"
                                        f" {worst[0]:.3e} > 1e-3")
                errs["autograd"] = max(errs["autograd"], worst)
    print(f"[k8] errors: half launches vs plain {errs['fwd']:.3e} "
          f"(normwise {errs['norm']:.3e}; two launches bitwise equal), whole "
          f"coupling vs cuDNN (TF32 off) {errs['whole']:.3e}, round trip "
          f"{errs['trip']:.3e}, backward dx {errs['dx']:.3e} (largest relu "
          f"gate slack of dx_in {errs['slack']:.3e}: conv1 pre-activations "
          f"within 1e-5 of 0), worst leaf beyond its slack {errs['leaf']:.3e}"
          f" of its max, autograd ops vs conv route {errs['autograd'][0]:.3e} "
          f"(normwise, beyond the slack; worst leaf {errs['autograd'][1]})")

    # times per half at both octaves: the first coupling of each, half s2
    rows = {"K8 fwd": [], "K8 bwd": []}
    serve_rows = []
    for layer, p, xin in (couplings[0], couplings[2]):
        clamp, len1 = layer.clamp, layer.split_len1
        sub = p["s2"]
        x_in8 = xin[..., len1:].contiguous()
        x_aff8 = xin[..., :len1].contiguous()
        cin, caff, hid = x_in8.shape[-1], x_aff8.shape[-1], HIDDEN
        for b in (TRAIN_BATCH, BATCH):
            x_in = x_in8.repeat(b // TRAIN_BATCH, 1, 1, 1)
            x_aff = x_aff8.repeat(b // TRAIN_BATCH, 1, 1, 1)
            m = x_in.numel() // cin
            flops, nbytes = k8_cost(m, cin, caff, hid)
            reps = 10 if b == TRAIN_BATCH else 5
            with torch.no_grad():
                got = K8.half_coupling_3x3(sub, x_in, x_aff, clamp)
                ref = K8.half_coupling_3x3_plain(sub, x_in, x_aff, clamp)
                err = within(got, ref, f"K8 forward batch {b} Cin={cin}")
                del got, ref
                row = {
                    "shape": [b, x_in.shape[1], x_in.shape[2], cin, caff],
                    "M": m, "max_abs_err": err,
                    "ms": median_ms(lambda: K8.half_coupling_3x3(
                        sub, x_in, x_aff, clamp), reps),
                    "plain_ms": median_ms(lambda: K8.half_coupling_3x3_plain(
                        sub, x_in, x_aff, clamp), reps),
                    "cudnn_tf32_ms": median_ms(lambda: _half_conv_route(
                        sub, x_in, x_aff, clamp, False, None), reps),
                    "cudnn_fp32_ms": median_ms(lambda: _half_conv_route(
                        sub, x_in, x_aff, clamp, False, "highest"), reps),
                    "flop": flops, "bytes": nbytes,
                    **k8_bounds(flops, nbytes),
                    "library_ms": None,
                }
            (rows["K8 fwd"] if b == TRAIN_BATCH else serve_rows).append(row)
            del x_in, x_aff
        gh = torch.randn(x_aff8.shape, generator=gen, device=dev)
        m = x_in8.numel() // cin
        flops, nbytes = k8_cost(m, cin, caff, hid, backward=True)
        d = K8.half_coupling_3x3_backward(sub, x_in8, x_aff8, gh, clamp)
        rd = K8.half_coupling_3x3_backward_plain(sub, x_in8, x_aff8, gh,
                                                 clamp)
        sdx, _, _ = K8.relu_gate_slack(sub, x_in8, x_aff8, gh, clamp)
        err = max(within(d[1], rd[1], f"K8 backward Cin={cin} dx_in", sdx),
                  within(d[2], rd[2], f"K8 backward Cin={cin} dx_aff"))
        del d, rd, sdx

        def conv_vjp(compute):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in K8.sub_leaves(sub)]
            q = K8.sub_from_leaves(leaves)
            xi = x_in8.clone().requires_grad_(True)
            xa = x_aff8.clone().requires_grad_(True)
            out = _half_conv_route(q, xi, xa, clamp, False, compute)
            return torch.autograd.grad(out, [xi, xa, *leaves], gh)

        rows["K8 bwd"].append({
            "shape": [TRAIN_BATCH, x_in8.shape[1], x_in8.shape[2], cin, caff],
            "M": m, "max_abs_err": err,
            "ms": median_ms(lambda: K8.half_coupling_3x3_backward(
                sub, x_in8, x_aff8, gh, clamp), 5),
            "plain_ms": median_ms(lambda: K8.half_coupling_3x3_backward_plain(
                sub, x_in8, x_aff8, gh, clamp), 5),
            "cudnn_tf32_ms": median_ms(lambda: conv_vjp(None), 5),
            "cudnn_fp32_ms": median_ms(lambda: conv_vjp("highest"), 5),
            "partials_mb": K8.backward_chunks(m, cin, caff, hid) * (
                (9 * cin + 1) * hid + (9 * hid + 1) * 2 * caff) * 4 / 1e6,
            "flop": flops, "bytes": nbytes,
            **k8_bounds(flops, nbytes),
            "library_ms": None,
        })
    for name, rs in (("K8 fwd", rows["K8 fwd"] + serve_rows),
                     ("K8 bwd", rows["K8 bwd"])):
        for r in rs:
            print(f"[k8] {name} {r['shape']}: {r['ms']:.3f} ms (plain "
                  f"{r['plain_ms']:.3f}; cuDNN route TF32 "
                  f"{r['cudnn_tf32_ms']:.3f} / fp32 {r['cudnn_fp32_ms']:.3f};"
                  f" {r['flop'] * 3 / r['ms'] / 1e9:.1f} TFLOP/s of TF32 "
                  f"work; bounds 3xTF32 {r['ops_bound_ms']:.4f} / fp32 "
                  f"{r['fp32_bound_ms']:.3f} / tf32 {r['tf32_bound_ms']:.4f}"
                  f" / bytes {r['bytes_bound_ms']:.4f} ms) max abs err "
                  f"{r['max_abs_err']:.3e}, on {card} ({smi_line})")

    # a whole sr train step at the flagship launches no K8
    state = SR.train_state(params, cfg)
    batch = {"hr": torch.randint(0, 256, (TRAIN_BATCH, HR_H, HR_W, 3),
                                 generator=gen, device=dev,
                                 dtype=torch.uint8),
             "lr": torch.randint(0, 256, (TRAIN_BATCH, HR_H // 8, HR_W // 8,
                                          cfg.lr_dims), generator=gen,
                                 device=dev, dtype=torch.uint8)}
    step = SR.make_train_step(spec, cfg)
    _reset_all_counts()
    aux = step(state, batch, None, gen)
    torch.cuda.synchronize()
    check(math.isfinite(aux["loss"].item()), "sr train step: non-finite loss")
    check_counts(_all_counts(), "one sr train step (no K8)",
                 fused_glow_forward_1x1=4, fused_glow_inverse_1x1=4,
                 fused_glow_backward_1x1=4, fused_glow_inverse_backward_1x1=4,
                 reduce_weight_grads=8)
    print(f"[k8] launches on the path: {counts}; one sr train step: no K8")
    return rows, serve_rows, counts


def phase_irn_exchange(dev, card: str, smi_line: str, srf_cfg):
    """IRN flagship training, serving and the card against the CPU; the
    checkpoint exchange of the SRF (phase 5's) and IRN runs."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data.sr_video import make_datasets
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.models.inn import (build_inn_spec, inn_apply,
                                              params_to)
    from os.path import join as path_join

    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import sr as SR

    stats = {}
    with tempfile.TemporaryDirectory() as work:
        cfg = SRConfig(architecture="IRN", scene="chip_smoke_irn",
                       device="cuda", compute_dtype="float32",
                       working_dir=work, batch_size=TRAIN_BATCH, epochs=2,
                       print_iter=1, save_iter=1)
        check(cfg.total_dims == 192 and cfg.octaves == 2
              and cfg.num_coupling == 4 and cfg.dense_gc == 32
              and cfg.val_batch_size == BATCH,
              "SRConfig defaults are not the IRN flagship config")
        video = synthetic_sr_video(cfg, num_frames=TRAIN_FRAMES, h=HR_H,
                                   w=HR_W)
        _reset_all_counts()
        t0 = time.perf_counter()
        out = LP.run_sr_train(cfg, video=video)
        torch.cuda.synchronize()
        check(out["start_epoch"] == 0 and out["state"].step == 4,
              f"IRN run_sr_train took {out['state'].step} steps, want 4")
        check(all(math.isfinite(v) for v in out["metrics"].values()),
              f"IRN run_sr_train: non-finite metric {out['metrics']}")
        ckpts = CheckpointStore(path_join(out["exp_dir"], "checkpoints"))
        check(ckpts.latest_step() == 2, "IRN: latest checkpoint is not 2")
        print(f"[irn] run_sr_train: 4 steps in "
              f"{time.perf_counter() - t0:.1f} s; metrics {out['metrics']}")
        cfg = cfg.replace(epochs=3)
        again = LP.run_sr_train(cfg, video=video)
        st, spec = again["state"], again["spec"]
        check(again["start_epoch"] == 2 and st.step == 6,
              f"IRN resume: epoch {again['start_epoch']}, step {st.step}")
        print(f"[irn] resumed at epoch 2: step {st.step}, loss "
              f"{again['metrics']['loss']:.6g}")

        sup, _, val = make_datasets(video, cfg)
        batch = sup.device_cache(TRAIN_BATCH, dev)[0]
        step = SR.make_train_step(spec, cfg)
        gen = torch.Generator(device=dev).manual_seed(13)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            step(st, batch, None, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            aux = step(st, batch, None, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(math.isfinite(aux["loss"].item()), "IRN: non-finite loss")
        stats.update(train_frames_per_sec=10 * TRAIN_BATCH / dt,
                     ms_per_step=dt * 100,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)

        frames = np.stack(list(LP.sr_test_frames(cfg, video, st, spec)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = np.stack(list(LP.sr_test_frames(cfg, video, st, spec)))
        torch.cuda.synchronize()
        stats["test_frames_per_sec"] = len(frames) / (time.perf_counter() - t0)
        check(frames.dtype == np.uint8 and frames.shape[1:] == (HR_H, HR_W, 3)
              and len(frames) > 0, f"IRN sr test frames {frames.shape}")
        check_counts(_all_counts(), "the IRN path (train, resume, steps, sr "
                                    "test): no kernel")
        print(f"[irn] {stats['train_frames_per_sec']:.2f} train frames/s, "
              f"{stats['ms_per_step']:.2f} ms/step (batch {TRAIN_BATCH}), "
              f"peak {stats['peak_gib']:.2f} GiB; sr test {len(frames)} "
              f"frames, {stats['test_frames_per_sec']:.2f} frames/s; on "
              f"{card} ({smi_line})")

        # the card against the CPU on a small crop, full fp32 on both sides
        small = cfg.replace(device="cpu", compute_dtype="float32_highest")
        spec_hi = build_inn_spec(small)[0]
        lr8 = val.device_cache(4, dev)[0]["lr"][:2, :8, :8].float() / 255.0
        z = torch.randn(lr8.shape[:3] + (small.z_dims,),
                        generator=torch.Generator().manual_seed(7))
        lr_z = torch.cat([lr8.cpu(), z], dim=-1)
        with torch.inference_mode():
            ref = inn_apply(spec_hi, params_to(st.params, "cpu"), lr_z,
                            rev=True)
            got = inn_apply(spec_hi, st.params, lr_z.to(dev), rev=True)
        err = (got.cpu() - ref).abs().max().item()
        check(err <= 1e-3, f"IRN card vs CPU: {err:.3e} > 1e-3")
        stats["cpu_err"] = err
        print(f"[irn] card vs CPU (2x64x64, float32_highest): max abs err "
              f"{err:.3e}")

        # export each run's checkpoint, import it into a fresh sr test
        lr = val.device_cache(BATCH, dev)[0]["lr"].float() / 255.0
        z = torch.randn(lr.shape[:3] + (cfg.z_dims,),
                        generator=torch.Generator(device=dev).manual_seed(8),
                        device=dev)
        for name, run_cfg in (("SRF", srf_cfg), ("IRN", cfg)):
            t0 = time.perf_counter()
            ckpt = LP.run_sr_export(run_cfg)
            init = R.named_fold(R.root_generator(run_cfg.random_seed), "init")
            spec_a, state_a, _, step_a = LP._sr_create_and_restore(
                run_cfg, init, require="exported run lost its checkpoint")
            fresh = run_cfg.replace(working_dir=path_join(work, "fresh"),
                                    import_torch=ckpt)
            spec_b, state_b, _, step_b = LP._sr_create_and_restore(
                fresh, init, require="no checkpoint to test from")
            check(step_a > 0 and step_b == 0,
                  f"{name}: restored steps {step_a} / {step_b}")
            with torch.inference_mode():
                lr_z = torch.cat([lr, z], dim=-1)
                a = inn_apply(spec_a, state_a.params, lr_z, rev=True)
                b = inn_apply(spec_b, state_b.params, lr_z, rev=True)
            e = (a - b).abs().max().item()
            check(e <= 1e-5, f"{name}: imported run's output {e:.3e} from "
                             "the exported run's (limit 1e-5)")
            fa = np.stack(list(itertools.islice(
                LP.sr_test_frames(run_cfg, video, state_a, spec_a), BATCH)))
            fb = np.stack(list(itertools.islice(
                LP.sr_test_frames(fresh, video, state_b, spec_b), BATCH)))
            fd = int(np.abs(fa.astype(np.int16) - fb).max())
            check(fd <= 1, f"{name}: imported sr test frames differ by {fd}")
            stats[f"{name}_exchange_err"] = e
            print(f"[exchange] {name}: sr export of step {step_a} -> "
                  f"--import-torch into a fresh sr test: max abs err "
                  f"{e:.3e}, frames within {fd} level(s), "
                  f"{time.perf_counter() - t0:.1f} s")
    return stats


# the trace symbol of each kernel: one event a launch
TRACE_SYMBOLS = {
    "fused_glow_forward_1x1": r"coupling_1x1_kernel<float, false",
    "fused_glow_inverse_1x1": r"coupling_1x1_kernel<float, true",
    # the first of the four row phases of K3 / K4
    "fused_glow_backward_1x1": r"row_phase_kernel<float, false, 0",
    "fused_glow_inverse_backward_1x1": r"row_phase_kernel<float, true, 0",
    "splat_region_local": r"splat_kernel<\d+, true>",
    "gather_region_local": r"gather_region_kernel<true,",
    "gather_region_local_grads": r"gather_region_grads_kernel<true>",
    # K7 backward's fixed-order reduction, once a launch (on a flow train
    # step no other kernel reduces gradient slots)
    "fused_inr_backward": r"reduce_partials_kernel",
}


def trace_kernel_counts(path: str, names):
    """Kernel events of a Chrome trace (``core/profiler.py``'s) by the
    ``TRACE_SYMBOLS`` of ``names``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    check(kernels, f"trace {path} holds no kernel event")
    return {n: sum(bool(re.search(TRACE_SYMBOLS[n], k)) for k in kernels)
            for n in names}, len(kernels)


@contextlib.contextmanager
def _recording(module, name: str, into: list):
    """Record what ``module.name`` returns while the block runs."""
    real = getattr(module, name)

    def wrapper(*a, **kw):
        into.append(real(*a, **kw))
        return into[-1]

    setattr(module, name, wrapper)
    try:
        yield into
    finally:
        setattr(module, name, real)


def phase_sr_tooling(dev, card: str, smi_line: str, work: str):
    """14. The tooling of ``sr train`` at the SRF flagship (HR 352x640,
    float32, the 204-frame synthetic video): the native gather against
    numpy, ``find_batch_size`` from batch 8 (the memory it gives back, a
    planted non-OOM fault that must propagate), ``find_lr`` with its launch
    counts, and ``run_sr_train --profile 3`` with the trace's K1-K4 events
    against the launch counters."""
    import gc
    import os
    import os.path as path

    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data import native
    from sin_inn_tpu_torch.data import sr_video as SV
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import tuner as T

    torch.backends.cuda.matmul.allow_tf32 = False
    stats, counts = {}, {}
    cfg = SRConfig(scene="chip_smoke_tools", device="cuda",
                   compute_dtype="float32", working_dir=work,
                   batch_size=TRAIN_BATCH, epochs=3, print_iter=100,
                   save_iter=100, profile_steps=3)
    video = synthetic_sr_video(cfg, num_frames=TRAIN_FRAMES, h=HR_H, w=HR_W)
    sup, _, _ = SV.make_datasets(video, cfg)

    # the native route, byte for byte the numpy route's
    check(native.available(), "the native loader is not built (no g++?)")
    sel = np.arange(TRAIN_BATCH) % len(sup)

    def numpy_gather():
        win = video.lr[sup.window[sel]]
        b_, t_, h_, w_, c_ = win.shape
        return {"lr": np.moveaxis(win, 1, 3).reshape(b_, h_, w_, t_ * c_),
                "hr": video.hr[sup.indices[sel]]}

    SV.reset_gather_route_counts()
    got = sup.gather(sel)
    check(SV.gather_route_counts() == {"native": 1, "numpy": 0},
          f"gather routes {SV.gather_route_counts()}")
    ref = numpy_gather()
    # host ms of each route, 10 calls in turns
    times = {"native": [], "numpy": []}
    for _ in range(10):
        for name, fn in (("native", lambda: sup.gather(sel)),
                         ("numpy", numpy_gather)):
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    native_ms = statistics.median(times["native"])
    numpy_ms = statistics.median(times["numpy"])
    check(got["lr"].shape == (TRAIN_BATCH, HR_H // 8, HR_W // 8, 84)
          and all(np.array_equal(got[k], ref[k]) for k in ("hr", "lr")),
          f"the native gather differs from numpy's (lr {got['lr'].shape}, "
          f"numpy {ref['lr'].shape})")
    stats["gather_ms"] = {"native": native_ms, "numpy": numpy_ms}
    print(f"[sr tools] native gather of {TRAIN_BATCH} windows (lr_window "
          f"{cfg.lr_window}): median {native_ms:.2f} ms, numpy "
          f"{numpy_ms:.2f} ms (10 calls each in turns, host clock), bytes "
          f"equal")

    make = lambda b: SV.to_device(sup.gather(np.arange(b) % len(sup)), dev)
    gen = R.named_fold(R.root_generator(cfg.random_seed, dev), "tune")

    # find_batch_size from batch 8: doubles until out of memory or past 512
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with _recording(T, "batch_probes", []) as rec:
        b = T.find_batch_size(cfg, make, gen, start=TRAIN_BATCH, limit=512)
    probe_s = time.perf_counter() - t0
    probes = rec[0]
    ran = [p for p in probes if p["error"] is None]
    last = probes[-1]
    check(ran and b == ran[-1]["batch"] and b >= TRAIN_BATCH,
          f"find_batch_size returned {b}, probes {probes}")
    check((last["error"] is not None and last["batch"] == 2 * b
           and last["error"].startswith("OutOfMemoryError"))
          or (last["error"] is None and 2 * b > 512),
          f"the doubling stopped otherwise than out of memory or at the "
          f"limit: {probes}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    check(held <= 64 << 20, f"find_batch_size left {held / 2 ** 20:.1f} MiB "
                            "allocated")
    peak = ran[-1]["peak_bytes"]
    stats["batch_probe"] = {"batch": b, "peak_bytes": peak, "seconds":
                            probe_s, "stopped_by": last["error"] or
                            "limit 512", "probes": probes,
                            "held_bytes": held}
    # the allocator's message up to its account of the card's memory
    brief = lambda err: err.split(" GPU ")[0] if err else "ran"
    print(f"[sr tools] find_batch_size from {TRAIN_BATCH}: batch {b}, its "
          f"peak {peak / 2 ** 30:.2f} GiB, in {probe_s:.1f} s; stopped by "
          f"{brief(last['error']) if last['error'] else 'the limit 512'}; "
          f"{held / 2 ** 20:.2f} MiB left allocated; on {card} ({smi_line})")
    for p in probes:
        print(f"[sr tools]   probe batch {p['batch']}: peak "
              f"{(p['peak_bytes'] or 0) / 2 ** 30:.2f} GiB, "
              f"{brief(p['error'])}")

    # a planted fault that is not out of memory propagates
    real = T.SR.make_train_step

    def planted(spec, c):
        step = real(spec, c)

        def run(state, sup_batch, *a, **kw):
            if sup_batch["hr"].shape[0] == 32:
                raise RuntimeError("planted fault at batch 32")
            return step(state, sup_batch, *a, **kw)
        return run

    T.SR.make_train_step = planted
    try:
        T.find_batch_size(cfg, make, gen, start=TRAIN_BATCH, limit=512)
    except RuntimeError as e:
        check("planted fault at batch 32" in str(e), f"another error: {e}")
    else:
        raise SmokeFailure("find_batch_size swallowed a RuntimeError")
    finally:
        T.SR.make_train_step = real
    gc.collect()
    torch.cuda.empty_cache()
    print("[sr tools] a RuntimeError planted at batch 32 propagated out of "
          "find_batch_size")

    # find_lr: the five default LRs, 8 steps each, at batch 8
    batch = make(TRAIN_BATCH)
    _reset_all_counts()
    t0 = time.perf_counter()
    with _recording(T, "lr_scores", []) as rec:
        lr = T.find_lr(cfg, batch, gen)
    torch.cuda.synchronize()
    lr_s = time.perf_counter() - t0
    scores = rec[0]
    steps = sum(r["steps"] for r in scores)
    run_counts = _all_counts()
    check([r["lr"] for r in scores] == list(T.DEFAULT_LRS)
          and all(r["steps"] == 8 or r["score"] == -math.inf
                  for r in scores), f"find_lr scores {scores}")
    check(lr == max((r["score"], r["lr"]) for r in scores)[1],
          f"find_lr picked {lr}")
    check_counts(run_counts, f"find_lr ({steps} steps)",
                 fused_glow_forward_1x1=4 * steps,
                 fused_glow_inverse_1x1=4 * steps,
                 fused_glow_backward_1x1=4 * steps,
                 fused_glow_inverse_backward_1x1=4 * steps,
                 reduce_weight_grads=8 * steps)
    add_counts(counts, run_counts)
    stats["find_lr"] = {"lr": lr, "seconds": lr_s, "steps": steps,
                        "scores": [(r["lr"], r["score"]) for r in scores]}
    print(f"[sr tools] find_lr: {steps} steps in {lr_s:.2f} s, picked {lr:g};"
          f" scores " + ", ".join(f"{r['lr']:g}: {r['score']:.6g}"
                                  for r in scores)
          + f"; on {card} ({smi_line})")
    del batch

    # run_sr_train --profile 3: 3 epochs of 2 steps, steps 4-6 traced
    _reset_all_counts()
    t0 = time.perf_counter()
    out = LP.run_sr_train(cfg, video=video)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_counts = _all_counts()
    n_steps = out["state"].step
    check(n_steps == 6, f"run_sr_train took {n_steps} steps, want 6")
    check_counts(run_counts, "run_sr_train --profile 3 (6 steps, 1 eval)",
                 fused_glow_forward_1x1=4 * 6 + 4,
                 fused_glow_inverse_1x1=4 * 6 + 4,
                 fused_glow_backward_1x1=4 * 6,
                 fused_glow_inverse_backward_1x1=4 * 6,
                 reduce_weight_grads=8 * 6)
    add_counts(counts, run_counts)
    trace = out["trace"]
    check(trace is not None and trace.startswith(path.join(
        out["exp_dir"], "checkpoints", "trace")), f"trace at {trace}")
    in_trace, n_kernels = trace_kernel_counts(trace, COUPLING)
    check(in_trace == {n: 3 * 4 for n in COUPLING},
          f"trace of 3 steps: {in_trace}, want 12 of each")
    stats["profile"] = {"trace_bytes": os.path.getsize(trace),
                        "kernel_events": n_kernels, "counts": in_trace,
                        "seconds": run_s}
    print(f"[sr tools] run_sr_train --profile 3: {run_s:.1f} s; trace "
          f"{os.path.getsize(trace) / 2 ** 20:.1f} MiB, {n_kernels} kernel "
          f"events, K1-K4 {in_trace}")
    return counts, stats


def phase_flow_exchange(dev, card: str, smi_line: str):
    """15. The flow exchange and the dataset entry points at Sintel size:
    ``flow train --profile 2`` on the RBF net and the default local windows
    (the trace's kernel events against the launch counters), a PFF spatial
    checkpoint through ``run_flow_export``, ``torch.load`` and
    ``--import-torch``, the RBF round trip, the Sintel core on two scenes
    (one from its checkpoint, one from the imported weights) and the
    summarize core."""
    import os

    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flo import read_flo
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inr import flat_leaves
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train import loop as LP

    stats, counts = {}, {}
    pairs = FLOW_FRAMES - 1
    init = lambda: R.named_fold(R.root_generator(0), "init")
    with tempfile.TemporaryDirectory() as work:
        # flow train --profile 2: one epoch of 5 steps, steps 4-5 traced
        cfg = FlowConfig(device="cuda", checkpoints_dir=work + "/ck",
                         results_dir=work + "/results", name="rbf",
                         epochs=1, profile_steps=2)
        media = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                               seed=1))
        _reset_all_counts()
        t0 = time.perf_counter()
        out = LP.run_flow_train(cfg, media=media, scene="rbf_scene")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_counts = _all_counts()
        per_step = dict(splat_region_local=2, gather_region_local=2,
                        gather_region_local_grads=4, fused_inr_backward=1)
        check_counts(run_counts, f"flow train --profile 2 ({pairs} steps)",
                     reduce_weight_grads=pairs,
                     **{k: v * pairs for k, v in per_step.items()})
        add_counts(counts, run_counts)
        in_trace, n_kernels = trace_kernel_counts(out["trace"], per_step)
        check(in_trace == {k: 2 * v for k, v in per_step.items()},
              f"trace of 2 steps: {in_trace}, want 2 x {per_step}")
        stats["profile"] = {"trace_bytes": os.path.getsize(out["trace"]),
                            "kernel_events": n_kernels, "counts": in_trace}
        print(f"[flow exchange] flow train --profile 2: {run_s:.1f} s with "
              f"the trace; {n_kernels} kernel events, "
              f"{os.path.getsize(out['trace']) / 2 ** 20:.1f} MiB; {in_trace}")

        # the RBF round trip: export, torch.load, import; bitwise
        path_rbf = LP.run_flow_export(cfg.replace(input_video="x/rbf_scene"))
        sd = torch.load(path_rbf, weights_only=True)["state_dict"]
        check(all(k.startswith("net.") for k in sd), f"keys {list(sd)[:3]}")
        spec, p2, c2, cc2, cs2 = FT.build_flow_model(
            init(), cfg.replace(import_torch=path_rbf), dev)
        times = torch.from_numpy(media.times[:1]).to(dev)
        scale = float(np.float32(media.flow_scale))
        src = FT.flow_infer(out["spec"], out["state"].params, out["consts"],
                            times, scale, FLOW_H, FLOW_W)
        imp = FT.flow_infer(spec, p2, c2, times, scale, FLOW_H, FLOW_W)
        check(all(torch.equal(a, b) for a, b in zip(src, imp)),
              "RBF: the imported net's flows differ from the source's")
        print(f"[flow exchange] RBF export -> torch.load -> import: "
              f"{len(sd)} tensors, a pair's flows bitwise equal")

        # a PFF spatial checkpoint of a few steps, exported and imported
        pcfg = FlowConfig(net="PFF", spatially_adaptive=True, device="cuda",
                          checkpoints_dir=work + "/ck",
                          results_dir=work + "/results", name="pff",
                          epochs=1, splat_local_dy="off")
        media_a = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                                 seed=4))
        _reset_all_counts()
        LP.run_flow_train(pcfg, media=media_a, scene="scene_a")
        torch.cuda.synchronize()
        add_counts(counts, _all_counts())
        path_pff = LP.run_flow_export(pcfg.replace(input_video="x/scene_a"))
        sd = torch.load(path_pff, weights_only=True)["state_dict"]
        check(sd["net.mask_stashed"].shape == (125000,),
              f"mask counts {tuple(sd['net.mask_stashed'].shape)}")
        spec, pa, ca, _, _, ccfg, csa = LP._flow_create_and_restore(
            pcfg, init(), "scene_a", require="no checkpoint")
        _, pb, cb, ccb, csb = FT.build_flow_model(
            init(), pcfg.replace(import_torch=path_pff), dev)
        _reset_all_counts()
        times = torch.from_numpy(media_a.times[:1]).to(dev)
        src = FT.flow_infer(spec, pa, ca, times, scale, FLOW_H, FLOW_W, ccfg,
                            csa)
        imp = FT.flow_infer(spec, pb, cb, times, scale, FLOW_H, FLOW_W, ccb,
                            csb)
        torch.cuda.synchronize()
        run_counts = _all_counts()
        check_counts(run_counts, "a PFF spatial pair from the checkpoint and "
                                 "from the import", fused_inr_forward=2)
        add_counts(counts, run_counts)
        err = max((a - b).abs().max().item() for a, b in zip(src, imp))
        check(all(bool(((a - b).abs() <= 1e-5 + 1e-5 * a.abs()).all())
                  for a, b in zip(src, imp)),
              f"PFF spatial: the imported flows differ by {err:.3e}")
        check(all(torch.equal(x, y) for (_, x), (_, y) in
                  zip(flat_leaves(pa), flat_leaves(pb))),
              "PFF spatial: imported params differ")
        stats["pff_max_abs_err"] = err
        print(f"[flow exchange] PFF spatial export -> torch.load -> import "
              f"({len(sd)} tensors, the mask as 125,000 counts): a pair's "
              f"flows within {err:.3e} (limit 1e-5 + 1e-5 |ref|), one K7 "
              f"forward each")

        # the Sintel core: scene_a from its checkpoint, scene_b from the
        # --import-torch weights; 5 .flo a scene
        media_b = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                                 seed=5))
        rng = np.random.RandomState(7)
        gts = {s: rng.randn(pairs, FLOW_H, FLOW_W, 2).astype(np.float32) * 3
               for s in ("scene_a", "scene_b")}
        models = {"scene_a": (pcfg, (spec, pa, ca, ccfg, csa))}
        bcfg = pcfg.replace(import_torch=path_pff)
        sb = LP._flow_create_and_restore(bcfg, init(), "scene_b",
                                         require="no checkpoint")
        check(sb[4] == 0, "scene_b restored a checkpoint")
        models["scene_b"] = (bcfg, (sb[0], sb[1], sb[2], sb[5], sb[6]))
        results, sintel_s = [], 0.0
        _reset_all_counts()
        for scene, m in (("scene_a", media_a), ("scene_b", media_b)):
            c, model = models[scene]
            outdir = os.path.join(work, "sintel", "final", scene)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flows = LP.sintel_scene_flows(c, m, *model, outdir=outdir)
            sintel_s += time.perf_counter() - t0
            names = sorted(os.listdir(outdir))
            check(names == [f"frame_{i + 1:04d}.flo" for i in range(pairs)],
                  f"{scene}: {names}")
            test = LP.flow_test_outputs(c, FlowMedia(m.video,
                                                     flow=gts[scene]),
                                        *model)
            for i, name in enumerate(names):
                back = read_flo(os.path.join(outdir, name))
                check(np.array_equal(back, flows[i])
                      and np.array_equal(back, test["flow12"][i]),
                      f"{scene}/{name}: the .flo differs from the flows")
            epe = np.mean([np.sqrt(((flows[i] - gts[scene][i]) ** 2).sum(-1)
                                   ).mean() for i in range(pairs)])
            check(abs(test["epe"] - epe) <= 1e-5 * epe,
                  f"{scene}: EPE {test['epe']} against {epe} from the .flo")
            results.append({"epe": test["epe"], "num_frames": pairs})
        torch.cuda.synchronize()
        run_counts = _all_counts()
        check_counts(run_counts, "the sintel and test cores, 2 scenes",
                     fused_inr_forward=4 * pairs)
        add_counts(counts, run_counts)
        aepe = LP.normalized_aepe(results)
        want = sum(r["epe"] * r["num_frames"] for r in results) / (2 * pairs)
        check(abs(aepe - want) <= 1e-12 * want, f"AEPE {aepe}, want {want}")
        stats["sintel_pairs_per_sec"] = 2 * pairs / sintel_s
        stats["aepe"] = aepe
        print(f"[flow exchange] sintel core: 2 scenes x {pairs} .flo, read "
              f"back bitwise equal to the flows and to flow_test_outputs'; "
              f"{stats['sintel_pairs_per_sec']:.2f} pairs/s with the writes, "
              f"on {card} ({smi_line}); summarize core: AEPE {aepe:.6f} "
              f"over per-scene EPEs {[r['epe'] for r in results]}")
    return counts, stats


def event_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median ms of ``reps`` calls of ``fn`` between CUDA events, after
    ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def _allclose(got, ref, atol: float, rtol: float) -> bool:
    return bool(torch.all((got - ref).abs() <= atol + rtol * ref.abs()))


def _normwise(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def _raft_ckpt(variant: str, path: str) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in
                raft_state_dict_np(variant).items()}, path)
    return path


def phase_raft(dev, card: str, smi_line: str, work: str):
    """16. RAFT, the pseudo-GT producer: the committed goldens on the card
    with TF32 off, the two lookups against each other, both variants at
    Sintel size (ms a pair, peak memory, the default route against TF32
    off), and no launch of a port kernel."""
    import os

    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models import raft as TR

    golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "goldens")
    stats = {}
    _reset_all_counts()
    video = moving_texture_video(5, FLOW_H, FLOW_W, seed=1) * 255.0
    for variant in ("basic", "small"):
        params = TR.load_torch_weights(
            _raft_ckpt(variant, os.path.join(work, f"raft-{variant}.pth")),
            device=dev)
        check(TR.detect_variant(params) == variant, "variant detection")
        z = np.load(os.path.join(golden_dir, f"raft_{variant}.npz"))
        i1 = torch.from_numpy(z["img1"]).to(dev)
        i2 = torch.from_numpy(z["img2"]).to(dev)
        ref = torch.from_numpy(z["flow"]).to(dev)
        flows = {lk: TR.raft_flow(params, i1, i2, iters=int(z["iters"]),
                                  variant=variant, lookup=lk,
                                  lookup_precision="highest")
                 for lk in TR.LOOKUPS}
        for lk, f in flows.items():
            err = float((f - ref).abs().max())
            check(_allclose(f, ref, 2e-3, 1e-2),
                  f"RAFT {variant} ({lk}) against the golden: max err {err}")
            stats[f"{variant}_golden_err_{lk}"] = err
        # the lookups on the golden pair's pyramid and a spread of points,
        # in and out of frame
        fm = TR._small_encoder if variant == "small" else TR._encoder
        with TR._cudnn_tf32(False):
            fmaps = fm(params, "fnet",
                       2.0 * (torch.cat([i1, i2]) / 255.0) - 1.0, "instance")
        pyr = TR.build_corr_pyramid(*torch.chunk(fmaps, 2))
        b, h, w, _ = fmaps[:1].shape
        gen = torch.Generator(device=dev).manual_seed(16)
        coords = (torch.rand((1, h, w, 2), generator=gen, device=dev)
                  * torch.tensor([w + 16.0, h + 16.0], device=dev) - 8.0)
        r = TR.S_CORR_RADIUS if variant == "small" else TR.CORR_RADIUS
        mm = TR.lookup_corr_matmul(pyr, coords, r=r, precision="highest")
        tk = TR.lookup_corr(pyr, coords, r=r)
        look_err = float((mm - tk).abs().max())
        check(_allclose(mm, tk, 1e-5, 1e-5),
              f"RAFT {variant}: matmul against take lookup {look_err}")
        flow_gap = float((flows["matmul"] - flows["take"]).abs().max())
        print(f"[raft] {variant}: the goldens (128x160, "
              f"{int(z['iters'])} iterations, TF32 off) within "
              f"{stats[f'{variant}_golden_err_matmul']:.3e} (matmul) / "
              f"{stats[f'{variant}_golden_err_take']:.3e} (take) px of "
              f"2e-3 + 1e-2 |golden|; lookups matmul against take "
              f"{look_err:.3e} (limit 1e-5 + 1e-5 |take|), their flows "
              f"{flow_gap:.3e} px apart")

        # Sintel size, 20 iterations
        for batch in (1, 4):
            f1 = torch.from_numpy(video[:batch]).to(dev)
            f2 = torch.from_numpy(video[1:batch + 1]).to(dev)
            f1, pads = TR.pad_to_multiple(f1)
            f2, _ = TR.pad_to_multiple(f2)
            out = {}
            for lk in TR.LOOKUPS:
                for prec in (None, "highest"):
                    call = lambda: TR.raft_flow(params, f1, f2, iters=20,
                                                variant=variant, lookup=lk,
                                                lookup_precision=prec)
                    # the first call autotunes the TF32-off route (its
                    # trial workspaces are not the route's memory)
                    flow = TR.unpad(call(), pads)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    ms = event_ms(call)
                    peak = torch.cuda.max_memory_allocated(dev) - base
                    check(bool(torch.isfinite(flow).all())
                          and flow.shape == (batch, FLOW_H, FLOW_W, 2),
                          f"RAFT {variant} at Sintel size: {flow.shape}")
                    out[(lk, prec)] = (flow, ms, peak)
            for lk in TR.LOOKUPS:
                flow, ms, peak = out[(lk, None)]
                flow_h, ms_h, peak_h = out[(lk, "highest")]
                err = _normwise(flow, flow_h)
                check(err <= 2e-2, f"RAFT {variant} {lk} batch {batch}: "
                                   f"TF32 route {err} from TF32 off")
                stats[f"{variant}_b{batch}_{lk}"] = {
                    "ms_per_pair": ms / batch, "ms_per_pair_tf32_off":
                        ms_h / batch, "peak_gib": peak / 2 ** 30,
                    "peak_gib_tf32_off": peak_h / 2 ** 30,
                    "normwise_vs_tf32_off": err,
                    "max_abs_flow": float(flow_h.abs().max())}
                print(f"[raft] {variant} {FLOW_H}x{FLOW_W} (padded to "
                      f"{f1.shape[1]}x{f1.shape[2]}), 20 iterations, batch "
                      f"{batch}, lookup {lk}: {ms / batch:.2f} ms a pair "
                      f"(TF32 off: {ms_h / batch:.2f}), peak "
                      f"{peak / 2 ** 30:.2f} GiB (TF32 off "
                      f"{peak_h / 2 ** 30:.2f}), default route normwise "
                      f"{err:.3e} from TF32 off (limit 2e-2), max |flow| "
                      f"{float(flow_h.abs().max()):.2f} px; median of 10 "
                      f"after 2 warm-ups, CUDA events, on {card} "
                      f"({smi_line})")
        del params, pyr, fmaps
    check(not torch.backends.cuda.matmul.allow_tf32,
          "RAFT left allow_tf32 on")
    counts = _all_counts()
    check(not any(counts.values()), f"RAFT launched port kernels: {counts}")
    return stats


def phase_pseudo_gt(dev, card: str, smi_line: str, work: str):
    """17. ``flow train --flow-producer raft:<ckpt>@20`` at Sintel size: the
    pseudo-GT cache (its name, 5 ``.flo`` files, flow_scale 1), the probe's
    bounds from the RAFT flow and the launches they dictate, a second run
    that reuses the cache without running RAFT, and the producer's
    pairs/s with the writes."""
    import hashlib
    import os

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data import flow_media as FM
    from sin_inn_tpu_torch.data.flo import read_flo
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models import raft as TR
    from sin_inn_tpu_torch.train import loop as LP

    pairs = FLOW_FRAMES - 1
    ckpt = _raft_ckpt("basic", os.path.join(work, "raft-pgt.pth"))
    spec = f"raft:{ckpt}@20"
    cfg = FlowConfig(device="cuda", checkpoints_dir=os.path.join(work, "ck"),
                     results_dir=os.path.join(work, "results"), name="pgt",
                     epochs=1, flow_producer=spec)
    video = moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W, seed=1)
    scene = "chip_smoke_pgt"
    # the cache name the JAX package gives the same run
    tag = hashlib.sha1(f"{spec}|step=None|end=None".encode()).hexdigest()[:8]
    cache = os.path.join(cfg.checkpoints_dir, "pseudo_gt",
                         f"{scene}_h{FLOW_H}_{tag}")
    names = [f"frame_{i:04d}.flo" for i in range(1, pairs + 1)]

    producer = FM.resolve_producer(spec, device="cuda")
    check(producer.batch_pairs == 4, "the producer's batch_pairs")
    FM.generate_pseudo_gt(video[:5], producer, os.path.join(work, "warm"))
    t0 = time.perf_counter()
    flows = FM.generate_pseudo_gt(video, producer, os.path.join(work, "pgt"))
    pgt_s = time.perf_counter() - t0

    media = FM.FlowMedia(video)
    _reset_all_counts()
    t0 = time.perf_counter()
    out = LP.run_flow_train(cfg, media=media, scene=scene)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _all_counts()
    check(sorted(os.listdir(cache)) == names,
          f"pseudo-GT cache {cache}: {sorted(os.listdir(cache))}")
    check(media.flow_scale == 1.0 and media.flow.shape == (
        pairs, FLOW_H, FLOW_W, 2) and np.array_equal(media.flow, flows),
          "the attached pseudo-GT flow")
    keys = FlowConfig.WINDOW_BOUND_KEYS
    bounds = lambda c: tuple(getattr(c, k) for k in keys)
    probed = LP._resolve_and_probe_splat_bounds(cfg, media, FLOW_H, FLOW_W)
    steps = pairs
    if isinstance(probed.splat_local_dy, int):
        want = dict(splat_region_local=2 * steps,
                    gather_region_local=2 * steps,
                    gather_region_local_grads=4 * steps)
    elif probed.splat_max_dy is not None:
        want = dict(splat_region=2 * steps, gather_region=2 * steps,
                    gather_region_grads=4 * steps)
    else:
        want = {}
    check(isinstance(probed.splat_local_dy, int),
          f"the probe of the RAFT flow left the local windows: "
          f"{bounds(probed)}")
    check_counts(counts, f"pseudo-GT flow train, {steps} steps on the "
                         f"probed bounds {bounds(probed)}",
                 fused_inr_backward=steps, reduce_weight_grads=steps, **want)
    check(out["state"].step == steps
          and all(math.isfinite(v) for v in out["metrics"].values()),
          f"pseudo-GT flow train: step {out['state'].step}, metrics "
          f"{out['metrics']}")
    print(f"[pseudo-GT] producer raft@20 (batch_pairs 4): {pairs} pairs in "
          f"{pgt_s:.3f} s = {pairs / pgt_s:.2f} pairs/s with the .flo "
          f"writes, max |flow| {np.abs(flows[..., 0]).max():.2f} / "
          f"{np.abs(flows[..., 1]).max():.2f} px (x / y), on {card} "
          f"({smi_line})")
    print(f"[pseudo-GT] flow train {steps} steps in {run_s:.2f} s with the "
          f"producer and set-up; cache {os.path.basename(cache)} (5 .flo, "
          f"flow_scale 1); probed bounds (dy, dx, local dy, local dx) "
          f"{bounds(probed)}, after the refit at the save "
          f"{bounds(out['cfg'])}; launches {counts}")

    # a second run on a fresh media: the cache, no RAFT
    calls = []
    real = TR.raft_flow

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    TR.raft_flow = counted
    try:
        media2 = FM.FlowMedia(video)
        _reset_all_counts()
        LP.run_flow_train(cfg.replace(name="pgt2"), media=media2, scene=scene)
        torch.cuda.synchronize()
        counts2 = _all_counts()
    finally:
        TR.raft_flow = real
    check(not calls and np.array_equal(media2.flow, media.flow)
          and media2.flow_scale == 1.0,
          f"the rerun ran RAFT {len(calls)} times")
    check(counts2 == counts, f"the rerun's launches {counts2}")
    for i, n in enumerate(names):
        check(np.array_equal(read_flo(os.path.join(cache, n)), flows[i]),
              f"{n} differs from the producer's flow")
    print(f"[pseudo-GT] a second run reused the cache: {len(calls)} "
          f"raft_flow calls, the same flow and launches")
    add_counts(counts, counts2)
    return counts, {"pairs_per_sec": pairs / pgt_s,
                    "probed": bounds(probed), "refit": bounds(out["cfg"])}


def phase_scene_gather(dev, card: str, smi_line: str):
    """18. The scene-space gather on ``synth_scene(24, 480, 640)``, patch 3:
    the windowed read against the exact gather, the card against the CPU on
    a small scene, times and peak memory of both forms, the drift guard
    silent, no launch of a port kernel."""
    import logging

    from sin_inn_tpu_torch.data.synthetic import synth_scene
    from sin_inn_tpu_torch.scene_space import gather as SG

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.seen = []

        def emit(self, record):
            self.seen.append(record.getMessage())

    guard = Records()
    logging.getLogger(SG.__name__).addHandler(guard)
    _reset_all_counts()
    try:
        n, sh, sw = SCENE
        imgs, depths, poses, bds = synth_scene(n, sh, sw)
        ti = torch.from_numpy(imgs).to(dev)
        td = torch.from_numpy(depths).to(dev)
        stats = {}
        outs = {}
        for window in ("off", "on"):
            call = lambda: SG.gather_scene(ti, td, poses, bds, patch=3,
                                           window=window)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            outs[window] = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            ms = median_ms(call, 5)
            stats[window] = {"ms": ms, "peak_gib": peak / 2 ** 30}
        off, on = outs["off"], outs["on"]
        check(off.shape == (sh, sw, 3) and bool(torch.isfinite(off).all()),
              f"gather output {off.shape}")
        err = float((on - off).abs().max())
        check(_allclose(on, off, 1e-5, 1e-5),
              f"windowed gather against exact: {err}")
        geo = SG._host_window_geometry(poses, bds, sh, sw, 3, 0, 32, 112)
        check(not guard.seen, f"the drift guard warned: {guard.seen}")
        # the card against the CPU on a small scene, side-plane filter off
        # (the reference frame's corner candidates sit on its planes: a sign
        # test at a tie, which two devices may break either way)
        small = synth_scene(4, 64, 224)
        cpu = {w: SG.gather_scene(torch.from_numpy(small[0]),
                                  torch.from_numpy(small[1]), *small[2:],
                                  window=w, _plane_filter=False)
               for w in ("off", "on")}
        gpu_cpu = 0.0
        for w, ref in cpu.items():
            got = SG.gather_scene(torch.from_numpy(small[0]).to(dev),
                                  torch.from_numpy(small[1]).to(dev),
                                  *small[2:], window=w,
                                  _plane_filter=False).cpu()
            gpu_cpu = max(gpu_cpu, float((got - ref).abs().max()))
            check(_allclose(got, ref, 1e-5, 0.0),
                  f"gather {w}: the card against the CPU {gpu_cpu}")
        counts = _all_counts()
        check(not any(counts.values()),
              f"the gather launched port kernels: {counts}")
    finally:
        logging.getLogger(SG.__name__).removeHandler(guard)
    print(f"[scene gather] synth_scene{SCENE}, patch 3: exact "
          f"{stats['off']['ms']:.2f} ms (peak {stats['off']['peak_gib']:.2f}"
          f" GiB), windowed {stats['on']['ms']:.2f} ms (peak "
          f"{stats['on']['peak_gib']:.2f} GiB; K0 {geo['K0']}, KX0 "
          f"{geo['KX0']}); windowed within {err:.3e} of exact (limit 1e-5 "
          f"+ 1e-5 |exact|); drift guard silent; the card within "
          f"{gpu_cpu:.3e} of the CPU on synth_scene(4, 64, 224) (side-plane "
          f"filter off, limit 1e-5); median of 5 after a warm-up, CUDA "
          f"events, on {card} ({smi_line})")
    return stats


DIST_SCENE = (4, 128, 256)     # the launcher's scenes: frames, height, width


def phase_distributed(dev, card: str, smi_line: str, train: dict):
    """19. The parallel package on this card in a world of one, NCCL: the
    data-parallel flagship ``sr train`` step against the non-distributed
    one, its K1-K4 launches and frames/s, and ``run_scenes`` with
    ``aggregate_aepe``. The process group is destroyed at the end."""
    import socket

    import torch.distributed as dist

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inn import flat_params
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.parallel import launcher as PL
    from sin_inn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh)
    from sin_inn_tpu_torch.parallel.sharding import place_batch, place_state
    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import sr as SR

    counts: dict = {}
    stats: dict = {}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    many = initialize_distributed(f"127.0.0.1:{port}", 1, 0, timeout_s=120,
                                  device="cuda")
    try:
        check(not many and dist.is_initialized()
              and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "initialize_distributed: not an NCCL world of one")
        mesh = make_mesh(1, 1)
        check(mesh.shape == {"data": 1, "model": 1} and mesh.primary,
              f"make_mesh(1, 1): {mesh}")
        check(LP.resolve_mesh(None, 1, batch_size=TRAIN_BATCH) is None,
              "resolve_mesh in a world of one is not None")
        init_s = time.perf_counter() - t0

        cfg, batch = train["cfg"], train["batch"]
        b, h, w, _ = batch["lr"].shape
        draws = SR.draw_sr_noise(torch.Generator(device=dev).manual_seed(3),
                                 cfg, b, h, w)
        seed = lambda: torch.Generator(device=dev).manual_seed(21)
        spec, _ = SR.create_train_state(seed(), cfg)
        step_one = SR.make_train_step(spec, cfg)
        step_dp = SR.make_train_step(spec, cfg, mesh)
        params = lambda st: flat_params(st.params)
        diff = lambda a, c: max((x - y).abs().max().item()
                                for x, y in zip(params(a), params(c)))

        # two non-distributed steps from one state, cuDNN's default
        # algorithms: Adam's first step moves a weight by lr g / (|g| +
        # eps), so a weight gradient near 0 summed in another order may
        # move it by up to 2 lr
        one, one2 = (SR.create_train_state(seed(), cfg)[1] for _ in "ab")
        step_one(one, batch, None, draws=draws)
        step_one(one2, batch, None, draws=draws)
        spread = diff(one, one2)
        del one, one2
        # so the comparison takes cuDNN's deterministic algorithms (K1-K4
        # sum in a fixed order)
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            one = SR.create_train_state(seed(), cfg)[1]
            dp = place_state(mesh, SR.create_train_state(seed(), cfg)[1])
            pb = place_batch(mesh, batch)
            aux_one = step_one(one, batch, None, draws=draws)
            K.reset_launch_counts()
            aux_dp = step_dp(dp, pb, None, draws=draws)
            torch.cuda.synchronize()
            run_counts = K.launch_counts()
            lo, ld = aux_one["loss"].item(), aux_dp["loss"].item()
            perr = diff(dp, one)
            # both MMD terms: the N x N kernels over the batch gathered from
            # the data group
            mcfg = cfg.replace(lambda_fwd_mmd=1.0, lambda_bwd_mmd=1.0)
            mmd_one = SR.make_train_step(spec, mcfg)(one, batch, None,
                                                     draws=draws)
            mmd_dp = SR.make_train_step(spec, mcfg, mesh)(dp, pb, None,
                                                          draws=draws)
            mo, md = mmd_one["loss"].item(), mmd_dp["loss"].item()
            mmd_perr = diff(dp, one)
        check_counts(run_counts, "one data-parallel train step",
                     fused_glow_forward_1x1=4, fused_glow_inverse_1x1=4,
                     fused_glow_backward_1x1=4,
                     fused_glow_inverse_backward_1x1=4,
                     reduce_weight_grads=8)
        add_counts(counts, run_counts)
        loss_rel = abs(ld - lo) / abs(lo)
        mmd_rel = abs(md - mo) / abs(mo)
        check(math.isfinite(ld) and loss_rel <= 1e-6,
              f"DP step loss {ld} against {lo}")
        check(perr <= 1e-6, f"DP step params differ by {perr:.3e}")
        check(math.isfinite(md) and mmd_rel <= 1e-6 and mmd_perr <= 1e-6,
              f"DP MMD step: loss {md} against {mo}, params {mmd_perr:.3e}")
        stats.update(loss_rel=loss_rel, param_err=perr, init_s=init_s,
                     mmd_loss_rel=mmd_rel, mmd_param_err=mmd_perr,
                     default_spread=spread)

        def rate(step, state, b_):
            for _ in range(2):
                step(state, b_, None, draws=draws)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                step(state, b_, None, draws=draws)
            torch.cuda.synchronize()
            return 10 * TRAIN_BATCH / (time.perf_counter() - t)

        K.reset_launch_counts()
        stats["dp_fps"] = rate(step_dp, dp, pb)
        stats["one_fps"] = rate(step_one, one, batch)
        torch.cuda.synchronize()
        add_counts(counts, K.launch_counts())
        print(f"[distributed] NCCL world of one up in {init_s:.1f} s; DP "
              f"flagship step against the non-distributed step: loss "
              f"{ld:.7g} vs {lo:.7g} (relative {loss_rel:.3e}, limit 1e-6),"
              f" params within {perr:.3e} (limit 1e-6); with both MMD "
              f"terms loss relative {mmd_rel:.3e}, params within "
              f"{mmd_perr:.3e} (cuDNN deterministic; two non-distributed "
              f"steps on its default algorithms differ by {spread:.3e}); "
              f"launches {run_counts}")
        print(f"[distributed] DP step {stats['dp_fps']:.2f} train frames/s, "
              f"non-distributed {stats['one_fps']:.2f} (phase 5: "
              f"{train['frames_per_sec']:.2f}), batch {TRAIN_BATCH}, HR "
              f"{HR_H}x{HR_W}, on {card} ({smi_line})")
        del one, dp

        # the launcher over two synthetic scenes with GT flow
        n, sh, sw = DIST_SCENE
        rng = np.random.RandomState(9)
        media = {}
        for i, scene in enumerate(("scene_a", "scene_b")):
            gt = np.repeat(rng.uniform(-2, 2, (n - 1, 1, 1, 2)), sh, 1)
            gt = np.repeat(gt, sw, 2).astype(np.float32)
            m = FlowMedia(moving_texture_video(n, sh, sw, seed=11 + i),
                          flow=gt)
            media[scene] = (m, m)
        with tempfile.TemporaryDirectory() as work:
            fcfg = FlowConfig(device="cuda", name="dist", epochs=2,
                              checkpoints_dir=work + "/ck",
                              results_dir=work + "/results",
                              input_video=work + "/scenes/scene_a")
            _reset_all_counts()
            t0 = time.perf_counter()
            results = PL.run_scenes(fcfg, media=media)
            torch.cuda.synchronize()
            scenes_s = time.perf_counter() - t0
        fc = _all_counts()
        aepe = PL.aggregate_aepe(results)
        frames = sum(r.num_frames for r in results)
        want = sum(r.epe * r.num_frames for r in results) / frames
        check([r.scene for r in results] == ["scene_a", "scene_b"]
              and all(r.num_frames == n - 1 for r in results)
              and all(math.isfinite(r.epe) and r.epe > 0 for r in results),
              f"run_scenes results {results}")
        check(abs(aepe - want) <= 1e-12 * max(abs(want), 1.0),
              f"aggregate_aepe {aepe} against the frame-weighted mean {want}")
        check(fc.get("fused_inr_backward", 0) > 0 and
              (fc.get("splat_region", 0) + fc.get("splat_region_local", 0))
              > 0 and (fc.get("gather_region", 0)
                       + fc.get("gather_region_local", 0)) > 0,
              f"run_scenes launched {fc}")
        stats.update(aepe=aepe, scenes_s=scenes_s,
                     epes=[r.epe for r in results])
        print(f"[distributed] run_scenes over 2 synthetic {sh}x{sw} scenes "
              f"({n} frames, GT flow) in {scenes_s:.1f} s: EPEs "
              f"{[round(r.epe, 6) for r in results]}, aggregate_aepe "
              f"{aepe:.6f} = the frame-weighted mean; launches "
              f"{ {k: v for k, v in fc.items() if v} }")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived the phase")
    return counts, fc, stats


CONV_FLOW_ITERS = 300     # phase 20: the JAX record's first milestone
# phase 20's flow init: the port's seed-0 RBF init stays in the zero-flow
# basin of the shift fixture past iteration 300 (EPE 2.10-2.15 from 60 to
# 300 on the kernel and the plain route; it leaves it by 900), and so does
# the JAX package from that same init; seeds 1 and 2 are out of it by 300
# (PERF.md section 6)
CONV_FLOW_SEED = 1
CONV_SR_EPOCHS = 120      # phase 20: the SR flagship's epochs


def _validate_tool():
    """``tools/validate_torch.py``, loaded by its path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "validate_torch.py")
    spec = importlib.util.spec_from_file_location("validate_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_convergence(dev, card: str, smi_line: str):
    """20. Short convergence runs of ``tools/validate_torch.py`` on the
    kernel route: the flow shift (RBF from seed ``CONV_FLOW_SEED``, static
    windows, 436x1024, 3 pairs a step) for 300 iterations, EPE from >= 1.5
    px to <= 0.10 px, one step's
    launches K5 2, K6 2, K6 grads 4, K7 backward 1 (and its reduction);
    then the SRF flagship (360x640, batch 8) for ``CONV_SR_EPOCHS``
    epochs, its loss falling from the first milestone to the last and its
    val HR-PSNR rising by >= 0.4 dB, one step's launches K1-K4 4 each (and
    8 reductions). Returns the flow and SR runs' launches and results."""
    import io

    V = _validate_tool()
    quiet = io.StringIO()      # the milestone lines; printed below instead
    _reset_all_counts()
    flow = V.validate_flow(CONV_FLOW_ITERS, seed=CONV_FLOW_SEED,
                           device=str(dev), out=quiet)
    flow_counts = _all_counts()
    check_counts({k: flow["launches"].get(k, 0) for k in flow_counts},
                 "one flow shift train step (static windows)",
                 splat_region=2, gather_region=2, gather_region_grads=4,
                 fused_inr_backward=1, reduce_weight_grads=1)
    check_counts(flow_counts, f"the flow run ({CONV_FLOW_ITERS + 1} steps)",
                 **{k: (CONV_FLOW_ITERS + 1) * v
                    for k, v in flow["launches"].items()})
    traj = ", ".join(f"{i}: {e:.4f}" for i, e in
                     zip(flow["milestone_iters"], flow["epe_traj"]))
    print(f"[convergence] flow shift, RBF (seed {CONV_FLOW_SEED}), static "
          f"windows, "
          f"{FLOW_H}x{FLOW_W}, 3 pairs a step: EPE {flow['epe0']:.4f} at "
          f"the first step, then by iteration {traj}; "
          f"{flow['frames_per_sec']:.2f} pairs/s, {flow['wall_s']} s; one "
          f"step's launches {flow['launches']}; on {card} ({smi_line})")
    check(flow["epe0"] >= 1.5, f"flow: initial EPE {flow['epe0']} < 1.5 "
                               "(the fixture or the init changed)")
    check(flow["epe"] <= 0.10, f"flow: EPE {flow['epe']} at iteration "
                               f"{CONV_FLOW_ITERS} > 0.10")
    _reset_all_counts()
    sr = V.validate_sr(CONV_SR_EPOCHS, device=str(dev), out=quiet)
    sr_counts = _all_counts()
    check_counts({k: sr["launches"].get(k, 0) for k in sr_counts},
                 "one SR train step", fused_glow_forward_1x1=4,
                 fused_glow_inverse_1x1=4, fused_glow_backward_1x1=4,
                 fused_glow_inverse_backward_1x1=4, reduce_weight_grads=8)
    loss, psnr = sr["loss_traj"], sr["psnr_traj"]
    print(f"[convergence] SR SRF 4x flagship, 360x640, batch 8, "
          f"{CONV_SR_EPOCHS} epochs ({sr['steps']} steps) in "
          f"{sr['wall_s']} s: loss {[round(x, 4) for x in loss]}, val "
          f"HR-PSNR {[round(x, 2) for x in psnr]} dB (band of the full run: "
          f"{sr['within_band']}); one step's launches {sr['launches']}; on "
          f"{card} ({smi_line})")
    check(all(map(math.isfinite, loss + psnr)), "SR: a non-finite milestone")
    check(loss[-1] < loss[0], f"SR: loss {loss[0]} -> {loss[-1]} did not "
                              "fall")
    check(psnr[-1] - psnr[0] >= 0.4, f"SR: val HR-PSNR {psnr[0]:.3f} -> "
                                     f"{psnr[-1]:.3f} rose by < 0.4 dB")
    return flow_counts, sr_counts, {"flow": flow, "sr": sr}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # phase 5's checkpoints stay here until phase 13 exports them
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        card, smi_line = phase_card()
        phase_build()
        rows, bf16_err = phase_kernels(dev)
        train_rows, bwd_bf16_err = phase_train_kernels(dev)
        counts, fps = phase_path(dev, card)
        train_counts, train = phase_train(dev, card, smi_line, work)
        flow_rows = phase_flow_kernels(dev)
        flow = phase_flow(dev, card, smi_line)
        ft_rows = phase_flow_train_kernels(dev)
        ft_counts, ft = phase_flow_train(dev, card, smi_line)
        prog_rows = phase_prog_kernels(dev)
        prog_counts, prog = phase_prog_path(dev, card, smi_line)
        k8_rows, k8_serve_rows, k8_counts = phase_k8(dev, card, smi_line)
        irn = phase_irn_exchange(dev, card, smi_line, train["cfg"])
        tool_counts, tools = phase_sr_tooling(dev, card, smi_line, work)
        fx_counts, fx = phase_flow_exchange(dev, card, smi_line)
        raft = phase_raft(dev, card, smi_line, work)
        pgt_counts, pgt = phase_pseudo_gt(dev, card, smi_line, work)
        scene = phase_scene_gather(dev, card, smi_line)
        dist_counts, dist_flow_counts, dist = phase_distributed(
            dev, card, smi_line, train)
        conv_flow_counts, conv_sr_counts, conv = phase_convergence(
            dev, card, smi_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    add_counts(counts, train_counts)
    add_counts(counts, tool_counts)
    add_counts(counts, dist_counts)
    add_counts(counts, conv_sr_counts)
    flow_counts = dict(flow["counts"])
    add_counts(flow_counts, dist_flow_counts)
    add_counts(flow_counts, ft_counts)
    add_counts(flow_counts, prog_counts)
    add_counts(flow_counts, fx_counts)
    add_counts(flow_counts, pgt_counts)
    add_counts(flow_counts, conv_flow_counts)
    kernels = []
    for n in COUPLING:
        # K1/K2: the eval/infer shapes (batch 40), as before, with the
        # training shapes beside them; K3/K4: the training shapes
        # bound by their work as run: every product three TF32 products on
        # the tensor cores (the fp32 rate's bound beside it)
        rs = rows.get(n) or train_rows[n]
        bytes_ms = sum(r["bytes_bound_ms"] for r in rs)
        ops_ms = sum(r["tf32x3_bound_ms"] for r in rs)
        entry = {
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": REPLACES[n], "launches": counts[n],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "fp32_bound_ms": sum(r["fp32_bound_ms"] for r in rs),
            "library_ms": None,
            "shapes": rs,
        }
        if rows.get(n):
            entry["train_shapes"] = train_rows[n]
        else:
            entry["reduce_launches"] = counts["reduce_weight_grads"]
            entry["reduce_ms"] = sum(r["reduce_ms"] for r in rs)
        kernels.append(entry)
    # K5, K6 (static and local): launches of the interpolation and the flow
    # train runs; K6 grads (static and local, both payload widths summed) and
    # K7 backward (the RBF net, the path's): launches of the flow train runs
    flow_shapes = {n: [r] for n, r in flow_rows.items()}
    flow_shapes["gather_region_grads"] = ft_rows["gather_region_grads"]
    flow_shapes["gather_region_local_grads"] = ft_rows[
        "gather_region_local_grads"]
    # K7: the rows of the paths' own modes (backward: the RBF net's constant
    # mask and PFF's slabs; forward: PFF's slabs), the others beside them
    slab = lambda rows: [r for r in rows if (r["net"], r["mode"]) ==
                         ("PFF", "slab")]
    flow_shapes["fused_inr_backward"] = (
        ft_rows["fused_inr_backward"][:1]
        + slab(prog_rows["fused_inr_backward"]))
    flow_shapes["fused_inr_forward"] = slab(prog_rows["fused_inr_forward"])
    for n, rs in flow_shapes.items():
        bytes_ms = sum(r["bytes_bound_ms"] for r in rs)
        ops_ms = sum(r["ops_bound_ms"] for r in rs)
        lib = [r["library_ms"] for r in rs]
        kernels.append({
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": REPLACES[n], "launches": flow_counts[n],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in lib else sum(lib), "shapes": rs})
        if n in ("fused_inr_backward", "fused_inr_forward"):
            # bound by its products as it runs them (3xTF32), the fp32
            # rate's bound beside it
            kernels[-1]["fp32_bound_ms"] = sum(r["fp32_bound_ms"]
                                               for r in rs)
        if n in ("splat_region", "splat_region_local"):
            kernels[-1]["scratch_bytes"] = rs[0]["scratch_bytes"]
    # K8: the four 3x3 couplings' module path at batch 8 (launches), each
    # octave's half timed at batch 8, the batch-40 rows beside them
    for n, rs in k8_rows.items():
        bytes_ms = sum(r["bytes_bound_ms"] for r in rs)
        ops_ms = sum(r["ops_bound_ms"] for r in rs)
        entry = {
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": REPLACES[n],
            "launches": k8_counts["half_coupling_3x3" if n == "K8 fwd"
                                  else "half_coupling_3x3_backward"],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "fp32_bound_ms": sum(r["fp32_bound_ms"] for r in rs),
            "library_ms": None, "shapes": rs}
        if n == "K8 fwd":
            entry["serve_shapes"] = k8_serve_rows
        kernels.append(entry)
    by_name = {k["name"]: k for k in kernels}
    by_name["fused_inr_backward"]["other_nets"] = (
        ft_rows["fused_inr_backward"][1:]
        + [r for r in prog_rows["fused_inr_backward"]
           if r not in slab(prog_rows["fused_inr_backward"])])
    by_name["fused_inr_forward"]["other_modes"] = [
        r for r in prog_rows["fused_inr_forward"]
        if r not in slab(prog_rows["fused_inr_forward"])]
    print(f"[flow] flow test {flow['test_fps']:.2f} frames/s (pairs), "
          f"on {card} ({smi_line})")
    print(f"[flow] interpolation {flow['interp_fps']:.2f} mid-frames/s, "
          f"on {card} ({smi_line})")
    print(f"[flow train] {ft['kernel']['pairs_per_sec']:.2f} pairs/s on the "
          f"local windows (static windows: {ft['static']['pairs_per_sec']:.2f}"
          f", use_kernel='off': {ft['off']['pairs_per_sec']:.2f}), on {card} "
          f"({smi_line})")
    print(f"[prog path] PFF spatial {prog['kernel']['pairs_per_sec']:.2f} "
          f"pairs/s (use_kernel='off': {prog['off']['pairs_per_sec']:.2f}), "
          f"PFF linear {prog['linear_pairs_per_sec']:.2f} pairs/s, flow test "
          f"{prog['test_fps']:.2f} pairs/s, on {card} ({smi_line})")
    busy = lambda t: 100 * t[1] / t[0]
    print(f"[prog path] PFF spatial: a pair {prog['pair_ms']:.3f} ms, a "
          f"mid-frame {prog['mid_frame_ms']:.3f} ms, a train step "
          f"{prog['kernel']['step_ms']:.2f} ms; device busy "
          f"{busy(prog['pair_busy']):.1f}% / "
          f"{busy(prog['mid_frame_busy']):.1f}% / "
          f"{busy(prog['kernel']['busy']):.1f}% of the traced wall time, on "
          f"{card} ({smi_line})")
    print(f"[irn] IRN flagship {irn['train_frames_per_sec']:.2f} train "
          f"frames/s, {irn['ms_per_step']:.2f} ms/step, sr test "
          f"{irn['test_frames_per_sec']:.2f} frames/s, on {card} "
          f"({smi_line})")
    bp = tools["batch_probe"]
    print(f"[sr tools] find_batch_size: batch {bp['batch']} (peak "
          f"{bp['peak_bytes'] / 2 ** 30:.2f} GiB, {bp['seconds']:.1f} s); "
          f"find_lr: {tools['find_lr']['lr']:g} in "
          f"{tools['find_lr']['seconds']:.2f} s; on {card} ({smi_line})")
    print(f"[flow exchange] sintel {fx['sintel_pairs_per_sec']:.2f} pairs/s "
          f"(PFF spatial, with the .flo writes), AEPE {fx['aepe']:.6f}, on "
          f"{card} ({smi_line})")
    r = raft["basic_b4_matmul"]
    print(f"[raft] basic {FLOW_H}x{FLOW_W}, 20 iterations, batch 4, matmul "
          f"lookup: {r['ms_per_pair']:.2f} ms a pair, peak "
          f"{r['peak_gib']:.2f} GiB; small "
          f"{raft['small_b4_matmul']['ms_per_pair']:.2f} ms a pair; "
          f"pseudo-GT producer {pgt['pairs_per_sec']:.2f} pairs/s with the "
          f"writes (probed bounds {pgt['probed']}); scene gather exact "
          f"{scene['off']['ms']:.2f} ms, windowed {scene['on']['ms']:.2f} "
          f"ms; on {card} ({smi_line})")
    print(f"[distributed] DP flagship step {dist['dp_fps']:.2f} train "
          f"frames/s beside phase 5's {train['frames_per_sec']:.2f}; "
          f"launcher AEPE {dist['aepe']:.6f}; on {card} ({smi_line})")
    print(f"[convergence] flow EPE {conv['flow']['epe0']:.4f} -> "
          f"{conv['flow']['epe']:.4f} in {CONV_FLOW_ITERS} iterations; SR "
          f"loss {conv['sr']['loss_traj'][0]:.4f} -> "
          f"{conv['sr']['loss_traj'][-1]:.4f}, val HR-PSNR "
          f"{conv['sr']['psnr_traj'][0]:.2f} -> "
          f"{conv['sr']['psnr_traj'][-1]:.2f} dB; on {card} ({smi_line})")
    print(f"[done] sr test {fps:.2f} frames/s; train "
          f"{train['frames_per_sec']:.2f} frames/s; bf16 err {bf16_err:.3e}"
          f" (K3 {bwd_bf16_err:.3e}); total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
