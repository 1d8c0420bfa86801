#!/usr/bin/env python3
"""Times the fused INR backward kernel (K7 backward) of one checkout of the
port on one card, so that two checkouts can be compared inside one call.

    PYTHONPATH=CHECKOUT python3 tools/time_inr_backward.py [LABEL]

Builds ``csrc/inr_bwd.cu`` of the ``sin_inn_tpu_torch`` package found on
``PYTHONPATH``, prints the registers ptxas gave each instantiation (of the
single kernel of the version before the staged one, or of the staged
version's prep, row-product and weight-stage kernels), and the
median, least and largest time of 10 launches (CUDA events, after a
warm-up, with the gradient reduction) at N = 446,464 points (the 436x1024
pose grid) for the ``RBF`` and ``FFN`` nets at default widths (constant
mask, fp32 and bf16 operands) and, where the checkout has the per-point
mask modes, for ``PFF`` in slab mode. Run a parent checkout (``git archive``
into a git-ignored directory) and the working tree in turns: parent, change,
change, parent.
"""

from __future__ import annotations

import math
import re
import statistics
import sys

import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.models.inr import build_inr
from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.cuda import inr as K7
from sin_inn_tpu_torch.train import flow as FT

H, W = 436, 1024


def median_ms(fn, reps: int = 10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_inr_backward: needs a CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    built = _build.build_all(["inr_bwd", "coupling_1x1_bwd"])
    # the single kernel of the parent's version, or the staged one's prep,
    # row product and weight-stage kernels
    found = re.findall(r"(inr_bwd_kernel|prep_kernel|row_gemm_kernel|"
                       r"weight_stage_kernel)I((?:L[bi]\d+E)+)[^\n]*\n"
                       r"[^\n]*\n[^\n]*Used (\d+) registers",
                       built["inr_bwd"].log)
    for kernel, instantiation, registers in found:
        print(f"{label} registers {kernel} {instantiation}: {registers}")
    pts = FT.pose_grid(torch.tensor([0.2], device=dev), H,
                       W).reshape(-1, 3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(8)
    mix = torch.randn((3, 4), generator=gen, device=dev)
    g = (1e-3 * (0.5 + torch.sin(2.0 * math.pi * (pts @ mix)))).contiguous()

    def report(net, mode, kind, enc, layers, mask):
        for bf16 in (False, True):
            med, lo, hi = median_ms(lambda: K7.fused_inr_backward(
                kind, enc, layers, pts, mask, g, bf16))
            print(f"{label} {net} {mode} bf16={bf16}: median {med:.2f} ms "
                  f"(min {lo:.2f}, max {hi:.2f})")

    def net_of(name):
        spec, params, consts = build_inr(
            R.named_fold(R.root_generator(8), "init"), name,
            FlowConfig(net=name, device="cuda"), dev)
        return spec, consts["enc"], [(l["w"], l["b"]) for l in params["mlp"]]

    for name, kind in (("RBF", "rbf"), ("FFN", "ff")):
        _, enc, layers = net_of(name)
        report(name, "const", kind, enc, layers, torch.ones(512, device=dev))
    if hasattr(K7, "fused_inr_forward"):
        from sin_inn_tpu_torch.models import controllers as C

        spec, enc, layers = net_of("PFF")
        ccfg = C.SpatialConfig.create(spec, 50, block_iterations=8)
        state = C.spatial_init(ccfg, dev)._replace(mask=torch.rand(
            (ccfg.cells, ccfg.encoding_dim), generator=gen, device=dev))
        slabs = C.spatial_grid_mask_slabs(
            ccfg, state, torch.tensor([0.2], device=dev), H, W)
        report("PFF", "slab", "ff", enc, layers, slabs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
