"""``flow train``: the program's flow train step (``train/flow.py``
``make_flow_train_step``), fed as ``train/loop.py`` ``run_flow_train``
feeds it.

Set-up makes the clip and its GT flow on the device, hands them to the
program's media (``data/flow_media.py``), resolves the window bounds as the
loop does (the program's GT-flow probe; the configuration states the exact
splat and warp, so they resolve off), pins the frame-pair batches on the
device and builds the train state from the benchmark's weights. Each epoch
replays the batches in a seeded permutation, as the loop does. The first
three steps, on three batches of different pairs, are the checked ones. Of
those batches only the indices of their pairs are taken from the program's
media: the reference builds each pair itself from the clip, made again
from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cost import flow_train_step_flops
from harness import synth
from harness.compare import first_moment as _first_moment
from harness.compare import training_numbers
from harness.core import Phases, sub_seed
from harness.weights import inr_weights

CHECKED_STEPS = 3
# the first layer's weight gradient has a row per encoding centre, and a
# centre's row sums the pixels near it: its median row stays clear of the
# few pixels whose splat targets sit on a pixel centre, which swing the
# worst leaf with float32's rounding (PERF.md)
ROWS_OF = "mlp0.w"

FLOW_KEYS = ("net", "domain_dim", "num_frequencies", "std_rbf", "num_layers",
             "hidden_dim", "output_channels", "lr", "loss_l1", "loss_census",
             "loss_ssim", "census_width", "loss_smooth1", "edge_constant",
             "edge_func", "occl", "occl_thresh", "compute_dtype",
             "splat_max_dy", "splat_max_dx", "splat_local_dy", "splat_local_dx",
             "window_refit")


def flow_config(c: Dict, device, **kw):
    from sin_inn_tpu_torch.core.config import FlowConfig
    return FlowConfig(**{k: c[k] for k in FLOW_KEYS if k in c},
                      size=c["height"], test_size=c["height"],
                      device=str(device), use_kernel="auto", **kw)


def make_clip(config: Dict, traffic: Dict, seed: int, device):
    """The benchmark's clip and its GT flow, on the device."""
    return synth.flow_clip(traffic["frames"], config["height"],
                           config["width"], sub_seed(seed, "clip"), device,
                           traffic["motion"])


def make_media(config: Dict, traffic: Dict, seed: int, device):
    """The program's media of the benchmark's clip."""
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    video, flow = make_clip(config, traffic, seed, device)
    return FlowMedia(video.cpu().numpy(), flow.cpu().numpy())


def program_spec(cfg):
    """The program's INR spec of the config (its weights are discarded:
    the benchmark hands the program its own)."""
    from sin_inn_tpu_torch.models.inr import build_inr
    spec, _, _ = build_inr(torch.Generator().manual_seed(0), cfg.net, cfg,
                           "cpu")
    return spec


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        from sin_inn_tpu_torch.train import flow as FT
        from sin_inn_tpu_torch.train import loop

        c, t = self.config, self.traffic
        self.phases = ph = Phases(self.device)
        media = make_media(c, t, self.seed, self.device)
        ph.mark("clip")
        fh, fw = media.video.shape[1:3]
        cfg = flow_config(c, self.device, batch=t["batch"])
        self.cfg = loop._resolve_and_probe_splat_bounds(cfg, media, fh, fw)
        ph.mark("window_probe")
        self.cached = [loop._to_device_batch(b, self.device)
                       for b in media.batches(self.cfg.batch)]
        # the pairs of each batch, in media.batches' unshuffled order
        bs, n = self.cfg.batch, len(media)
        self.pairs = [list(range(j, min(j + bs, n))) for j in range(0, n, bs)]
        del media
        ph.mark("batches")
        self.spec = program_spec(self.cfg)
        ph.mark("spec")
        params, self.consts, self.named = inr_weights(
            c, sub_seed(self.seed, "weights"), self.device)
        ph.mark("weights")
        self.state = FT.train_state(params, self.cfg)
        self.step = FT.make_flow_train_step(self.spec, self.cfg)
        self.rng = np.random.RandomState(sub_seed(self.seed, "order") % 2**32)
        self.order: List[int] = []
        ph.mark("state")

        self.p0 = {n: v.detach().clone() for n, v in self.named.items()}
        self.checked: List[List[int]] = []
        losses = []
        leaves = {n: v for n, v in self.named.items() if n.startswith("mlp")}
        for i in range(CHECKED_STEPS):
            if not self.order:
                self._reorder()
            self.checked.append(self.pairs[self.order[0]])
            batch = self._next()
            m = self.step(self.state, self.consts, batch)
            losses.append(m["loss"].detach().clone())
            if i == 0:
                st = self.state.optimizer.state
                self.g1 = {n: _first_moment(st, v) / (1.0 - 0.9)
                           for n, v in leaves.items()}
                self.p1 = {n: v.detach().clone() for n, v in leaves.items()}
        self.p3 = {n: v.detach().clone() for n, v in leaves.items()}
        self.losses = [float(x) for x in losses]
        ph.mark("checked_steps")
        for _ in range(t["warm_steps"]):
            self.unit()
        ph.mark("warm_steps")

    def _reorder(self) -> None:
        self.order = list(self.rng.permutation(len(self.cached)))

    def _next(self) -> Dict:
        if not self.order:
            self._reorder()
        return self.cached[self.order.pop(0)]

    def unit(self) -> int:
        batch = self._next()
        self.step(self.state, self.consts, batch)
        return int(batch["times"].shape[0])

    def model_flops(self, units: int) -> float:
        c = self.config
        return flow_train_step_flops(c, 1, c["height"], c["width"]) * units

    def release(self) -> None:
        del self.state, self.step, self.named
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str = "fp32", keep: int = None):
        """As ``sr_train``'s: the reference over the checked batches, which
        it builds from the clip (their first ``keep`` pairs where given)."""
        from reference import flow
        from reference.precision import strict_fp32
        video, _ = make_clip(self.config, self.traffic, self.seed,
                             self.device)
        batches = [flow.pair_batch(video, pairs[:keep])
                   for pairs in self.checked]
        del video
        with strict_fp32():
            return flow.train_steps(self.p0, self.config, batches, prec)

    def numbers(self, prog, ref):
        return training_numbers(self.p0, prog, ref, rows_of=ROWS_OF)

    def check(self):
        return self.numbers((self.losses, self.g1, self.p1, self.p3),
                            self.reference())
