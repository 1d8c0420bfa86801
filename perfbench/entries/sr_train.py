"""``sr train``: the program's SR train step (``train/sr.py``
``make_train_step``), fed as ``train/loop.py`` ``run_sr_train`` feeds it.

Set-up makes the HR video and its LR stream on the device, hands them to
the program's dataset (``data/sr_video.py``), which pins every supervised
batch on the device, and builds the train state from the benchmark's
weights. The step's latent z is drawn on the device from the run's seed and
handed to the step (its ``draws``), so that the reference can take the same
one. The batches are replayed in order, epoch after epoch, as the loop
replays them. The first three steps, on three batches of different
windows, are the checked ones; more warm-up steps follow before the
window. Of the checked batches only their windows' centre frames are taken
from the program's dataset: the reference builds each window itself from
the video, made again from the seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from cost import srf_step_flops
from harness import synth
from harness.compare import first_moment as _first_moment
from harness.compare import training_numbers
from harness.core import Phases, sub_seed
from harness.weights import srf_weights

CHECKED_STEPS = 3

SR_KEYS = ("scale", "lr_window", "num_coupling", "clamp_srf",
           "hidden_channels", "fps", "batch_size", "learning_rate",
           "adam_betas", "weight_decay", "lambda_fwd_rec", "lambda_bwd_rec",
           "lambda_fwd_mmd", "lambda_bwd_mmd", "lambda_latent_nll",
           "lambda_bwd_tcr", "compute_dtype", "architecture")


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        from sin_inn_tpu_torch.core.config import SRConfig
        from sin_inn_tpu_torch.data.sr_video import SRVideo, make_datasets
        from sin_inn_tpu_torch.models.inn import build_inn_spec
        from sin_inn_tpu_torch.train import sr as SR

        c, t = self.config, self.traffic
        self.phases = ph = Phases(self.device)
        kw = {k: c[k] for k in SR_KEYS if k in c}
        kw["adam_betas"] = tuple(kw.get("adam_betas", (0.9, 0.99)))
        self.cfg = SRConfig(**kw, device=str(self.device), use_kernel="auto")
        hr, lr = self._video()
        ph.mark("video")
        video = SRVideo(lr=lr.cpu().numpy(), hr=hr.cpu().numpy())
        del hr, lr
        sup, _, _ = make_datasets(video, self.cfg)
        self.cached = sup.device_cache(self.cfg.batch_size, self.device)
        self.centres = np.asarray(sup.indices)
        ph.mark("dataset")
        spec, _ = build_inn_spec(self.cfg, c=3)
        params, self.named = srf_weights(c, sub_seed(self.seed, "weights"),
                                         self.device)
        self.state = SR.train_state(params, self.cfg)
        self.step = SR.make_train_step(spec, self.cfg)
        self.draws = SR.SRDraws
        self.zgen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, "z"))
        self.k = 0
        ph.mark("state")

        # the checked steps: the window's own call and feed, from the start
        self.p0 = {n: v.detach().clone() for n, v in self.named.items()}
        self.checked: List[Tuple[np.ndarray, torch.Tensor]] = []
        losses = []
        beta1 = self.cfg.adam_betas[0]
        bs = self.cfg.batch_size
        for i in range(CHECKED_STEPS):
            nb = self.k % len(self.cached)
            batch, z = self._next()
            aux = self.step(self.state, batch, None, draws=self.draws(z))
            self.checked.append((self.centres[nb * bs:(nb + 1) * bs], z))
            losses.append(aux["loss"].detach().clone())
            if i == 0:
                st = self.state.optimizer.state
                self.g1 = {n: _first_moment(st, v) / (1.0 - beta1)
                           for n, v in self.named.items()}
                self.p1 = {n: v.detach().clone()
                           for n, v in self.named.items()}
        self.p3 = {n: v.detach().clone() for n, v in self.named.items()}
        self.losses = [float(x) for x in losses]
        ph.mark("checked_steps")
        for _ in range(t["warm_steps"]):
            self.unit()
        ph.mark("warm_steps")

    def _video(self):
        c, t = self.config, self.traffic
        return synth.sr_video(t["frames"], c["hr_height"], c["hr_width"],
                              c["scale"], sub_seed(self.seed, "video"),
                              self.device, velocity=t["velocity"])

    def _next(self):
        batch = self.cached[self.k % len(self.cached)]
        b, h, w, _ = batch["lr"].shape
        z = torch.randn((b, h, w, self.cfg.z_dims), generator=self.zgen,
                        device=self.device)
        self.k += 1
        return batch, z

    def unit(self) -> int:
        batch, z = self._next()
        self.step(self.state, batch, None, draws=self.draws(z))
        return int(batch["hr"].shape[0])

    def model_flops(self, units: int) -> float:
        b = self.cfg.batch_size
        return srf_step_flops(self.config, b) * units / b

    def release(self) -> None:
        del self.state, self.step, self.named
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, keep: int = None):
        """The reference's losses, first gradient and weights after the
        first and the last checked step, from the same weights and latents
        and the same windows, which it builds from the video (of each batch
        only its first ``keep`` rows where given)."""
        from reference import srf
        from reference.precision import strict_fp32
        rows = slice(0, keep)
        hr, lr = self._video()
        batches = [srf.window_batch(hr, lr, idx[rows],
                                    self.config["lr_window"])
                   for idx, _ in self.checked]
        del hr, lr
        with strict_fp32():
            return srf.train_steps(self.p0, self.config, batches,
                                   [z[rows] for _, z in self.checked])

    def numbers(self, prog, ref):
        return training_numbers(self.p0, prog, ref)

    def check(self):
        return self.numbers((self.losses, self.g1, self.p1, self.p3),
                            self.reference())
