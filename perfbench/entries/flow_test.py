"""``flow test``: the program's ``train/loop.py`` ``flow_test_outputs``,
the flows and Wang occlusion masks of every pair of the clip back in host
memory (and the program's EPE against the GT), ``test_batch`` pairs a
query, pass after pass.

Set-up makes the clip and its GT flow on the device and hands them to the
program's media; the weights are seeded, not trained. One pass warms every
shape. The answers checked are the flows and masks of every pair of the
window's last pass and of pairs drawn from the seed of every other pass.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from cost import flow_query_flops
from entries.flow_train import flow_config, make_media, program_spec
from harness.core import Phases, sub_seed
from harness.weights import inr_weights


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        from sin_inn_tpu_torch.train import loop
        c, t = self.config, self.traffic
        self.phases = ph = Phases(self.device)
        self.media = make_media(c, t, self.seed, self.device)
        ph.mark("clip")
        self.cfg = flow_config(c, self.device, test_batch=t["test_batch"])
        self.spec = program_spec(self.cfg)
        self.params, self.consts, self.named = inr_weights(
            c, sub_seed(self.seed, "weights"), self.device)
        self.run_pass = lambda: loop.flow_test_outputs(
            self.cfg, self.media, self.spec, self.params, self.consts)
        self.samples: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.passes = 0
        ph.mark("state")
        for _ in range(t["warm_passes"]):
            self.run_pass()
        ph.mark("warm_passes")

    def unit(self) -> int:
        out = self.run_pass()
        n = out["flow12"].shape[0]
        pick = np.random.RandomState(
            sub_seed(self.seed, f"pass{self.passes}") % 2**32).choice(
                n, self.traffic["sample_pairs"], replace=False)
        self.samples += [(int(i), out["flow12"][i].copy(),
                          out["masks"][i].copy()) for i in pick]
        self.last = out
        self.passes += 1
        return n

    def model_flops(self, units: int) -> float:
        c = self.config
        return flow_query_flops(c, 1, c["height"], c["width"]) * units

    def release(self) -> None:
        del self.params, self.run_pass
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str = "fp32"):
        """(flow12, mask) of every pair of the clip, on the device."""
        from reference import flow
        from reference.precision import strict_fp32
        c = self.config
        h, w = c["height"], c["width"]
        times = torch.from_numpy(flow.clip_times(self.traffic["frames"])).to(
            self.device)
        flows, masks = [], []
        with strict_fp32(), torch.no_grad():
            for i in range(self.traffic["frames"] - 1):
                f12, f21 = flow.query(self.named, times[i:i + 1], h, w,
                                      w / 5.0, prec)
                flows.append(f12[0])
                masks.append(flow.occlusion_wang(f21, c["occl_thresh"])[0])
        return flows, masks

    def numbers(self, flows, masks, samples):
        """``flow_gap``: the largest normwise gap of a checked pair's flow;
        ``flow_max_gap``: the largest gap of one pixel's flow vector, over
        the root mean square of its pair's reference flow; ``mask_flips``:
        the most pixels of one checked pair whose mask differs."""
        flow_gap, max_gap, flips = 0.0, 0.0, 0
        for i, f, m in samples:
            ref = flows[i]
            d = torch.from_numpy(f).to(ref.device) - ref
            flow_gap = max(flow_gap, float(torch.linalg.norm(d)
                                           / torch.linalg.norm(ref)))
            rms = torch.sqrt((ref * ref).sum(-1).mean())
            max_gap = max(max_gap, float(torch.linalg.norm(d, dim=-1).max()
                                         / rms))
            flips = max(flips, int((torch.from_numpy(m).to(ref.device)
                                    != masks[i]).sum()))
        return [("flow_gap", flow_gap), ("flow_max_gap", max_gap),
                ("mask_flips", flips)]

    def check(self):
        """Every pair of the window's last pass, and the pairs drawn from
        the seed of every other pass."""
        flows, masks = self.reference()
        last = [(i, self.last["flow12"][i], self.last["masks"][i])
                for i in range(self.last["flow12"].shape[0])]
        return self.numbers(flows, masks, self.samples + last)
