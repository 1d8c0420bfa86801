"""Single-image-pair optical flow experiment, on the PyTorch port.

The port's counterpart of ``examples/pair_flow.py``: fit a 2-D progressive
RBF INR to ONE frame pair with the flow pipeline's photometric loss stack,
report the loss, PSNR (and EPE where the frames have GT flow), and write
the flow as a Middlebury-coloured PNG. A plain loop over the train step of
``sin_inn_tpu_torch/train/flow.py``.

Usage:
    python examples/pair_flow_torch.py --frames dir_with_frame_%04d.png \\
        --index 28 --epochs 1000 [--net PRBF] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pair_config(net: str, epochs: int, device: str):
    """The pair experiment's config: a 2-D (y, x) domain with wide RBF and
    Fourier widths, LR 1e-3, L1 + census + smoothness."""
    from sin_inn_tpu_torch.core.config import FlowConfig

    return FlowConfig(net=net, domain_dim=2, std_rbf=50.0, std=50.0,
                      epochs=epochs, lr=1e-3, loss_l1=1.0, loss_census=0.1,
                      loss_smooth1=0.1, device=device)


def pair_batch(sample: Dict[str, np.ndarray], device) -> Dict:
    """One frame pair of ``FlowMedia.sample`` on ``device``; the single
    pair's time coordinate collapses to t = 0."""
    import torch

    batch = {"frame1": torch.from_numpy(sample["frame1"]).to(device),
             "frame2": torch.from_numpy(sample["frame2"]).to(device),
             "times": torch.zeros((1,), dtype=torch.float32, device=device),
             "scale": float(sample["scale"])}
    if "gt_flow" in sample:
        batch["gt_flow"] = torch.from_numpy(sample["gt_flow"]).to(device)
    return batch


def fit_pair(cfg, batch: Dict, epochs: int, params=None, consts=None,
             log: Optional[Callable[[str], None]] = print):
    """Train the config's INR on one pair for ``epochs`` steps, from
    ``params`` / ``consts`` where given (else drawn from seed 0). Returns
    (spec, state, consts, history), history holding each step's loss."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.device import resolve_device
    from sin_inn_tpu_torch.train import flow as FT

    device = resolve_device(cfg.device)
    spec, p0, c0, ctrl_cfg, ctrl_state = FT.build_flow_model(
        R.named_fold(R.root_generator(0), "init"), cfg, device)
    params = p0 if params is None else params
    consts = c0 if consts is None else consts
    state = FT.train_state(params, cfg, ctrl_cfg=ctrl_cfg,
                           ctrl_state=ctrl_state)
    step = FT.make_flow_train_step(spec, cfg)
    history: List[float] = []
    for epoch in range(epochs):
        m = step(state, consts, batch)
        history.append(float(m["loss"]))
        if log is not None and (epoch + 1) % max(epochs // 10, 1) == 0:
            msg = (f"epoch {epoch + 1}: loss {float(m['loss']):.4f} "
                   f"psnr {float(m['psnr']):.2f}")
            if "epe" in m:
                msg += f" epe {float(m['epe']):.3f}"
            log(msg)
    return spec, state, consts, history


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", required=True,
                    help="directory of frame_%%04d.png files")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--size", type=int, default=436)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--net", default="PRBF")
    ap.add_argument("--out", default="pair_flow_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from sin_inn_tpu_torch.core.device import resolve_device
    from sin_inn_tpu_torch.data.flow_media import load_images
    from sin_inn_tpu_torch.data.flow_viz import flow_to_image
    from sin_inn_tpu_torch.train import flow as FT

    cfg = pair_config(args.net, args.epochs, args.device)
    device = resolve_device(cfg.device)
    media = load_images(args.frames, size=args.size)
    batch = pair_batch(media.sample(np.asarray([args.index])), device)
    spec, state, consts, _ = fit_pair(cfg, batch, args.epochs)

    h, w = batch["frame1"].shape[1:3]
    f12, _ = FT.flow_infer(spec, state.params, consts, batch["times"],
                           batch["scale"], h, w, state.ctrl_cfg,
                           state.ctrl_state)
    os.makedirs(args.out, exist_ok=True)
    import imageio.v2 as io

    io.imwrite(os.path.join(args.out, "flow.png"),
               flow_to_image(f12[0].cpu().numpy()))
    print(f"wrote {args.out}/flow.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
