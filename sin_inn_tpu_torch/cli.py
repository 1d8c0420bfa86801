"""Command-line interface of the PyTorch port.

``python -m sin_inn_tpu_torch.cli sr {train,test} ...`` takes the
reference's ``sr`` flags plus ``--device`` (default ``cuda``; a CUDA request
without a card fails) and ``--remat``. ``sr export`` is not ported yet and
exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from sin_inn_tpu_torch.core.config import COMPUTE_DTYPES, SRConfig

_NOT_PORTED = ("export",)


def _sr_parser(sub):
    ap = sub.add_parser("sr", help="INN space-time super-resolution")
    ap.add_argument("operation", choices=["train", "test", "export"])
    ap.add_argument("--dataset", default="datasets/adobe240f")
    ap.add_argument("-s", "--scene", default="IMG_0028_binning_4x")
    ap.add_argument("--suffix", default="default")
    ap.add_argument("-f", "--fps", type=int, default=10)
    ap.add_argument("--lr_window", type=int, default=10)
    ap.add_argument("-b", "--batch_size", type=int, default=8)
    ap.add_argument("-a", "--architecture", choices=["SRF", "IRN"],
                    default="SRF")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("-c", "--num_coupling", type=int, default=4)
    ap.add_argument("-r", "--resume_state", default=None)
    ap.add_argument("-w", "--working_dir", default="experiments")
    ap.add_argument("-e", "--epochs", type=int, default=10000)
    ap.add_argument("--save_iter", type=int, default=100)
    ap.add_argument("-p", "--print_iter", type=int, default=10)
    ap.add_argument("-l", "--learning_rate", type=float, default=1e-4)
    ap.add_argument("--adam_betas", type=float, nargs=2, default=[0.9, 0.99])
    ap.add_argument("--weight_decay", type=float, default=1e-5)
    ap.add_argument("--lambda_fwd_rec", type=float, default=1)
    ap.add_argument("--lambda_fwd_mmd", type=float, default=0)
    ap.add_argument("--lambda_latent_nll", type=float, default=0)
    ap.add_argument("--lambda_bwd_rec", type=float, default=1)
    ap.add_argument("--lambda_bwd_mmd", type=float, default=0)
    ap.add_argument("--random_seed", type=int, default=0)
    ap.add_argument("--lambda_bwd_tcr", type=float, default=0)
    ap.add_argument("--rotation", type=float, default=5)
    ap.add_argument("--translation", type=float, default=5)
    ap.add_argument("--tcr_iters", type=int, default=5)
    ap.add_argument("--tcr_stop_grad", action="store_true",
                    help="gradient-free TCR warp (reference parity)")
    ap.add_argument("-t", "--temp", type=float, default=0.8)
    ap.add_argument("--val_batch_size", type=int, default=40)
    ap.add_argument("--hidden_channels", type=int, default=256)
    ap.add_argument("--dense_gc", type=int, default=32)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=list(COMPUTE_DTYPES))
    ap.add_argument("--use_kernel", default="auto", choices=["auto", "off"],
                    help="fused CUDA kernels for the 1x1 GLOW couplings")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each coupling in the backward")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--save_images", action="store_true",
                    help="sr test: dump PNG frames instead of a video")


def sr_config_from_args(a) -> SRConfig:
    return SRConfig(
        dataset=a.dataset, scene=a.scene, suffix=a.suffix, fps=a.fps,
        lr_window=a.lr_window, batch_size=a.batch_size,
        architecture=a.architecture, scale=a.scale,
        num_coupling=a.num_coupling, epochs=a.epochs, save_iter=a.save_iter,
        print_iter=a.print_iter, learning_rate=a.learning_rate,
        adam_betas=tuple(a.adam_betas), weight_decay=a.weight_decay,
        lambda_fwd_rec=a.lambda_fwd_rec, lambda_fwd_mmd=a.lambda_fwd_mmd,
        lambda_latent_nll=a.lambda_latent_nll,
        lambda_bwd_rec=a.lambda_bwd_rec, lambda_bwd_mmd=a.lambda_bwd_mmd,
        random_seed=a.random_seed, lambda_bwd_tcr=a.lambda_bwd_tcr,
        rotation=a.rotation, translation=a.translation,
        tcr_iters=a.tcr_iters, tcr_stop_grad=a.tcr_stop_grad, temp=a.temp,
        working_dir=a.working_dir, resume_state=a.resume_state,
        val_batch_size=a.val_batch_size, hidden_channels=a.hidden_channels,
        dense_gc=a.dense_gc, compute_dtype=a.compute_dtype,
        use_kernel=a.use_kernel, device=a.device, remat=a.remat,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="sin-inn-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _sr_parser(sub)
    a = parser.parse_args(argv)

    if a.operation in _NOT_PORTED:
        print(f"sr {a.operation}: not ported yet to sin_inn_tpu_torch "
              "(use python -m sin_inn_tpu.cli)", file=sys.stderr)
        return 2
    from sin_inn_tpu_torch.train import loop as L

    cfg = sr_config_from_args(a)
    if a.operation == "train":
        out = L.run_sr_train(cfg)
        print(out["exp_dir"])
        return 0
    print(L.run_sr_test(cfg, save_images=a.save_images))
    return 0


if __name__ == "__main__":
    sys.exit(main())
