"""Command-line interface of the PyTorch port.

``python -m sin_inn_tpu_torch.cli sr {train,test} ...`` takes the
reference's ``sr`` flags plus ``--device`` (default ``cuda``; a CUDA request
without a card fails) and ``--remat``. ``python -m sin_inn_tpu_torch.cli
flow {test,interpolate} ...`` takes the reference's data, net, occlusion
and window-bound flags, and ``--device``. ``sr
export`` and ``flow {train,export,summarize,sintel}`` are not ported yet and
exit with code 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from sin_inn_tpu_torch.core.config import COMPUTE_DTYPES, FlowConfig, SRConfig

_NOT_PORTED = {"sr": ("export",),
               "flow": ("train", "export", "summarize", "sintel")}


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


def _splat_bound(s: str):
    """'auto' | 'off' | int for the splat window flags."""
    if s in ("auto", "off"):
        return s
    return int(s)


def _flow_parser(sub):
    ap = sub.add_parser("flow", help="INR optical flow / video interpolation")
    ap.add_argument("operation",
                    choices=["train", "test", "summarize", "sintel",
                             "export", "interpolate"])
    ap.add_argument("--interp-factor", type=int, default=2, metavar="N",
                    help="flow interpolate: temporal upsampling factor "
                         "(N-1 synthesized frames per adjacent pair)")
    ap.add_argument("--input-video",
                    default="../datasets/sintel/training/final/alley_1")
    ap.add_argument("--name", default="temp")
    ap.add_argument("--end", type=int)
    ap.add_argument("--step", type=int)
    ap.add_argument("--size", default=436, type=int)
    ap.add_argument("--test-size", default=436, type=int)
    ap.add_argument("--test-batch", default=1, type=int)
    ap.add_argument("--net", default="RBF")
    ap.add_argument("--occl", default="wang", choices=["brox", "wang", "none"])
    ap.add_argument("--occl-thresh", default=0.7, type=float)
    ap.add_argument("--num-frequencies", type=int, default=256)
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--num-layers", type=int, default=3)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=list(COMPUTE_DTYPES))
    ap.add_argument("--splat-max-dy", type=_splat_bound, default="auto",
                    help="splat/warp window row bound |dy| <= N px: 'auto' "
                         "(size-scaled), 'off' (exact scatter), or an int")
    ap.add_argument("--splat-max-dx", type=_splat_bound, default="auto",
                    help="window column bound: 'auto', 'off', or an int")
    ap.add_argument("--flow-dir", default=None,
                    help="precomputed GT flow dir (.flo/.npy)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")


def flow_config_from_args(a) -> FlowConfig:
    return FlowConfig(
        input_video=a.input_video, name=a.name, end=a.end, step=a.step,
        size=a.size, test_size=a.test_size, test_batch=a.test_batch,
        net=a.net, occl=None if a.occl == "none" else a.occl,
        occl_thresh=a.occl_thresh, num_frequencies=a.num_frequencies,
        hidden_dim=a.hidden_dim, num_layers=a.num_layers,
        compute_dtype=a.compute_dtype, splat_max_dy=a.splat_max_dy,
        splat_max_dx=a.splat_max_dx, flow_dir=a.flow_dir, device=a.device,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="sin-inn-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _sr_parser(sub)
    _flow_parser(sub)
    a = parser.parse_args(argv)

    if a.operation in _NOT_PORTED[a.command]:
        print(f"{a.command} {a.operation}: not ported yet to "
              "sin_inn_tpu_torch (use python -m sin_inn_tpu.cli)",
              file=sys.stderr)
        return 2
    from sin_inn_tpu_torch.train import loop as L

    if a.command == "flow":
        cfg = flow_config_from_args(a)
        if a.operation == "test":
            print(L.run_flow_test(cfg))
        else:
            print(L.run_flow_interpolate(cfg, factor=a.interp_factor))
        return 0
    cfg = sr_config_from_args(a)
    if a.operation == "train":
        out = L.run_sr_train(cfg)
        print(out["exp_dir"])
        return 0
    print(L.run_sr_test(cfg, save_images=a.save_images))
    return 0


if __name__ == "__main__":
    sys.exit(main())
