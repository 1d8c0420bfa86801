"""Command-line interface of the PyTorch port.

``python -m sin_inn_tpu_torch.cli sr {train,test,export} ...`` takes the
reference's ``sr`` flags (``--architecture SRF`` or ``IRN``,
``--import-torch`` a reference checkpoint, ``--export-out``, ``--wandb``),
the tuning and profiling flags (``--auto_batch``, ``--auto_lr``,
``--profile N``) plus ``--device`` (default ``cuda``; a CUDA request
without a card fails) and ``--remat``. ``python -m sin_inn_tpu_torch.cli
flow {train,test,interpolate,export,summarize,sintel} ...`` takes the
reference's data, net, training, occlusion, controller
(``--spatially-adaptive``, ``--spatial-res``) and window flags (the global
and local bounds, ``--window-refit``, the windowed forms' chunks),
``--import-torch``, ``--export-out``, ``--wandb``, ``--profile N``,
``--use-kernel``, ``--flow-producer`` (pseudo-GT flow for a video without
GT: ``raft:<ckpt.pth>[@iters]`` runs the port's RAFT on ``--device``) and
``--device``; ``flow train`` runs the test pass on the trained net when it
is done, as the reference does. ``python -m sin_inn_tpu_torch.cli
scene-space {read_matrices,depth_information,reproject,gather} --scene-dir
DIR`` runs the scene-space operations (``--out``, ``--frame``, ``--patch``,
``--window``, ``--device``). ``python -m sin_inn_tpu_torch.cli prepare
VIDEO`` writes the SR dataset folders (host work, no ``--device``).

Multi-GPU: one process per GPU, launched as PyTorch users do, e.g.
``torchrun --nproc_per_node=N -m sin_inn_tpu_torch.cli sr train ...
--mesh_data N`` (``--mesh_model M`` adds tensor parallelism over the GLOW
subnets' hidden channels, ``--distributed`` initialises the process group
from torchrun's environment or from ``--dist_coordinator HOST:PORT
--dist_num_processes P --dist_process_id I``); ``flow train`` takes
``--mesh-data`` and the ``--dist-*`` flags.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from sin_inn_tpu_torch.core.config import (COMPUTE_DTYPES, FlowConfig,
                                          PrepareConfig, SRConfig)


def _sr_parser(sub):
    ap = sub.add_parser("sr", help="INN space-time super-resolution")
    ap.add_argument("operation", choices=["train", "test", "export"])
    ap.add_argument("--export-out", default=None, metavar="CKPT",
                    help="sr export: output path for the reference-loadable "
                         "torch state_dict")
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
    ap.add_argument("--import-torch", default=None, metavar="CKPT",
                    help="seed params from a reference torch/Lightning "
                         "checkpoint (IRN or FrEIA-SRF state_dict); a "
                         "framework checkpoint on disk takes precedence "
                         "(train resume and test/export), with a warning")
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
    ap.add_argument("--wandb", action="store_true",
                    help="log metrics and sample frames to wandb too")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="write one torch.profiler trace of N train steps, "
                         "with the program's spans over its operators and "
                         "kernels, into <checkpoints>/trace")
    ap.add_argument("--auto_lr", action="store_true",
                    help="LR range test before training (auto_lr_find)")
    ap.add_argument("--auto_batch", action="store_true",
                    help="probe the largest batch that fits the card")
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
    ap.add_argument("--mesh_data", type=int, default=None,
                    help="data-parallel mesh axis (default: every process "
                         "of the group)")
    ap.add_argument("--mesh_model", type=int, default=1,
                    help="tensor-parallel mesh axis over the GLOW subnets' "
                         "hidden channels")
    ap.add_argument("--distributed", action="store_true",
                    help="initialise torch.distributed first (from "
                         "torchrun's environment, or the --dist_* flags)")
    ap.add_argument("--dist_coordinator", default=None, metavar="HOST:PORT",
                    help="explicit rendezvous address; requires "
                         "--dist_num_processes and --dist_process_id")
    ap.add_argument("--dist_num_processes", type=int, default=None)
    ap.add_argument("--dist_process_id", type=int, default=None)


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
        import_torch=a.import_torch, val_batch_size=a.val_batch_size,
        hidden_channels=a.hidden_channels, dense_gc=a.dense_gc,
        compute_dtype=a.compute_dtype,
        use_kernel=a.use_kernel, device=a.device, remat=a.remat,
        profile_steps=a.profile, auto_lr=a.auto_lr, auto_batch=a.auto_batch,
        mesh_data=a.mesh_data, mesh_model=a.mesh_model,
        distributed=a.distributed, dist_coordinator=a.dist_coordinator,
        dist_num_processes=a.dist_num_processes,
        dist_process_id=a.dist_process_id,
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
    ap.add_argument("--export-out", default=None, metavar="CKPT",
                    help="flow export: output path for the reference-"
                         "loadable torch state_dict")
    ap.add_argument("--interp-factor", type=int, default=2, metavar="N",
                    help="flow interpolate: temporal upsampling factor "
                         "(N-1 synthesized frames per adjacent pair)")
    ap.add_argument("--input-video",
                    default="../datasets/sintel/training/final/alley_1")
    ap.add_argument("--name", default="temp")
    ap.add_argument("--end", type=int)
    ap.add_argument("--step", type=int)
    ap.add_argument("--size", default=436, type=int)
    ap.add_argument("--batch", default=1, type=int)
    ap.add_argument("--test-size", default=436, type=int)
    ap.add_argument("--test-batch", default=1, type=int)
    ap.add_argument("--net", default="RBF",
                    help="INR of the model registry; the progressive nets "
                         "(PFF, PRBF, PRBFG, PPE, PRFF, PUFF, MPFF) train "
                         "under a controller")
    ap.add_argument("--spatially-adaptive", action="store_true",
                    help="progressive nets: the spatially adaptive "
                         "controller instead of the linear ramp")
    ap.add_argument("--spatial-res", type=int, default=50,
                    help="spatially-adaptive controller grid resolution")
    ap.add_argument("--epochs", default=1000, type=int)
    ap.add_argument("--val-iter", type=int)
    ap.add_argument("--lr", default=1e-4, type=float)
    ap.add_argument("--loss-l1", default=1, type=float)
    ap.add_argument("--loss-census", default=0.1, type=float)
    ap.add_argument("--loss-ssim", default=0, type=float)
    ap.add_argument("--census-width", default=3, type=int)
    ap.add_argument("--loss-smooth1", default=0.1, type=float)
    ap.add_argument("--edge-constant", default=150, type=float)
    ap.add_argument("--edge-func", default="gauss", choices=["exp", "gauss"])
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
    ap.add_argument("--splat-chunk", type=int, default=2,
                    help="row chunk of the windowed splat (--use-kernel off)")
    ap.add_argument("--splat-max-dx", type=_splat_bound, default="auto",
                    help="window column bound: 'auto', 'off', or an int")
    ap.add_argument("--splat-col-chunk", type=int, default=256,
                    help="column block of the windowed warp (--use-kernel "
                         "off)")
    ap.add_argument("--splat-local-dy", type=_splat_bound, default="auto",
                    help="local-window row bound of the kernels: each tile's "
                         "window recentres on the tile-mean flow and this "
                         "bounds the deviation |fy - mean| ('auto' = half "
                         "the global bound, moved by the GT probe and the "
                         "refit; 'off' = static windows; or an int)")
    ap.add_argument("--splat-local-dx", type=_splat_bound, default="auto",
                    help="local-window column bound: windows also recentre "
                         "on the 128-quantized tile-mean flow ('auto' = "
                         "engaged by the GT probe only; 'off'; or an int, "
                         "which needs --splat-local-dy)")
    ap.add_argument("--window-refit", default="auto", choices=["auto", "off"],
                    help="refit the 'auto' window bounds at every save from "
                         "the measured flow (widen when it nears a window, "
                         "tighten once settled); 'off' = static bounds")
    ap.add_argument("--flow-dir", default=None,
                    help="precomputed GT flow dir (.flo/.npy)")
    ap.add_argument("--flow-producer", default=None,
                    help="pseudo-GT producer when no GT exists: "
                         "'raft:<ckpt.pth>[@iters]' (the port's RAFT on "
                         "--device), 'py:<module>:<fn>', or a "
                         "'{f1} {f2} {out}' command")
    ap.add_argument("--use-kernel", default="auto", choices=["auto", "off"],
                    help="the fused INR and windowed CUDA kernels ('off': "
                         "ordinary autograd through the plain INR and the "
                         "windowed forms for the warps and splats)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--wandb", action="store_true",
                    help="log metrics and the flow / occlusion videos to "
                         "wandb too")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="write one torch.profiler trace of N train steps, "
                         "with the program's spans over its operators and "
                         "kernels, into <checkpoints>/<scene>/<name>/trace")
    ap.add_argument("--import-torch", default=None, metavar="CKPT",
                    help="seed weights, encoding buffers and the controller "
                         "mask from a reference torch/Lightning flow "
                         "checkpoint; a framework checkpoint on disk takes "
                         "precedence (train resume and every other "
                         "operation), with a warning")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="data-parallel mesh axis over the frame-pair batch "
                         "(default: every process of the group)")
    ap.add_argument("--distributed", action="store_true",
                    help="initialise torch.distributed first")
    ap.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)


def flow_config_from_args(a) -> FlowConfig:
    return FlowConfig(
        input_video=a.input_video, name=a.name, end=a.end, step=a.step,
        size=a.size, batch=a.batch, test_size=a.test_size,
        test_batch=a.test_batch, net=a.net, epochs=a.epochs,
        spatially_adaptive=a.spatially_adaptive, spatial_res=a.spatial_res,
        val_iter=a.val_iter, lr=a.lr, loss_l1=a.loss_l1,
        loss_census=a.loss_census, loss_ssim=a.loss_ssim,
        census_width=a.census_width, loss_smooth1=a.loss_smooth1,
        edge_constant=a.edge_constant, edge_func=a.edge_func,
        use_kernel=a.use_kernel,
        occl=None if a.occl == "none" else a.occl,
        occl_thresh=a.occl_thresh, num_frequencies=a.num_frequencies,
        hidden_dim=a.hidden_dim, num_layers=a.num_layers,
        compute_dtype=a.compute_dtype, splat_max_dy=a.splat_max_dy,
        splat_chunk=a.splat_chunk, splat_max_dx=a.splat_max_dx,
        splat_col_chunk=a.splat_col_chunk, splat_local_dy=a.splat_local_dy,
        splat_local_dx=a.splat_local_dx, window_refit=a.window_refit,
        flow_dir=a.flow_dir, flow_producer=a.flow_producer,
        device=a.device, profile_steps=a.profile,
        import_torch=a.import_torch, mesh_data=a.mesh_data,
        distributed=a.distributed, dist_coordinator=a.dist_coordinator,
        dist_num_processes=a.dist_num_processes,
        dist_process_id=a.dist_process_id,
    )


def _prepare_parser(sub):
    ap = sub.add_parser("prepare", help="extract HR/LR frames from a video")
    ap.add_argument("video")
    ap.add_argument("-d", "--downsampling", default=1.0, type=float)
    ap.add_argument("-p", "--operator", default="binning",
                    choices=["binning", "linear", "cubic", "lanczos4",
                             "nearest", "area"])
    ap.add_argument("-r", "--reduction", choices=["mean", "sum"],
                    default="mean")
    ap.add_argument("-s", "--scale", type=int, default=4)
    ap.add_argument("-b", "--bayer", action="store_true")
    ap.add_argument("-n", "--noise", type=float)


def _scene_space_parser(sub):
    ap = sub.add_parser("scene-space", help="COLMAP poses + multi-view gather")
    ap.add_argument("operation",
                    choices=["read_matrices", "depth_information",
                             "reproject", "gather"])
    ap.add_argument("--scene-dir", required=True)
    ap.add_argument("--out", default="scene_space_out")
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--patch", type=int, default=3)
    ap.add_argument("--window", default="auto", choices=("auto", "on", "off"),
                    help="gather: 'on' = the windowed one-hot candidate "
                         "read, 'off' and 'auto' = the exact gather")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="sin-inn-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _sr_parser(sub)
    _flow_parser(sub)
    _prepare_parser(sub)
    _scene_space_parser(sub)
    a = parser.parse_args(argv)
    if a.command == "prepare":
        from sin_inn_tpu_torch.data.prepare import prepare_video

        print(prepare_video(PrepareConfig(
            video=a.video, downsampling=a.downsampling, operator=a.operator,
            reduction=a.reduction, scale=a.scale, bayer=a.bayer,
            noise=a.noise)))
        return 0
    if a.command == "scene-space":
        from sin_inn_tpu_torch.scene_space.cli import run

        run(a)
        return 0
    from sin_inn_tpu_torch.train import loop as L

    if a.command == "flow":
        cfg = flow_config_from_args(a)
        if a.operation == "train":
            out = L.run_flow_train(cfg, use_wandb=a.wandb, keep_writer=True)
            if not out["primary"]:
                # on a mesh, rank 0 runs the test pass and writes
                if "writer" in out:
                    out["writer"].close()
                return 0
            eff = out["cfg"]
            if eff.test_size != eff.size:
                # the bounds were resolved at the train frame size: another
                # test size starts again from the values given
                eff = eff.replace(**{k: getattr(cfg, k) for k in
                                     FlowConfig.WINDOW_BOUND_KEYS})
            try:
                print(L.run_flow_test(
                    eff, scene=out["scene"], spec=out["spec"],
                    params=out["state"].params, consts=out["consts"],
                    ctrl_cfg=out["state"].ctrl_cfg,
                    ctrl_state=out["state"].ctrl_state,
                    writer=out["writer"]))
            finally:
                out["writer"].close()
        elif a.operation == "test":
            print(L.run_flow_test(cfg, use_wandb=a.wandb))
        elif a.operation == "export":
            print(L.run_flow_export(cfg, out=a.export_out))
        elif a.operation == "summarize":
            L.run_flow_summarize(cfg)
        elif a.operation == "sintel":
            print(L.run_flow_sintel(cfg))
        else:
            print(L.run_flow_interpolate(cfg, factor=a.interp_factor))
        return 0
    cfg = sr_config_from_args(a)
    if a.operation == "train":
        out = L.run_sr_train(cfg, use_wandb=a.wandb)
        if out["primary"]:
            print(out["exp_dir"])
        return 0
    if a.operation == "export":
        print(L.run_sr_export(cfg, out=a.export_out))
        return 0
    print(L.run_sr_test(cfg, save_images=a.save_images))
    return 0


if __name__ == "__main__":
    sys.exit(main())
