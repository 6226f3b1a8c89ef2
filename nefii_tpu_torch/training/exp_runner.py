"""CLI entry point for Step-2 training with the PyTorch + CUDA port
(counterpart of nefii_tpu/training/exp_runner.py, whose flags it keeps).

    python -m nefii_tpu_torch.training.exp_runner --conf confs/conf.conf \
        --data_split_dir <scene> --freeze_geometry --geometry <ckpt dir or .pth> \
        --roughness_warmup 5000 --secondary_batch_size 1024 \
        --secondary_train_interval 10 [--device cuda]

    python -m nefii_tpu_torch.training.exp_runner --conf confs/physg.conf \
        --data_split_dir <scene> [--device cuda]

Without `--freeze_geometry` (or `--freeze_idr`) the geometry trains too
(the PhySG baseline of workflows/run_physg.sh); `train.remat` and
`model.remat_strategies` in the conf trade recomputation for memory.
`--geometry` and `--pretrain_geometry_path` take a JAX-layout checkpoint
directory or a torch `.pth`, `--geometry_neus` a NeuS `.pth`.
`--train_cameras` trains the camera poses too (`train.learning_rate_cam`,
default 1e-3); a conf with `loss.view_diff_weight > 0` trains with the
view-diff pairing; the two together raise ValueError, as in JAX.

Multi-GPU: one process per card, either under torchrun

    torchrun --nproc_per_node=N -m nefii_tpu_torch.training.exp_runner ...

or with the JAX package's flags, one command per process:

    python -m nefii_tpu_torch.training.exp_runner ... --multihost \
        --coordinator_address host:port --num_processes N --process_id r

(NCCL; `--device cuda` is each process's card, cuda:LOCAL_RANK, or the rank
modulo the host's cards). `--device cpu` runs the processes over gloo.
"""

from __future__ import annotations

import argparse


def add_argument(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--conf", type=str, default="")
    parser.add_argument("--data_split_dir", type=str, default="")
    parser.add_argument("--data_split_dir_test", type=str, default="")
    parser.add_argument("--gamma", type=float, default=1.0,
                        help="inverse gamma correction coefficient")
    parser.add_argument("--subsample", type=float, default=1.0)
    parser.add_argument("--vis_subsample", type=float, default=1.0)
    parser.add_argument("--coordinate_type", type=str, default="mitsuba",
                        help='up-axis convention ["mitsuba"/"blender"]')
    parser.add_argument("--wo_mask", default=False, action="store_true")

    parser.add_argument("--geometry", type=str, default="",
                        help="path to pretrained geometry (.pth or ckpt dir)")
    parser.add_argument("--geometry_neus", type=str, default="",
                        help="path to a NeuS checkpoint (sdf_network_fine)")
    parser.add_argument("--freeze_geometry", default=False, action="store_true")
    parser.add_argument("--freeze_decompose_render", default=False, action="store_true")
    parser.add_argument("--freeze_light", default=False, action="store_true")
    parser.add_argument("--freeze_diffuse", default=False, action="store_true")
    parser.add_argument("--roughness_warmup", type=int, default=-1)
    parser.add_argument("--specular_warmup", type=int, default=-1)
    parser.add_argument("--secondary_train_interval", type=int, default=-1)

    parser.add_argument("--train_cameras", default=False, action="store_true")

    # inside the working directory (the JAX package's default, ../exp, is outside it)
    parser.add_argument("--exps_folder_name", type=str, default="exps")
    parser.add_argument("--expname", type=str, default="")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--secondary_batch_size", type=int, default=1)
    parser.add_argument("--memory_capacity_level", type=int, default=18,
                        help="up to 2^level rays in flight")
    parser.add_argument("--nepoch", type=int, default=2000)
    parser.add_argument("--max_niter", type=int, default=200001)
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--old_expdir", type=str, default="")
    parser.add_argument("--timestamp", default="latest", type=str)
    parser.add_argument("--checkpoint", default="latest", type=str)
    parser.add_argument("--gpu", type=str, default="auto",
                        help="accepted for script compatibility; the device is --device")

    parser.add_argument("--freeze_idr", default=False, action="store_true")
    parser.add_argument("--write_idr", default=False, action="store_true")

    parser.add_argument("--pretrain_geometry_path", type=str, default="")
    parser.add_argument("--pretrain_idr_rendering_path", type=str, default="")
    parser.add_argument("--pretrain_diffuse_path", type=str, default="")
    parser.add_argument("--light_sg_path", type=str, default="")

    parser.add_argument("--local_rank", type=int, default=-1)
    parser.add_argument("--multihost", default=False, action="store_true",
                        help="multi-process run from --coordinator_address, --num_processes "
                             "and --process_id (torchrun needs none of them)")
    parser.add_argument("--coordinator_address", type=str, default="")
    parser.add_argument("--num_processes", type=int, default=-1)
    parser.add_argument("--process_id", type=int, default=-1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default="",
                        help="profile train iterations 1-3 with torch.profiler; writes "
                             "trace.json and summary.txt here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda raises if CUDA is absent; cpu runs the plain "
                             "versions of the kernels)")
    return parser


def init_distributed(opt) -> None:
    """Join the process group when the flags (--multihost) or torchrun's
    environment ask for more than one process; else nothing."""
    from nefii_tpu_torch.parallel import dist

    if opt.multihost or dist.requested_world() > 1:
        dist.initialize(coordinator_address=opt.coordinator_address or None,
                        num_processes=opt.num_processes if opt.num_processes > 0 else None,
                        process_id=opt.process_id if opt.process_id >= 0 else None,
                        device=opt.device)


def main(argv=None):
    from nefii_tpu_torch.training.trainer import IDRTrainRunner

    parser = argparse.ArgumentParser()
    parser = add_argument(parser)
    opt = parser.parse_args(argv)
    init_distributed(opt)

    runner = IDRTrainRunner(**vars(opt), nepochs=opt.nepoch, max_niters=opt.max_niter)
    runner.run()
    return runner


if __name__ == "__main__":
    main()
