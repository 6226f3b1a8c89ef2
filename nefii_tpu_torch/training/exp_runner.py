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
directory or a torch `.pth`, `--geometry_neus` a NeuS `.pth`. The
multi-process and camera-training flags are accepted by the parser and
raise when set.
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
                        help="multi-process training (not ported: raises)")
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


def main(argv=None):
    from nefii_tpu_torch.training.trainer import IDRTrainRunner

    parser = argparse.ArgumentParser()
    parser = add_argument(parser)
    opt = parser.parse_args(argv)
    if opt.multihost or opt.num_processes > 1:
        raise NotImplementedError("multi-process training is not ported (ROADMAP.md queue 1)")

    runner = IDRTrainRunner(**vars(opt), nepochs=opt.nepoch, max_niters=opt.max_niter)
    runner.run()
    return runner


if __name__ == "__main__":
    main()
