"""CLI entry point for Step-1 geometry training with the PyTorch + CUDA
port (counterpart of nefii_tpu/training/geometry_runner.py, whose flags it
keeps on top of the port's exp_runner flags, --device among them).

    python -m nefii_tpu_torch.training.geometry_runner --conf confs/sdf.conf \
        --mesh_path mesh.obj --expname s1_robot --batch_size 16384 \
        --max_niter 800000 [--not_scale_to_unit] [--data_split_dir <scene>] \
        [--device cuda]

--batch_size is the number of SDF points a step. --data_split_dir adds the
normals | depth render of one view every train.plot_freq iterations.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from nefii_tpu_torch.training.exp_runner import add_argument
    from nefii_tpu_torch.training.geometry_trainer import GeometryTrainRunner

    parser = argparse.ArgumentParser()
    parser = add_argument(parser)
    parser.add_argument("--mesh_path", type=str, required=True)
    parser.add_argument("--sample_num", type=int, default=1024,
                        help="accepted for script compatibility")
    parser.add_argument("--num_workers", type=int, default=16,
                        help="accepted for script compatibility (a background "
                             "prefetch thread feeds the native sampler)")
    parser.add_argument("--not_scale_to_unit", default=False, action="store_true")
    opt = parser.parse_args(argv)

    runner = GeometryTrainRunner(
        conf=opt.conf,
        mesh_path=opt.mesh_path,
        batch_points=opt.batch_size,
        max_niters=opt.max_niter,
        exps_folder_name=opt.exps_folder_name,
        expname=opt.expname,
        scale_to_unit=not opt.not_scale_to_unit,
        is_continue=opt.is_continue,
        old_expdir=opt.old_expdir,
        checkpoint=opt.checkpoint,
        seed=opt.seed,
        data_split_dir=opt.data_split_dir,
        gamma=opt.gamma,
        subsample=opt.subsample,
        vis_subsample=opt.vis_subsample,
        wo_mask=opt.wo_mask,
        device=opt.device,
    )
    runner.run()
    return runner


if __name__ == "__main__":
    main()
