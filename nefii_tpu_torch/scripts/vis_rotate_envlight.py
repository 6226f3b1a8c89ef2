"""Relighting sweep: rotate the learned SG environment light and re-render
(counterpart of nefii_tpu/scripts/vis_rotate_envlight.py).

Turns the light-SG lobes in steps of --step_deg (mitsuba: yxz Euler angles
[ang, 0, 0]; blender: z [ang]) and renders view --view_idx under each through
the port's RenderRunner, writing per step rot_<deg>/render.exr, render.png
and envmap.png.

    python -m nefii_tpu_torch.scripts.vis_rotate_envlight --conf confs/conf.conf \
        --data_split_dir <scene_test> --old_expdir exps/robot --step_deg 15 [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    """-> the RenderRunner (its `stats` hold each render's seconds)."""
    from nefii_tpu_torch.scripts.envmap_tools import envmap_png, euler_rotation, rotate_lightsg
    from nefii_tpu_torch.scripts.render import RenderRunner, add_argument
    from nefii_tpu_torch.utils import exr as exr_io
    from nefii_tpu_torch.utils.png import write_png

    parser = argparse.ArgumentParser()
    parser = add_argument(parser)
    parser.add_argument("--step_deg", type=float, default=15.0)
    parser.add_argument("--view_idx", type=int, default=0)
    opt = parser.parse_args(argv)

    runner = RenderRunner(**vars(opt))
    lgt_param = runner.model.envmap_material_network.lgtSGs
    base_light = lgt_param.detach().cpu().numpy()
    out_root = runner.out_dir

    n_steps = int(round(360.0 / opt.step_deg))
    H, W = runner.dataset.img_res
    for i in range(n_steps):
        ang = i * opt.step_deg
        if opt.coordinate_type == "mitsuba":
            rot = euler_rotation("yxz", [ang, 0, 0])
        else:
            rot = euler_rotation("z", [ang])
        lgt_rot = rotate_lightsg(base_light, rot)
        with torch.no_grad():
            lgt_param.copy_(torch.as_tensor(lgt_rot, device=lgt_param.device))

        out = runner.render_view(opt.view_idx)
        img = out["sg_rgb_values"].reshape(H, W, 3)
        d = os.path.join(out_root, f"rot_{int(ang):03d}")
        os.makedirs(d, exist_ok=True)
        exr_io.write(os.path.join(d, "render.exr"), img)
        write_png(os.path.join(d, "render.png"), (np.clip(img, 0, 1) * 255).astype(np.uint8))
        envmap_png(os.path.join(d, "envmap.png"), lgt_rot, 128, 256, runner.device,
                   coordinate_type=opt.coordinate_type)
        print(f"relit {int(ang)} deg -> {d}")
    return runner


if __name__ == "__main__":
    main()
