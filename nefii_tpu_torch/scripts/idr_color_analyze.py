"""Debug tool: query the IDR radiance net over a hemisphere of view
directions (counterpart of nefii_tpu/scripts/idr_color_analyze.py).

For each chosen pixel of view 0, trace its surface point, and sweep the
RenderingNetwork over n_theta x n_phi outgoing directions about the surface
normal, writing idr_colors_px<i>.png ([n_theta, n_phi] colours) per pixel.
The trace runs the fp32 SDF (K1 fp32 on the card when the conf's
use_fused_sdf, as the JAX tool traces with the fp32 net whatever
fused_sdf_dtype says); the normals and features come from the model's
value-only shading closure (K2 when use_fused_sdf).

    python -m nefii_tpu_torch.scripts.idr_color_analyze --conf ... \
        --data_split_dir ... --old_expdir ... --pixels 100,100 200,150 [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


@torch.no_grad()
def main(argv=None):
    """-> {"hit": [P] bool, "colors": [P] arrays [n_theta, n_phi, 3]}."""
    from nefii_tpu_torch.ops.kernels.fused_mlp import build_fused_sdf
    from nefii_tpu_torch.ops.sampling import rotate_to_normal
    from nefii_tpu_torch.scripts.render import RenderRunner, add_argument
    from nefii_tpu_torch.utils.camera import get_camera_params
    from nefii_tpu_torch.utils.png import write_png

    parser = argparse.ArgumentParser()
    parser = add_argument(parser)
    parser.add_argument("--pixels", nargs="+", default=["128,128"],
                        help="u,v pixel coordinates to analyse")
    parser.add_argument("--n_theta", type=int, default=16)
    parser.add_argument("--n_phi", type=int, default=64)
    opt = parser.parse_args(argv)
    opt.num_rays = -1

    runner = RenderRunner(**vars(opt))
    model, ds, dev = runner.model, runner.dataset, runner.device

    uv = np.array([[float(t) for t in p.split(",")] for p in opt.pixels], np.float32)
    pose = torch.as_tensor(ds.pose_all[0][None], device=dev)
    K = torch.as_tensor(ds.intrinsics_all[0][None], device=dev)
    rays, cam = get_camera_params(torch.as_tensor(uv[None], device=dev), pose, K)

    imp = model.implicit_network
    sdf_fn = build_fused_sdf(imp, torch.float32) if model.use_fused_sdf else imp.sdf
    res = model.ray_tracer(sdf_fn, cam, torch.ones(len(uv), dtype=torch.bool, device=dev), rays)
    hit = res.object_mask.cpu().numpy()
    print("hit:", hit)

    # hemisphere of view dirs about each surface normal
    _, feats_all, g = model._sfg_closure(value_only=True)(res.points)
    normals = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-6)

    theta = np.linspace(0.05, np.pi / 2 - 0.05, opt.n_theta)
    phi = np.linspace(0, 2 * np.pi, opt.n_phi, endpoint=False)
    T, P = np.meshgrid(theta, phi, indexing="ij")
    local = torch.as_tensor(np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1
    ).reshape(-1, 3).astype(np.float32), device=dev)
    n_dirs = local.shape[0]

    colors = []
    for i in range(len(uv)):
        nrm = normals[i][None].expand(n_dirs, 3)
        dirs = rotate_to_normal(local, nrm)
        pts = res.points[i][None].expand(n_dirs, 3)
        feats = feats_all[i][None].expand(n_dirs, -1) if model.feature_vector_size else None
        rgb = model.rendering_network(pts, nrm, dirs, feats)
        img = rgb.cpu().numpy().reshape(opt.n_theta, opt.n_phi, 3)
        colors.append(img)
        path = os.path.join(runner.out_dir, f"idr_colors_px{i}.png")
        write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print("wrote", path)
    return {"hit": hit, "colors": colors}


if __name__ == "__main__":
    main()
