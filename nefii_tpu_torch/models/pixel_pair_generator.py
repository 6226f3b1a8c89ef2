"""PixelPairGenerator — cross-view pixel pairing for the view-diff loss
(counterpart of nefii_tpu/models/pixel_pair_generator.py).

Trace the query pixels to surface points, project them into a partner view,
test their visibility by tracing from each point back toward the partner
camera, and fetch the partner's rgb and mask bilinearly. Both traces run the
eval tracer (`training=False`) on the plain fp32 implicit net
(`ImplicitNetwork.sdf`) under no_grad, as the JAX package's do: which pixels
pair is decided in fp32, never by the bf16 K1 of the training trace.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from nefii_tpu_torch.utils.camera import get_camera_params, points2uv


class PixelPairGenerator:
    """find_paired_pixel against the partner views of `dataset`, by index."""

    def __init__(self, dataset, model):
        self.dataset = dataset
        self.model = model

    def find_paired_pixel(self, query_cam_data: Dict[str, torch.Tensor],
                          source_cam_index: Sequence[int]) -> Dict[str, torch.Tensor]:
        ds = self.dataset
        idx = [int(i) for i in source_cam_index]
        dev = query_cam_data["uv"].device

        def stack(arrays):
            return torch.as_tensor(np.stack([arrays[i] for i in idx]), device=dev)

        return find_paired_pixel(self.model, query_cam_data, stack(ds.intrinsics_all),
                                 stack(ds.pose_all), stack(ds.rgb_images),
                                 stack(ds.object_masks), tuple(ds.img_res))


def bilinear_fetch(source_uv: torch.Tensor, source_img: torch.Tensor,
                   img_res: Tuple[int, int]) -> torch.Tensor:
    """Bilinear sample at uv [N,P,2] of flattened images [N,H*W,C] -> [N,P,C];
    the four neighbours' indices are clipped into the image."""
    H, W = img_res
    u = source_uv[..., 0:1]
    v = source_uv[..., 1:2]
    u_left = torch.floor(u)
    u_right = u_left + 1.0
    v_top = torch.floor(v)
    v_bottom = v_top + 1.0

    def fetch(uu, vv):
        ui = uu[..., 0].to(torch.int64).clamp(0, W - 1)
        vi = vv[..., 0].to(torch.int64).clamp(0, H - 1)
        flat = (vi * W + ui)[..., None].expand(-1, -1, source_img.shape[-1])
        return torch.gather(source_img, 1, flat)

    tl, tr = fetch(u_left, v_top), fetch(u_right, v_top)
    bl, br = fetch(u_left, v_bottom), fetch(u_right, v_bottom)
    w_left = (u_right - u) / torch.clamp(u_right - u_left, min=1e-5)
    w_right = 1 - w_left
    top = w_left * tl + w_right * tr
    bottom = w_left * bl + w_right * br
    w_top = (v_bottom - v) / torch.clamp(v_bottom - v_top, min=1e-5)
    return w_top * top + (1 - w_top) * bottom


@torch.no_grad()
def find_paired_pixel(model, query_cam_data: Dict[str, torch.Tensor],
                      source_intrinsics: torch.Tensor, source_pose: torch.Tensor,
                      source_rgb: torch.Tensor, source_mask: torch.Tensor,
                      img_res: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Project the query pixels (uv [N,P,2], pose, intrinsics, object_mask) of
    N views into N partner views (K, pose [N,4,4], rgb [N,H*W,3], mask
    [N,H*W]) -> {uv [N,P,2] clipped into the image, pixel_visible [N*P],
    gt_rgb [N,P,3], object_mask [N,P], intrinsics, pose}."""
    query_uv = query_cam_data["uv"]
    query_mask = query_cam_data["object_mask"].reshape(-1)
    N, P, _ = query_uv.shape
    tracer = model.ray_tracer
    sdf_fn = model.implicit_network.sdf

    ray_dirs, cam_loc = get_camera_params(query_uv, query_cam_data["pose"],
                                          query_cam_data["intrinsics"])
    res = tracer(sdf_fn, cam_loc, query_mask, ray_dirs)
    points = res.points.reshape(N, P, 3)
    source_uv = points2uv(points, source_pose, source_intrinsics)

    # visibility: trace from the point back toward the partner camera
    to_source = points - source_pose[:, None, :3, 3]
    to_source = to_source / (torch.linalg.norm(to_source, dim=-1, keepdim=True) + 1e-12)
    point_exist_mask = res.object_mask & query_mask
    back = tracer(sdf_fn, points.reshape(-1, 3), point_exist_mask,
                  -to_source.reshape(-1, 1, 3))
    pixel_visible = ~back.object_mask & point_exist_mask

    H, W = img_res
    u, v = source_uv[..., 0], source_uv[..., 1]
    in_bounds = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    pixel_visible = pixel_visible.reshape(N, P) & in_bounds
    source_uv = torch.stack([u.clamp(0, W - 1), v.clamp(0, H - 1)], dim=-1)

    sampled_mask = bilinear_fetch(source_uv, source_mask[..., None].to(source_uv.dtype),
                                  img_res)[..., 0] > 0.5
    return {
        "uv": source_uv,
        "pixel_visible": pixel_visible.reshape(-1),
        "gt_rgb": bilinear_fetch(source_uv, source_rgb, img_res),
        "object_mask": sampled_mask,
        "intrinsics": source_intrinsics,
        "pose": source_pose,
    }
