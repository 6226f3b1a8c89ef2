"""Camera math (counterpart of nefii_tpu/utils/camera.py): ray generation,
bounding-sphere intersection and camera-frame depth on tensors, plus the
host-side numpy `rot_to_quat` the dataset uses for pose initialisation."""

from __future__ import annotations

import numpy as np
import torch


def lift(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject pixel coords at depth z to homogeneous camera coords.

    x, y, z: [B, S]; intrinsics: [B, 4, 4]. Returns [B, S, 4].
    """
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack((x_lift, y_lift, z, torch.ones_like(z)), dim=-1)


def get_camera_params(uv: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor):
    """uv [B,S,2] pixels + c2w pose [B,4,4] + K [B,4,4] -> (ray_dirs [B,S,3], cam_loc [B,3])."""
    cam_loc = pose[:, :3, 3]
    depth = torch.ones(uv.shape[:2], dtype=uv.dtype, device=uv.device)
    pixel_points_cam = lift(uv[:, :, 0], uv[:, :, 1], depth, intrinsics)  # [B,S,4]
    world_coords = torch.einsum("bij,bsj->bsi", pose, pixel_points_cam)[:, :, :3]
    ray_dirs = world_coords - cam_loc[:, None, :]
    ray_dirs = ray_dirs / (torch.linalg.norm(ray_dirs, dim=2, keepdim=True) + 1e-12)
    return ray_dirs, cam_loc


def get_sphere_intersection(cam_loc: torch.Tensor, ray_directions: torch.Tensor, r: float = 1.0):
    """Near/far intersections with the origin-centred sphere of radius r.

    cam_loc [B,3], ray_directions [B,S,3] -> (sphere_intersections [B,S,2]
    clamped to >= 0.01 and 0 where there is no hit, mask_intersect [B,S]).
    """
    ray_cam_dot = torch.einsum("bsj,bj->bs", ray_directions, cam_loc)
    under_sqrt = ray_cam_dot ** 2 - ((cam_loc ** 2).sum(-1, keepdim=True) - r ** 2)
    mask_intersect = under_sqrt > 0
    sqrt_val = torch.sqrt(torch.where(mask_intersect, under_sqrt, torch.zeros_like(under_sqrt)))
    si = torch.stack([-sqrt_val - ray_cam_dot, sqrt_val - ray_cam_dot], dim=-1)
    si = torch.where(mask_intersect[..., None], si, torch.zeros_like(si))
    return si.clamp(min=0.01), mask_intersect


def _world_to_cam(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """World points [B,S,3] -> camera frame [B,S,3] under c2w pose [B,4,4],
    by the rigid inverse (R^T, -R^T t)."""
    if pose.dim() != 3 or tuple(pose.shape[1:]) != (4, 4):
        raise ValueError(f"pose must be [B,4,4] camera-to-world matrices, got {tuple(pose.shape)}")
    R = pose[:, :3, :3]
    t = pose[:, :3, 3]
    return torch.einsum("bji,bsj->bsi", R, points - t[:, None, :])


def get_depth(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Depth of world points [B,S,3] in the camera frame of pose [B,4,4] -> [B,S,1]."""
    return _world_to_cam(points, pose)[:, :, 2:3]


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrices [B,3,3] -> quaternions [B,4] (w,x,y,z), numpy."""
    R = np.asarray(R, np.float32)
    w = np.sqrt(np.clip(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], 1e-12, None)) / 2.0
    x = (R[:, 2, 1] - R[:, 1, 2]) / (4 * w)
    y = (R[:, 0, 2] - R[:, 2, 0]) / (4 * w)
    z = (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)
    return np.stack([w, x, y, z], axis=-1).astype(np.float32)
