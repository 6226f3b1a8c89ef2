"""Camera math (counterpart of nefii_tpu/utils/camera.py) on tensors: ray
generation, projection, bounding-sphere intersection, camera-frame depth and
the quaternion conversions of pose optimisation. A pose is a [B,4,4]
camera-to-world matrix or a [B,7] row (unit quaternion w,x,y,z, then the
translation); every function is differentiable in it."""

from __future__ import annotations

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


def project(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Camera-frame points x, y, z [B,S] -> pixel coords [B,S,2]."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    u = x / z * fx + cx - cy * sk / fy + sk * y / fy
    v = y / z * fy + cy
    return torch.stack((u, v), dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternions [B,4] (w,x,y,z), normalised here -> rotation matrices [B,3,3]."""
    q = q / (torch.linalg.norm(q, dim=1, keepdim=True) + 1e-12)
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rows = [[1 - 2 * (qj ** 2 + qk ** 2), 2 * (qj * qi - qk * qr), 2 * (qi * qk + qr * qj)],
            [2 * (qj * qi + qk * qr), 1 - 2 * (qi ** 2 + qk ** 2), 2 * (qj * qk - qi * qr)],
            [2 * (qk * qi - qj * qr), 2 * (qj * qk + qi * qr), 1 - 2 * (qi ** 2 + qj ** 2)]]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def rot_to_quat(R) -> torch.Tensor:
    """Rotation matrices [B,3,3] (a tensor or an array) -> quaternions [B,4] (w,x,y,z)."""
    R = torch.as_tensor(R, dtype=torch.float32)
    w = torch.sqrt(torch.clamp(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], min=1e-12)) / 2.0
    x = (R[:, 2, 1] - R[:, 1, 2]) / (4 * w)
    y = (R[:, 0, 2] - R[:, 2, 0]) / (4 * w)
    z = (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)
    return torch.stack([w, x, y, z], dim=-1)


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """A [B,4,4] pose as it is, a [B,7] quaternion + translation as [B,4,4]."""
    if pose.dim() == 2 and pose.shape[1] == 7:
        B = pose.shape[0]
        top = torch.cat([quat_to_rot(pose[:, :4]), pose[:, 4:, None]], dim=2)  # [B,3,4]
        last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device)
        return torch.cat([top, last.expand(B, 1, 4)], dim=1)
    if pose.dim() != 3 or tuple(pose.shape[1:]) != (4, 4):
        raise ValueError(f"pose must be [B,4,4] or [B,7], got {tuple(pose.shape)}")
    return pose


def get_camera_params(uv: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor):
    """uv [B,S,2] pixels + pose [B,4,4] | [B,7] + K [B,4,4] -> (ray_dirs [B,S,3], cam_loc [B,3])."""
    pose = pose_to_matrix(pose)
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
    """World points [B,S,3] -> camera frame [B,S,3] under pose [B,4,4] | [B,7],
    by the rigid inverse (R^T, -R^T t)."""
    pose = pose_to_matrix(pose)
    R = pose[:, :3, :3]
    t = pose[:, :3, 3]
    return torch.einsum("bji,bsj->bsi", R, points - t[:, None, :])


def get_depth(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Depth of world points [B,S,3] in the camera frame of pose [B,4,4] | [B,7] -> [B,S,1]."""
    return _world_to_cam(points, pose)[:, :, 2:3]


def points2uv(points: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """World points [B,S,3] -> pixel coords [B,S,2] of the camera at pose."""
    p = _world_to_cam(points, pose)
    return project(p[:, :, 0], p[:, :, 1], p[:, :, 2], intrinsics)
