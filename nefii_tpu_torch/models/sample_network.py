"""Differentiable surface intersection, IDR eq. 3 (counterpart of
nefii_tpu/models/sample_network.py).

The sphere-traced intersection x0 = c + t0 v carries no gradient. Written as

    x(theta) = c + (t0 - (sdf(x0; theta) - sdf0) / <grad sdf(x0), v>) v

it keeps x0's value and passes the pixel loss's gradient into the SDF's
parameters. `surface_sdf_values` and `surface_points_grad` come detached
from the caller.
"""

from __future__ import annotations

import torch


def sample_network(
    surface_output: torch.Tensor,       # [N,1] sdf(x0; theta), with its graph
    surface_sdf_values: torch.Tensor,   # [N,1] the same, detached
    surface_points_grad: torch.Tensor,  # [N,3] grad sdf at x0, detached
    surface_dists: torch.Tensor,        # [N,1] traced distance t0
    surface_cam_loc: torch.Tensor,      # [N,3]
    surface_ray_dirs: torch.Tensor,     # [N,3]
) -> torch.Tensor:
    dot = (surface_points_grad * surface_ray_dirs.detach()).sum(-1, keepdim=True)
    # away from a division by ~0
    dot = torch.where(dot.abs() < 1e-8, torch.full_like(dot, 1e-8), dot)
    dists_theta = surface_dists - (surface_output - surface_sdf_values) / dot
    return surface_cam_loc + dists_theta * surface_ray_dirs
