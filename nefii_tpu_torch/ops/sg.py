"""Spherical-Gaussian helpers (counterpart of the parts of nefii_tpu/ops/sg.py
the render path uses): `safe_norm`, SG evaluation and `compute_envmap`
(SG mixture -> equirect envmap in mitsuba/blender conventions)."""

from __future__ import annotations

import numpy as np
import torch

TINY_NUMBER = 1e-6


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with the squared norm floored at 1e-24, so
    the gradient stays finite at the zero vector."""
    return torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def norm_axis(x: torch.Tensor, eps: float = TINY_NUMBER) -> torch.Tensor:
    return x / (safe_norm(x) + eps)


def sg_fn(upsilon, xi, lamb, mu):
    """SG(upsilon) = mu * exp(lambda * (<upsilon, xi> - 1))."""
    return mu * torch.exp(lamb * ((upsilon * xi).sum(-1, keepdim=True) - 1.0))


def extract_light_sg(lgtSGs: torch.Tensor):
    """[..., M, 7] -> unit lobes [..., M, 3], |lambda| [..., M, 1], |mu| [..., M, 3]."""
    return norm_axis(lgtSGs[..., :3]), lgtSGs[..., 3:4].abs(), lgtSGs[..., -3:].abs()


def envmap_view_dirs(H: int, W: int, upper_hemi: bool = False, coordinate_type: str = "mitsuba",
                     device=None) -> torch.Tensor:
    phi_max = np.pi / 2.0 if upper_hemi else np.pi
    phi = torch.linspace(0.0, phi_max, H, device=device)
    if coordinate_type == "mitsuba":
        theta = torch.linspace(-0.5 * np.pi, 1.5 * np.pi, W, device=device)
        phi, theta = torch.meshgrid(phi, theta, indexing="ij")
        return torch.stack([torch.cos(theta) * torch.sin(phi), torch.cos(phi),
                            torch.sin(theta) * torch.sin(phi)], dim=-1)
    if coordinate_type == "blender":
        theta = torch.linspace(1.0 * np.pi, -1.0 * np.pi, W, device=device)
        phi, theta = torch.meshgrid(phi, theta, indexing="ij")
        return torch.stack([torch.cos(theta) * torch.sin(phi), torch.sin(theta) * torch.sin(phi),
                            torch.cos(phi)], dim=-1)
    raise ValueError(f"unknown coordinate_type {coordinate_type!r}")


def compute_envmap(lgtSGs: torch.Tensor, H: int, W: int, upper_hemi: bool = False,
                   coordinate_type: str = "mitsuba") -> torch.Tensor:
    """SG mixture [M,7] -> equirect envmap [H,W,3]."""
    viewdirs = envmap_view_dirs(H, W, upper_hemi, coordinate_type, lgtSGs.device)
    lobes, lambdas, mus = extract_light_sg(lgtSGs)
    return sg_fn(viewdirs[..., None, :], lobes, lambdas, mus).sum(-2)
