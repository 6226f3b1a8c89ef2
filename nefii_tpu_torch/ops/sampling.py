"""Importance sampling for the MC path tracer (counterpart of
nefii_tpu/ops/sampling.py): uniform-hemisphere, cosine, GGX-BRDF,
shared-light SG-mixture and 2-D constant-envmap samplers, their pdfs, SG
light evaluation, the envmap's nearest-texel lookup and the MIS power
heuristic. Randomness comes from an explicit `torch.Generator`."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

TINY_NUMBER = 1e-6


def _uniform(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=like.device, dtype=like.dtype)


def rotate_to_normal(xyz: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate local coords (z-up) into the frame whose z-axis is `n`. [...,3]."""
    x_axis = torch.zeros_like(n)
    x_axis[..., 0] = 1.0
    y_axis = torch.zeros_like(n)
    y_axis[..., 1] = 1.0
    vup = torch.where(n[..., 0:1] > 0.9, y_axis, x_axis)
    t = torch.cross(vup, n, dim=-1)
    t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + TINY_NUMBER)
    s = torch.cross(t, n, dim=-1)
    return xyz[..., :1] * t + xyz[..., 1:2] * s + xyz[..., 2:] * n


def _spherical(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                      torch.cos(theta)], dim=-1)


def uniform_hemisphere_sampling(gen: torch.Generator, normal: torch.Tensor) -> torch.Tensor:
    """Uniform directions on the hemisphere about `normal`; pdf = 1/(2 pi)."""
    shape = normal.shape[:-1] + (1,)
    r1, r2 = _uniform(gen, shape, normal), _uniform(gen, shape, normal)
    phi = 2 * np.pi * r2
    sin_theta = torch.sqrt(1 - r1 ** 2)
    local = torch.cat([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, r1], dim=-1)
    return rotate_to_normal(local, normal)


# ---- cosine-weighted -----------------------------------------------------------

def cos_sampling(gen: torch.Generator, normal: torch.Tensor):
    """Cosine-weighted hemisphere sample; returns (wi [...,3], pdf [...,1])."""
    shape = normal.shape[:-1] + (1,)
    r1, r2 = _uniform(gen, shape, normal), _uniform(gen, shape, normal)
    theta = torch.arccos(torch.sqrt(1 - r1))
    wi = rotate_to_normal(_spherical(theta, 2 * np.pi * r2), normal)
    return wi, torch.cos(theta) / np.pi


def pdf_fn_cos(wi, normal, viewdir, roughness, lgt):
    return torch.clamp((wi * normal).sum(-1, keepdim=True), min=TINY_NUMBER) / np.pi


# ---- GGX BRDF --------------------------------------------------------------------

def brdf_sampling(gen: torch.Generator, normal: torch.Tensor, roughness: torch.Tensor,
                  viewdir: torch.Tensor):
    """GGX NDF importance sample of the half-vector; (wi [...,3], pdf [...,1])."""
    shape = normal.shape[:-1] + (1,)
    r1, r2 = _uniform(gen, shape, normal), _uniform(gen, shape, normal)
    theta = torch.arctan(roughness ** 2 * torch.sqrt(r1 / (1 - r1 + TINY_NUMBER)))
    h = rotate_to_normal(_spherical(theta, 2 * np.pi * r2), normal)
    wi = 2 * (viewdir * h).sum(-1, keepdim=True) * h - viewdir
    return wi, pdf_fn_brdf_ggx(wi, normal, viewdir, roughness, None)


def pdf_fn_brdf_ggx(wi, normal, viewdir, roughness, lgt):
    h = wi + viewdir
    norm = torch.linalg.norm(h, dim=-1, keepdim=True)
    # wi == -viewdir degenerates; fall back to the normal
    h = torch.where(norm > TINY_NUMBER, h / (norm + TINY_NUMBER), normal)
    cos_theta = torch.clamp((h * normal).sum(-1, keepdim=True), min=TINY_NUMBER)
    root = cos_theta ** 2 + (1 - cos_theta ** 2) / (roughness ** 4)
    pdf_h = cos_theta / (np.pi * (roughness ** 4) * root * root)
    h_dot_v = torch.clamp((h * viewdir).sum(-1, keepdim=True), min=TINY_NUMBER)
    return pdf_h / (4 * h_dot_v)


# ---- SG light (global [M,7] mixture) -------------------------------------------

def split_light_sg(lgtSGs: torch.Tensor):
    """[M,7] -> unit lobes [M,3], |lambda| [M], |mu| [M,3]."""
    xis = lgtSGs[:, :3] / (torch.linalg.norm(lgtSGs[:, :3], dim=-1, keepdim=True) + TINY_NUMBER)
    return xis, lgtSGs[:, 3].abs(), lgtSGs[:, 4:].abs()


def sg_light_eval(wi: torch.Tensor, lgtSGs: torch.Tensor) -> torch.Tensor:
    """Radiance of the SG mixture along wi: [N,3] x [M,7] -> [N,3]."""
    xis, lambdas, mus = split_light_sg(lgtSGs)
    return torch.exp((wi @ xis.t() - 1.0) * lambdas[None, :]) @ mus


def _shared_alpha(normal: torch.Tensor, lgtSGs: torch.Tensor):
    xis, lambdas, mus = split_light_sg(lgtSGs)
    weight = mus.sum(-1)[None, :] * torch.clamp(normal @ xis.t(), min=TINY_NUMBER)
    return xis, lambdas, weight / weight.sum(-1, keepdim=True)


def mix_sg_sampling_shared(gen: torch.Generator, normal: torch.Tensor, lgtSGs: torch.Tensor):
    """Sample wi from the SG mixture for a shared light: normal [N,3], lgtSGs [M,7]."""
    N = normal.shape[0]
    xis, lambdas, alpha = _shared_alpha(normal, lgtSGs)
    cdf = torch.cumsum(alpha, dim=-1)
    cdf[:, -1] = 1.0
    r0 = _uniform(gen, (N, 1), normal)
    chosen = torch.argmax((r0 < cdf).to(torch.int8), dim=-1)  # first interval holding r0
    xis_k = xis[chosen]
    lambdas_k = lambdas[chosen][:, None]
    c_k = lambdas_k / (2 * np.pi * (1 - torch.exp(-2 * lambdas_k)))
    r1, r2 = _uniform(gen, (N, 1), normal), _uniform(gen, (N, 1), normal)
    theta = torch.arccos(
        1.0 / lambdas_k
        * torch.log(torch.clamp(1 - lambdas_k * r1 / (2 * np.pi * c_k), min=TINY_NUMBER))
        + 1.0)
    wi = rotate_to_normal(_spherical(theta, 2 * np.pi * r2), xis_k)
    return wi, pdf_fn_mix_sg_shared(wi, normal, None, None, lgtSGs)


def pdf_fn_mix_sg_shared(wi, normal, viewdir, roughness, lgtSGs):
    xis, lambdas, alpha = _shared_alpha(normal, lgtSGs)
    c = lambdas / (2 * np.pi * (1 - torch.exp(-2.0 * lambdas)))
    D = torch.exp((wi @ xis.t() - 1.0) * lambdas[None, :])
    return (alpha * c[None, :] * D).sum(-1, keepdim=True)


# ---- 2-D constant envmap [H,W,3] (PBRT infinite-area light, z-up equirect) ---------

def _sample_1d_cdf(gen: torch.Generator, pdf: torch.Tensor) -> torch.Tensor:
    """pdf [N, L] (its mean over L is 1) -> one index [N] per row: the first
    interval of the row's cdf that holds a uniform draw."""
    N, L = pdf.shape
    cdf = torch.cumsum(pdf / L, dim=1)
    cdf[:, -1] = 1.0
    r = _uniform(gen, (N, 1), pdf)
    return torch.argmax((r < cdf).to(torch.int8), dim=1)


def _envmap_distribution(lgtMap: torch.Tensor) -> torch.Tensor:
    """Texel density [H,W,1] of luminance x sin(theta), mean 1."""
    H, W, _ = lgtMap.shape
    energy = lgtMap.mean(-1, keepdim=True)
    rows = torch.arange(H, device=lgtMap.device, dtype=lgtMap.dtype)
    dist_f = energy * torch.sin((rows + 0.5) / H * np.pi)[:, None, None]
    return dist_f / dist_f.sum() * H * W


def constant_2d_light_sampling(gen: torch.Generator, normal: torch.Tensor, lgtMap: torch.Tensor):
    """Sample wi proportional to the envmap's luminance x sin(theta): a row,
    then a column in it; the direction is the texel's corner. Returns
    (wi [...,3], pdf [...,1])."""
    base_shape = normal.shape[:-1]
    n_flat = int(np.prod(base_shape)) if base_shape else 1
    H, W, _ = lgtMap.shape
    p_uv = _envmap_distribution(lgtMap)
    p_v = p_uv.sum(1) / W
    p_u_if_v = p_uv / p_v[:, None, :]
    v_id = _sample_1d_cdf(gen, p_v[:, 0][None, :].expand(n_flat, H))
    u_id = _sample_1d_cdf(gen, p_u_if_v[v_id, :, 0])
    phi = v_id.to(lgtMap.dtype) / H * np.pi
    theta = np.pi * (1 - u_id.to(lgtMap.dtype) / W * 2.0)
    wi = torch.stack([torch.cos(theta) * torch.sin(phi), torch.sin(theta) * torch.sin(phi),
                      torch.cos(phi)], dim=-1)
    sin_phi = torch.sin(phi)
    pdf = torch.where(sin_phi == 0, torch.zeros_like(sin_phi),
                      p_uv[v_id, u_id, 0] / (2 * np.pi * np.pi * sin_phi))
    return wi.reshape(base_shape + (3,)), pdf.reshape(base_shape + (1,))


def _texel(wi: torch.Tensor, H: int, W: int):
    """-> (phi [...,1], row [...], column [...]) of the texel wi falls in."""
    w = wi / torch.clamp(torch.linalg.norm(wi, dim=-1, keepdim=True), min=TINY_NUMBER)
    phi = torch.arccos(torch.clamp(w[..., 2:3], -1.0, 1.0))
    theta = torch.atan2(w[..., 1:2], w[..., 0:1])
    u = (1.0 - theta / np.pi) / 2.0
    v = phi / np.pi
    u_id = torch.clamp(torch.floor(u * W).to(torch.int64), 0, W - 1)
    v_id = torch.clamp(torch.floor(v * H).to(torch.int64), 0, H - 1)
    return phi, v_id[..., 0], u_id[..., 0]


def pdf_fn_constant_2d_light(wi, normal, viewdir, roughness, lgtMap):
    H, W, _ = lgtMap.shape
    phi, v_id, u_id = _texel(wi, H, W)
    pdf_uv = _envmap_distribution(lgtMap)[v_id, u_id]
    sin_phi = torch.sin(phi)
    return torch.where(sin_phi == 0, torch.zeros_like(sin_phi),
                       pdf_uv / (2 * np.pi * np.pi * sin_phi))


def envmap_lookup(wi: torch.Tensor, lgtMap: torch.Tensor) -> torch.Tensor:
    """Nearest-texel radiance of the envmap [H,W,3] along wi [...,3]."""
    _, v_id, u_id = _texel(wi, lgtMap.shape[0], lgtMap.shape[1])
    return lgtMap[v_id, u_id, :]


# ---- multiple importance sampling ---------------------------------------------

def power_heuristic_list(n_list: Sequence[float], pdf_list: Sequence[torch.Tensor],
                         index: int) -> torch.Tensor:
    """Power heuristic (beta=2) over >=2 strategies."""
    cur = (n_list[index] * pdf_list[index]) ** 2
    total = sum((n * p) ** 2 for n, p in zip(n_list, pdf_list))
    return cur / torch.clamp(total, min=TINY_NUMBER)
