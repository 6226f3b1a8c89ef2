"""Spherical Gaussians (counterpart of nefii_tpu/ops/sg.py): `safe_norm`, SG
evaluation, the closed-form SG renderer of the PhySG baseline
(`render_with_sg`: the GGX NDF as an SG warped to the reflection direction,
Fresnel and geometry folded into its amplitude, SG products by
`lambda_trick`, the clamped cosine as one SG and the stable hemisphere
integral `hemisphere_int`) and `compute_envmap` (SG mixture -> equirect
envmap in mitsuba/blender conventions, or a constant map's bilinear
resize). Every expression is the JAX package's, in its order, in fp32."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

TINY_NUMBER = 1e-6

# the clamped cosine as a single SG (Meder & Bruderlin's fit, as PhySG uses it)
MU_COS = 32.7080
LAMBDA_COS = 0.0315
ALPHA_COS = 31.7003


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with the squared norm floored at 1e-24, so
    the gradient stays finite at the zero vector."""
    return torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def norm_axis(x: torch.Tensor, eps: float = TINY_NUMBER) -> torch.Tensor:
    return x / (safe_norm(x) + eps)


def hemisphere_int(lambda_val: torch.Tensor, cos_beta: torch.Tensor) -> torch.Tensor:
    """The integral of an SG of sharpness lambda over the hemisphere about a
    direction at angle beta from its lobe, in its numerically stable form."""
    lambda_val = lambda_val + TINY_NUMBER
    inv_lambda_val = 1.0 / lambda_val
    t = torch.sqrt(lambda_val) * (1.6988 + 10.8438 * inv_lambda_val) / (
        1.0 + 6.2201 * inv_lambda_val + 10.2415 * inv_lambda_val * inv_lambda_val)

    inv_a = torch.exp(-t)
    mask = (cos_beta >= 0).to(lambda_val.dtype)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    s1 = (1.0 - inv_a * inv_b) / (1.0 - inv_a + inv_b - inv_a * inv_b)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    s2 = (b - inv_a) / ((1.0 - inv_a) * (b + 1.0))
    s = mask * s1 + (1.0 - mask) * s2

    A_b = 2.0 * np.pi / lambda_val * (torch.exp(-lambda_val) - torch.exp(-2.0 * lambda_val))
    A_u = 2.0 * np.pi / lambda_val * (1.0 - torch.exp(-lambda_val))
    return A_b * (1.0 - s) + A_u * s


def lambda_trick(lobe1, lambda1, mu1, lobe2, lambda2, mu2):
    """The product of two SGs as one SG; assumes lambda1 << lambda2."""
    ratio = lambda1 / lambda2
    dot = (lobe1 * lobe2).sum(-1, keepdim=True)
    tmp = torch.sqrt(ratio * ratio + 1.0 + 2.0 * ratio * dot)
    tmp = torch.minimum(tmp, ratio + 1.0)

    lambda3 = lambda2 * tmp
    lambda1_over_lambda3 = ratio / tmp
    lambda2_over_lambda3 = 1.0 / tmp
    diff = lambda2 * (tmp - ratio - 1.0)

    final_lobes = lambda1_over_lambda3 * lobe1 + lambda2_over_lambda3 * lobe2
    final_mus = mu1 * mu2 * torch.exp(diff)
    return final_lobes, lambda3, final_mus


def sg_fn(upsilon, xi, lamb, mu):
    """SG(upsilon) = mu * exp(lambda * (<upsilon, xi> - 1))."""
    return mu * torch.exp(lamb * ((upsilon * xi).sum(-1, keepdim=True) - 1.0))


def extract_light_sg(lgtSGs: torch.Tensor):
    """[..., M, 7] -> unit lobes [..., M, 3], |lambda| [..., M, 1], |mu| [..., M, 3]."""
    return norm_axis(lgtSGs[..., :3]), lgtSGs[..., 3:4].abs(), lgtSGs[..., -3:].abs()


def render_with_sg(
    lgtSGs: torch.Tensor,
    specular_reflectance: torch.Tensor,
    roughness: torch.Tensor,
    diffuse_albedo: torch.Tensor,
    normal: torch.Tensor,
    viewdirs: torch.Tensor,
    blending_weights: Optional[torch.Tensor] = None,
    diffuse_rgb: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Closed-form SG shading under an SG environment light.

    lgtSGs [M,7]; specular_reflectance [K,3]; roughness [K,1];
    diffuse_albedo, normal, viewdirs [..., 3]; blending_weights [..., K] or
    None; diffuse_rgb [..., 3] replaces the diffuse integral when given.
    -> {sg_rgb, sg_specular_rgb, sg_diffuse_rgb, sg_diffuse_albedo} [..., 3].
    Every light-material pair is a [..., M, K, 3] tensor."""
    M = lgtSGs.shape[0]
    K = specular_reflectance.shape[0]
    assert K == roughness.shape[0]
    dots_shape = tuple(normal.shape[:-1])

    normal_mk = normal[..., None, None, :].expand(*dots_shape, M, K, 3)
    viewdirs_mk = viewdirs[..., None, None, :].expand(*dots_shape, M, K, 3)
    lgt = lgtSGs[:, None, :].expand(*dots_shape, M, K, 7)

    lgtSGLobes = norm_axis(lgt[..., :3])
    lgtSGLambdas = lgt[..., 3:4].abs()
    lgtSGMus = lgt[..., -3:].abs()

    # the GGX NDF as an SG about the normal
    brdfSGLobes = normal_mk
    inv_roughness_pow4 = 1.0 / (roughness ** 4)  # [K,1]
    brdfSGLambdas = (2.0 * inv_roughness_pow4).expand(*dots_shape, M, K, 1)
    mu_val = (inv_roughness_pow4 / np.pi).expand(K, 3)
    brdfSGMus = mu_val.expand(*dots_shape, M, K, 3)

    # spherical warp to the reflection direction
    v_dot_lobe = torch.clamp((brdfSGLobes * viewdirs_mk).sum(-1, keepdim=True), min=0.0)
    warpBrdfSGLobes = norm_axis(2 * v_dot_lobe * brdfSGLobes - viewdirs_mk)
    warpBrdfSGLambdas = brdfSGLambdas / (4 * v_dot_lobe + TINY_NUMBER)
    warpBrdfSGMus = brdfSGMus

    # Fresnel and geometry folded into the SG's amplitude
    new_half = norm_axis(warpBrdfSGLobes + viewdirs_mk)
    v_dot_h = torch.clamp((viewdirs_mk * new_half).sum(-1, keepdim=True), min=0.0)
    spec_mk = specular_reflectance.expand(*dots_shape, M, K, 3)
    F = spec_mk + (1.0 - spec_mk) * torch.pow(2.0, -(5.55473 * v_dot_h + 6.8316) * v_dot_h)

    dot1 = torch.clamp((warpBrdfSGLobes * normal_mk).sum(-1, keepdim=True), min=0.0)
    dot2 = torch.clamp((viewdirs_mk * normal_mk).sum(-1, keepdim=True), min=0.0)
    k = (roughness + 1.0) ** 2 / 8.0
    G1 = dot1 / (dot1 * (1 - k) + k + TINY_NUMBER)
    G2 = dot2 / (dot2 * (1 - k) + k + TINY_NUMBER)
    G = G1 * G2

    Moi = F * G / (4 * dot1 * dot2 + TINY_NUMBER)
    warpBrdfSGMus = warpBrdfSGMus * Moi

    # light SG x warped BRDF SG
    final_lobes, final_lambdas, final_mus = lambda_trick(
        lgtSGLobes, lgtSGLambdas, lgtSGMus, warpBrdfSGLobes, warpBrdfSGLambdas, warpBrdfSGMus)

    # x the clamped cosine, then the hemisphere integral
    lobe_prime, lambda_prime, mu_prime = lambda_trick(
        normal_mk, LAMBDA_COS, MU_COS, final_lobes, final_lambdas, final_mus)
    dot1 = (lobe_prime * normal_mk).sum(-1, keepdim=True)
    dot2 = (final_lobes * normal_mk).sum(-1, keepdim=True)
    specular_rgb = (mu_prime * hemisphere_int(lambda_prime, dot1)
                    - final_mus * ALPHA_COS * hemisphere_int(final_lambdas, dot2))

    if blending_weights is None:
        specular_rgb = specular_rgb.sum(-2).sum(-2)
    else:
        specular_rgb = (specular_rgb.sum(-3) * blending_weights[..., None]).sum(-2)
    specular_rgb = torch.clamp(specular_rgb, min=0.0)

    # the diffuse hemisphere integral
    if diffuse_rgb is None:
        diffuse = (diffuse_albedo / np.pi)[..., None, None, :].expand(*dots_shape, M, 1, 3)
        d_lobes = lgtSGLobes[..., :, 0:1, :]
        d_mus = lgtSGMus[..., :, 0:1, :] * diffuse
        d_lambdas = lgtSGLambdas[..., :, 0:1, :]

        normal_m1 = normal_mk[..., :, 0:1, :]
        lobe_prime, lambda_prime, mu_prime = lambda_trick(
            normal_m1, LAMBDA_COS, MU_COS, d_lobes, d_lambdas, d_mus)
        dot1 = (lobe_prime * normal_m1).sum(-1, keepdim=True)
        dot2 = (d_lobes * normal_m1).sum(-1, keepdim=True)
        diffuse_rgb = (mu_prime * hemisphere_int(lambda_prime, dot1)
                       - d_mus * ALPHA_COS * hemisphere_int(d_lambdas, dot2))
        diffuse_rgb = torch.clamp(diffuse_rgb.sum(-2).sum(-2), min=0.0)

    rgb = specular_rgb + diffuse_rgb
    return {"sg_rgb": rgb, "sg_specular_rgb": specular_rgb, "sg_diffuse_rgb": diffuse_rgb,
            "sg_diffuse_albedo": diffuse_albedo}


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
                   coordinate_type: str = "mitsuba", envmap_type: str = "sg") -> torch.Tensor:
    """SG mixture [M,7] (or a constant map [M,M,3]) -> equirect envmap [H,W,3]."""
    if envmap_type == "constant":
        return compute_envmap_2d(lgtSGs, H, W)
    viewdirs = envmap_view_dirs(H, W, upper_hemi, coordinate_type, lgtSGs.device)
    lobes, lambdas, mus = extract_light_sg(lgtSGs)
    return sg_fn(viewdirs[..., None, :], lobes, lambdas, mus).sum(-2)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of a bilinear (triangle-kernel) resize of one
    axis, as jax.image.resize builds them: the kernel widened by
    n_in / n_out where the axis shrinks (antialiasing), each output's
    weights renormalised to sum 1 (also where the border cuts the kernel)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def compute_envmap_2d(lgtMap: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear resize of a constant light map [h,w,3] to [H,W,3]
    (jax.image.resize(..., "bilinear"), antialiased where a side shrinks)."""
    h, w, _ = lgtMap.shape
    out = lgtMap
    if h != H:
        out = torch.einsum("hwc,hH->Hwc", out, _resize_weights(h, H, lgtMap.device))
    if w != W:
        out = torch.einsum("hwc,wW->hWc", out, _resize_weights(w, W, lgtMap.device))
    return out
