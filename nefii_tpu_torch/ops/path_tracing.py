"""Monte-Carlo path-traced shading with near-field indirect illumination
(counterpart of nefii_tpu/ops/path_tracing.py).

`pt_render_core` covers what `pt_render_indirect_mlp` renders:
cos/brdf/mix_sg multiple importance sampling, the 3x3 pdf matrix, ONE batched
secondary trace of all strategies' rays (`speed_first`), hard visibility
plus indirect radiance from the IDR radiance net at the secondary hits
(`shadow="indirect"`, `diff_geo=False`). Gradients flow to the light, the
materials and the radiance net (indirect light); the samples, their pdfs
and the secondary trace carry none, as in the JAX engine. In training it
also returns the secondary hits for the self-distillation step.

Where the JAX engine evaluates the secondary MLPs on every ray and masks the
misses (static shapes), this one gathers the hit rays and evaluates those
only: the dense semantics of the JAX `indirect_fraction` compaction, exact.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from nefii_tpu_torch.ops import sampling
from nefii_tpu_torch.ops.sampling import TINY_NUMBER
from nefii_tpu_torch.ops.sg import safe_norm


class SceneFns(NamedTuple):
    """Closures over the networks that the shader calls back into.

    trace(origins [N,3], dirs [N,3]) -> (points, hit_mask, n_evals)
    radiance(pts, normals, view_dirs, feats) -> [P,3]  (IDR radiance cache)
    implicit_with_grad(pts [P,3]) -> (sdf [P], feature [P,F], grad [P,3])
    """

    trace: Callable
    radiance: Callable
    implicit_with_grad: Callable
    feature_size: int = 0


def ggx_brdf_direct(wi, normal, viewdirs, roughness, specular_reflectance):
    """Cook-Torrance specular BRDF in direction space: stable-root GGX D,
    Schlick Fresnel, Smith G."""
    half = wi + viewdirs
    half = half / (safe_norm(half) + TINY_NUMBER)
    n_dot_h = torch.clamp((normal * half).sum(-1, keepdim=True), min=0.0)
    r2 = roughness ** 2
    root = n_dot_h ** 2 + (1 - n_dot_h ** 2) / (r2 ** 2)
    D = 1.0 / (np.pi * (r2 ** 2) * root * root)
    v_dot_h = torch.clamp((viewdirs * half).sum(-1, keepdim=True), min=0.0)
    F = specular_reflectance + (1.0 - specular_reflectance) * torch.pow(
        2.0, -(5.55473 * v_dot_h + 6.8316) * v_dot_h)
    dot1 = torch.clamp((viewdirs * normal).sum(-1, keepdim=True), min=0.0)
    dot2 = torch.clamp((wi * normal).sum(-1, keepdim=True), min=0.0)
    k = (roughness + 1.0) ** 2 / 8.0
    G1 = dot1 / (dot1 * (1 - k) + k + TINY_NUMBER)
    G2 = dot2 / (dot2 * (1 - k) + k + TINY_NUMBER)
    return F * D * G1 * G2 / (4 * dot1 * dot2 + TINY_NUMBER)


def visibility_and_indirect(scene: SceneFns, light_points, hit_mask, wi):
    """Hard visibility and indirect radiance at the secondary hits
    (`diff_geo=False`): visibility = 1 - hit; indirect = the radiance net at
    the hit point, seen along -wi, with sdf, feature and normal from one fused
    forward+backward (`implicit_with_grad`). Only the hit rays are evaluated;
    the others get 0 indirect radiance, which is what the dense version's
    mask gives them. hit_mask [P,1]."""
    P = light_points.shape[0]
    visibility = 1 - hit_mask.float()
    indirect = torch.zeros(P, 3, dtype=light_points.dtype, device=light_points.device)
    sel = hit_mask[:, 0].nonzero()[:, 0]
    if sel.numel() == 0:
        return visibility, indirect, 0
    pts = light_points[sel]
    _, feats, g = scene.implicit_with_grad(pts)
    normals = g / (safe_norm(g) + 1e-6)
    view_dirs = -wi[sel]
    view_dirs = view_dirs / (safe_norm(view_dirs) + 1e-6)
    feats = feats if scene.feature_size > 0 else None
    indirect[sel] = scene.radiance(pts, normals, view_dirs, feats).to(indirect.dtype)
    return visibility, indirect, int(sel.numel())


_PDF_FNS = {
    "cos": sampling.pdf_fn_cos,
    "brdf": sampling.pdf_fn_brdf_ggx,
    "mix_sg": sampling.pdf_fn_mix_sg_shared,
}


def sample_direction(name: str, gen: torch.Generator, normal, viewdirs, roughness, lgtSGs):
    """One strategy's Monte-Carlo direction and pdf at every point: "cos"
    (normal), "brdf" (GGX: normal, view, roughness) or "mix_sg" (the SG
    light). The inputs are values; so are the outputs."""
    if name == "cos":
        return sampling.cos_sampling(gen, normal)
    if name == "brdf":
        return sampling.brdf_sampling(gen, normal, roughness, viewdirs)
    return sampling.mix_sg_sampling_shared(gen, normal, lgtSGs)


def pt_render_core(
    gen: torch.Generator,
    lgtSGs: torch.Tensor,                 # [M,7]
    specular_reflectance: torch.Tensor,   # [K,3] or [N,3]
    roughness: torch.Tensor,              # [K,1] or [N,1]
    diffuse_albedo: torch.Tensor,         # [N,3]
    normal: torch.Tensor,                 # [N,3] unit
    viewdirs: torch.Tensor,               # [N,3] unit, surface -> camera
    points: torch.Tensor,                 # [N,3] surface points
    scene: SceneFns,
    *,
    strategies: Tuple[str, ...] = ("cos", "brdf", "mix_sg"),
    shadow: Optional[str] = "indirect",
    diff_geo: bool = False,
    wi_override: Optional[Sequence[torch.Tensor]] = None,
    training: bool = False,
) -> Dict[str, torch.Tensor]:
    if shadow != "indirect" or diff_geo or any(s not in _PDF_FNS for s in strategies):
        raise NotImplementedError(
            "the port's pt_render_core covers pt_render_indirect_mlp only")
    N = normal.shape[0]
    S = len(strategies)

    roughness_brdf = roughness.expand(N, 1) if roughness.shape[0] == 1 and N != 1 else roughness
    # the samples and their pdfs carry no gradient
    normal_s, view_s = normal.detach(), viewdirs.detach()
    rough_s, lgt_s = roughness_brdf.detach(), lgtSGs.detach()

    # ---- sampling ------------------------------------------------------
    wi_list: List[torch.Tensor] = []
    pdf_list: List[torch.Tensor] = []
    for i, name in enumerate(strategies):
        if wi_override is not None:
            # test hook: fixed per-strategy directions; the pdf is the
            # strategy's canonical pdf for them, as its sampler would return
            wi = torch.as_tensor(wi_override[i], dtype=normal.dtype, device=normal.device)
            pdf = _PDF_FNS[name](wi, normal_s, view_s, rough_s, lgt_s)
        else:
            wi, pdf = sample_direction(name, gen, normal_s, view_s, rough_s, lgt_s)
        wi_list.append(wi.detach())
        pdf_list.append(torch.clamp(pdf.detach(), min=TINY_NUMBER))

    # 3x3 pdf matrix for MIS
    pdf_matrix = [[pdf_list[i] if j == i else
                   _PDF_FNS[name_j](wi_list[i], normal_s, view_s, rough_s, lgt_s).detach()
                   for j, name_j in enumerate(strategies)] for i in range(S)]

    # ---- one batched secondary trace of every strategy's rays -----------
    all_pts = points.detach().repeat(S, 1)
    all_dirs = torch.cat(wi_list, dim=0)
    with record_function("secondary_trace"):
        lp, hm, n_trace_evals = scene.trace(all_pts, all_dirs)

    specular_final = torch.zeros_like(diffuse_albedo)
    diffuse_final = torch.zeros_like(diffuse_albedo)
    n_vis_evals = 0
    for i in range(S):
        wi = wi_list[i]
        lp_i, hm_i = lp[i * N:(i + 1) * N], hm[i * N:(i + 1) * N, None]
        with record_function("secondary_shading"):
            visible, indirect, n_hit = visibility_and_indirect(scene, lp_i, hm_i, wi)
        n_vis_evals += n_hit
        light = sampling.sg_light_eval(wi, lgtSGs)
        light = light * visible + (1 - visible) * indirect
        fs = ggx_brdf_direct(wi, normal, viewdirs, roughness, specular_reflectance)
        weight = sampling.power_heuristic_list([1] * S, pdf_matrix[i], i)
        w_i_dot_n = torch.clamp((wi * normal).sum(-1, keepdim=True), min=0.0)
        specular_final = specular_final + torch.clamp(
            weight * light * fs * w_i_dot_n / pdf_list[i], min=0.0)
        diffuse_final = diffuse_final + torch.clamp(
            weight * light * (diffuse_albedo / np.pi) * w_i_dot_n / pdf_list[i], min=0.0)

    ret = {
        "sg_rgb": specular_final + diffuse_final,
        "sg_specular_rgb": specular_final,
        "sg_diffuse_rgb": diffuse_final,
        "sg_diffuse_albedo": diffuse_albedo,
        # SDF point evaluations executed: the secondary trace plus one fused
        # sdf/feature/normal evaluation per secondary hit
        "n_sdf_evals": n_trace_evals + n_vis_evals,
    }
    if training:
        # the secondary hits, per strategy, for the self-distillation step
        ret["secondary_points"] = lp.detach().reshape(S, N, 3)
        ret["secondary_mask"] = hm.reshape(S, N, 1)
        ret["secondary_dir"] = all_dirs.reshape(S, N, 3)
    return ret
