"""Monte-Carlo path-traced shading with near-field indirect illumination
(counterpart of nefii_tpu/ops/path_tracing.py).

One engine, `pt_render_core`, covers the render-type family through its
options, and the reference-named variants below are thin wrappers of it:
multiple importance sampling over cos / brdf / mix_sg (the SG light) /
env2d (a constant [H,W,3] light) strategies with the S x S pdf matrix; the
secondary rays of all strategies traced in ONE batch (`speed_first`) or one
strategy at a time (`speed_first=False`, the `_memsave` variants); no
shadow, hard visibility, differentiable soft visibility through the SDF
(`shadow="soft"`), or visibility plus indirect radiance from the IDR
radiance net at the secondary hits (`shadow="indirect"`), the latter with
the hit's normal as a value (`diff_geo=False`) or at the point of IDR eq. 3
with its graph (`diff_geo=True`); the miss rays' points moved to the far
bounding sphere (`sphere_fallback`); K base materials blended per point
before sampling (`blend_materials`), or K unblended global materials
summed. `pt_render_with_sg` is the one-sample warped-SG prototype.
Gradients flow to the light, the materials, the radiance net (indirect
light) and, with live geometry, to the SDF through soft visibility and the
eq. 3 points; the samples, their pdfs and the secondary trace carry none, as
in the JAX engine. In training it also returns the secondary hits for the
self-distillation step.

With live geometry (`implicit_with_grad` keeps its graph) the features at
the secondary hits stay attached and, unless `diff_geo`, their normals are
detached, as in the JAX engine. `remat_strategies` checkpoints each
strategy's visibility, indirect radiance and shading
(`torch.utils.checkpoint`): the backward recomputes one strategy's
secondary MLPs at a time in place of keeping all of them. The samples and
the secondary trace come before, outside the checkpoints, so the recompute
sees the same directions and hits.

Where the JAX engine evaluates the secondary MLPs on every ray and masks the
misses (static shapes), this one gathers the hit rays and evaluates the
indirect radiance at those only: the dense semantics of the JAX
`indirect_fraction` compaction, exact. Soft visibility needs the SDF at
every secondary ray, so that evaluation stays dense.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from nefii_tpu_torch.models.sample_network import sample_network
from nefii_tpu_torch.ops import sampling
from nefii_tpu_torch.ops.sampling import TINY_NUMBER
from nefii_tpu_torch.ops.sg import safe_norm
from nefii_tpu_torch.utils.camera import get_sphere_intersection


class SceneFns(NamedTuple):
    """Closures over the networks that the shader calls back into.

    trace(origins [N,3], dirs [N,3], gen, training, steps01)
        -> (points, hit_mask, dists, n_evals): the secondary tracer, values.
        With `training` the rays that miss get the tracer's min-SDF points,
        from the shared [n_steps] vector `steps01` (drawn from `gen` if None).
    implicit(pts [P,3]) -> [P, 1+F] sdf and feature
    implicit_grad(pts [P,3]) -> [P,3] the SDF's spatial gradient
    radiance(pts, normals, view_dirs, feats) -> [P,3]  (IDR radiance cache)
    implicit_with_grad(pts [P,3]) -> (sdf [P], feature [P,F], grad [P,3])
    The implicit closures return values, or keep their graph under live
    geometry; implicit_with_grad's gradient never has one.
    """

    trace: Callable
    implicit: Callable
    implicit_grad: Callable
    radiance: Callable
    implicit_with_grad: Callable
    feature_size: int = 0
    bounding_sphere: float = 1.0


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


def soft_visibility(sdf_value):
    """1 - log(1 + e^(-50 sdf)) / log 2 of a relu'd sdf: 0 on the surface, 1 far off."""
    return 1 - torch.log(1 + torch.exp(-50.0 * sdf_value)) / np.log(2.0)


def visibility_and_indirect(scene: SceneFns, light_points, hit_mask, dists, wi, render_points,
                            diff_geo: bool):
    """Visibility and indirect radiance at the secondary rays [P]; hit_mask,
    dists [P,1]. -> (visibility [P,1], indirect [P,3], SDF evaluations).

    `diff_geo=False`: visibility = 1 - hit; indirect = the radiance net at
    the hit point, seen along -wi, with sdf, feature and normal from one
    fused forward+backward (`implicit_with_grad`, whose normal has no graph).
    `diff_geo=True`: soft visibility of the SDF at every ray's point; the
    indirect radiance at the hit's point of IDR eq. 3 (`sample_network` from
    the primary point along wi, with the trace's dists), with the feature of
    the hit and the normal at the eq. 3 point, both with their graph.
    Only the hit rays get indirect radiance; the others get 0, which is what
    the dense version's mask gives them."""
    P = light_points.shape[0]
    indirect = torch.zeros(P, 3, dtype=light_points.dtype, device=light_points.device)
    n_evals = 0
    if diff_geo:
        out = scene.implicit(light_points)  # dense: soft visibility needs every ray's sdf
        sdf_value = torch.relu(out[:, 0:1])
        visibility = soft_visibility(sdf_value)
        n_evals += P
    else:
        visibility = 1 - hit_mask.float()
    sel = hit_mask[:, 0].nonzero()[:, 0]
    if sel.numel() == 0:
        return visibility, indirect, n_evals
    pts = light_points[sel]
    if diff_geo:
        with torch.no_grad():
            grad = scene.implicit_grad(pts)
        sdf_sel = sdf_value[sel]
        pts = sample_network(sdf_sel, sdf_sel.detach(), grad, dists[sel], render_points[sel],
                             wi[sel])
        g = scene.implicit_grad(pts)
        feats = out[sel, 1:]
        n_evals += 2 * sel.numel()
    else:
        _, feats, g = scene.implicit_with_grad(pts)
        n_evals += sel.numel()
    normals = g / (safe_norm(g) + 1e-6)
    view_dirs = -wi[sel]
    view_dirs = view_dirs / (safe_norm(view_dirs) + 1e-6)
    feats = feats if scene.feature_size > 0 else None
    indirect[sel] = scene.radiance(pts, normals, view_dirs, feats).to(indirect.dtype)
    return visibility, indirect, n_evals


_PDF_FNS = {
    "cos": sampling.pdf_fn_cos,
    "brdf": sampling.pdf_fn_brdf_ggx,
    "mix_sg": sampling.pdf_fn_mix_sg_shared,
    "env2d": sampling.pdf_fn_constant_2d_light,
}


def sample_direction(name: str, gen: torch.Generator, normal, viewdirs, roughness, lgtSGs):
    """One strategy's Monte-Carlo direction and pdf at every point: "cos"
    (normal), "brdf" (GGX: normal, view, roughness), "mix_sg" (the SG light)
    or "env2d" (the constant map). The inputs are values; so are the outputs."""
    if name == "cos":
        return sampling.cos_sampling(gen, normal)
    if name == "brdf":
        return sampling.brdf_sampling(gen, normal, roughness, viewdirs)
    if name == "mix_sg":
        return sampling.mix_sg_sampling_shared(gen, normal, lgtSGs)
    if name == "env2d":
        return sampling.constant_2d_light_sampling(gen, normal, lgtSGs)
    raise ValueError(f"unknown sampling strategy {name!r}")


def pt_render_core(
    gen: torch.Generator,
    lgtSGs: torch.Tensor,                 # [M,7] SG light or [H,W,3] constant map
    specular_reflectance: torch.Tensor,   # [K,3] or [N,3]
    roughness: torch.Tensor,              # [K,1] or [N,1]
    diffuse_albedo: torch.Tensor,         # [N,3]
    normal: torch.Tensor,                 # [N,3] unit
    viewdirs: torch.Tensor,               # [N,3] unit, surface -> camera
    points: Optional[torch.Tensor] = None,  # [N,3] surface points (for shadows)
    scene: Optional[SceneFns] = None,
    *,
    strategies: Tuple[str, ...] = ("cos", "brdf", "mix_sg"),
    shadow: Optional[str] = "indirect",   # None | "hard" | "soft" | "indirect"
    diff_geo: bool = False,
    sphere_fallback: bool = False,
    light_type: str = "sg",
    blending_weights: Optional[torch.Tensor] = None,
    blend_materials: bool = False,
    diffuse_rgb: Optional[torch.Tensor] = None,
    speed_first: bool = True,
    training: bool = False,
    remat_strategies: bool = False,
    wi_override: Optional[Sequence[torch.Tensor]] = None,
    trace_steps01: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """`wi_override` injects each strategy's directions (their pdfs from the
    strategy's pdf function), `trace_steps01` the secondary tracer's min-SDF
    vector (training with `diff_geo`): test hooks."""
    if shadow not in (None, "hard", "soft", "indirect"):
        raise ValueError(f"unknown shadow {shadow!r}")
    N = normal.shape[0]
    S = len(strategies)

    if blend_materials and blending_weights is not None:
        # K base materials blended per point before sampling
        specular_reflectance = (specular_reflectance[None] * blending_weights[..., None]).sum(-2)
        roughness = (roughness[None] * blending_weights[..., None]).sum(-2)
    roughness_brdf = (roughness.expand(N, 1) if roughness.dim() == 2 and roughness.shape[0] == 1
                      and N != 1 else roughness)
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

    # S x S pdf matrix for MIS
    pdf_matrix = [[pdf_list[i] if j == i else
                   _PDF_FNS[name_j](wi_list[i], normal_s, view_s, rough_s, lgt_s).detach()
                   for j, name_j in enumerate(strategies)] for i in range(S)]

    # ---- secondary rays (no gradient through the tracer) ------------------
    n_evals = [0]
    batched = pts = None
    if shadow is not None:
        pts = points.detach()
        # the min-SDF points of the misses matter to soft visibility only
        trace_training = training and diff_geo

        def trace(dirs, n_strategies=1):
            with torch.no_grad(), record_function("secondary_trace"):
                lp, hm, ds, ne = scene.trace(pts.repeat(n_strategies, 1), dirs, gen,
                                             trace_training, trace_steps01)
            n_evals[0] += ne
            return lp, hm[:, None], ds[:, None]

        if speed_first:
            lp, hm, ds = trace(torch.cat(wi_list, dim=0), S)
            batched = [(lp[i * N:(i + 1) * N], hm[i * N:(i + 1) * N], ds[i * N:(i + 1) * N])
                       for i in range(S)]

    def secondary(i):
        lp, hm, ds = batched[i] if speed_first else trace(wi_list[i])
        if sphere_fallback:
            # the miss rays' point moves to the far bounding sphere, where
            # soft visibility saturates to 1
            si, _ = get_sphere_intersection(pts, wi_list[i][:, None, :], r=scene.bounding_sphere)
            far = si.max(dim=2).values[:, 0]
            lp = torch.where(hm, lp, pts + far[:, None] * wi_list[i])
        return lp, hm, ds

    def strategy_contrib(i, lp, hm, ds):
        wi = wi_list[i]
        visible = indirect = None
        n_vis = 0
        with record_function("secondary_shading"):
            if shadow == "hard":
                visible = 1.0 - hm.float()
            elif shadow == "soft":
                visible = soft_visibility(torch.relu(scene.implicit(lp)[:, 0:1]))
                n_vis = N
            elif shadow == "indirect":
                visible, indirect, n_vis = visibility_and_indirect(
                    scene, lp, hm, ds, wi, pts, diff_geo)
        if light_type == "sg":
            light = sampling.sg_light_eval(wi, lgtSGs)
        else:
            light = sampling.envmap_lookup(wi, lgtSGs)
        if visible is not None:
            light = light * visible if indirect is None else \
                light * visible + (1 - visible) * indirect
        if roughness.dim() == 2 and roughness.shape[0] not in (N, 1) and not blend_materials:
            # K > 1 global materials without blending: their sum
            fs = ggx_brdf_direct(wi[:, None, :], normal[:, None, :], viewdirs[:, None, :],
                                 roughness[None], specular_reflectance[None]).sum(-2)
        else:
            fs = ggx_brdf_direct(wi, normal, viewdirs, roughness, specular_reflectance)
        weight = sampling.power_heuristic_list([1] * S, pdf_matrix[i], i)
        w_i_dot_n = torch.clamp((wi * normal).sum(-1, keepdim=True), min=0.0)
        spec = torch.clamp(weight * light * fs * w_i_dot_n / pdf_list[i], min=0.0)
        diff = torch.clamp(
            weight * light * (diffuse_albedo / np.pi) * w_i_dot_n / pdf_list[i], min=0.0)
        return spec, diff, n_vis

    specular_final = torch.zeros_like(diffuse_albedo)
    diffuse_final = torch.zeros_like(diffuse_albedo)
    hit_list = []
    for i in range(S):
        hits = secondary(i) if shadow is not None else (None, None, None)
        hit_list.append(hits)
        if remat_strategies and torch.is_grad_enabled():
            spec, diff, n_vis = checkpoint(strategy_contrib, i, *hits, use_reentrant=False)
        else:
            spec, diff, n_vis = strategy_contrib(i, *hits)
        n_evals[0] += n_vis
        specular_final = specular_final + spec
        diffuse_final = diffuse_final + diff
    if diffuse_rgb is not None:
        diffuse_final = diffuse_rgb

    ret = {
        "sg_rgb": specular_final + diffuse_final,
        "sg_specular_rgb": specular_final,
        "sg_diffuse_rgb": diffuse_final,
        "sg_diffuse_albedo": diffuse_albedo,
        # SDF point evaluations executed: the secondary trace plus the
        # visibility and indirect-radiance evaluations
        "n_sdf_evals": n_evals[0],
    }
    if training and shadow is not None:
        # the secondary hits, per strategy, for the self-distillation step
        ret["secondary_points"] = torch.stack([h[0] for h in hit_list]).detach()
        ret["secondary_mask"] = torch.stack([h[1] for h in hit_list])
        ret["secondary_dir"] = torch.stack(wi_list)
    return ret


# ---------------------------------------------------------------------------
# the reference-named variants
# ---------------------------------------------------------------------------

def _variant(doc: str, **opts):
    def render(gen, lgtSGs, specular_reflectance, roughness, diffuse_albedo, normal, viewdirs,
               points=None, scene=None, blending_weights=None, diffuse_rgb=None,
               training=False, **overrides):
        return pt_render_core(gen, lgtSGs, specular_reflectance, roughness, diffuse_albedo,
                              normal, viewdirs, points, scene, blending_weights=blending_weights,
                              diffuse_rgb=diffuse_rgb, training=training, **{**opts, **overrides})

    render.__doc__ = doc
    return render


_MIS3 = ("cos", "brdf", "mix_sg")
pt_render = _variant("cos+BRDF MIS, no shadows.", strategies=("cos", "brdf"), shadow=None)
pt_render_shadow = _variant("+ hard visibility by tracing secondary rays.", strategies=_MIS3,
                            shadow="hard")
pt_render_diff_shadow = _variant("+ differentiable soft visibility.", strategies=_MIS3,
                                 shadow="soft", diff_geo=True, sphere_fallback=True)
pt_render_diff_shadow_indirect = _variant(
    "+ indirect light from the radiance cache.", strategies=_MIS3, shadow="indirect",
    diff_geo=True, sphere_fallback=True)
pt_render_diff_shadow_indirect_mlp = _variant(
    "MLP materials + 3-strategy MIS + indirect.", strategies=_MIS3, shadow="indirect",
    diff_geo=True)
pt_render_indirect_mlp = _variant("The default NeFII path: diff_geo=False.", strategies=_MIS3,
                                  shadow="indirect", diff_geo=False)
pt_render_indirect_mlp_memsave = _variant(
    "pt_render_indirect_mlp, one strategy's trace at a time.", strategies=_MIS3,
    shadow="indirect", diff_geo=False, speed_first=False)
pt_render_shadow_indirect_mlp_envmap = _variant(
    "The 2-D constant-envmap light.", strategies=("cos", "brdf", "env2d"), shadow="indirect",
    diff_geo=False, light_type="constant")
pt_render_shadow_indirect_mlp_envmap_memsave = _variant(
    "The 2-D constant-envmap light, one strategy's trace at a time.",
    strategies=("cos", "brdf", "env2d"), shadow="indirect", diff_geo=False,
    light_type="constant", speed_first=False)
pt_render_diff_shadow_indirect_blend = _variant(
    "K > 1 base materials blended before sampling.", strategies=_MIS3, shadow="indirect",
    diff_geo=True, sphere_fallback=True, blend_materials=True)
pt_render_diff_shadow2_indirect_blend = _variant(
    "The blend variant without the sphere fallback.", strategies=_MIS3, shadow="indirect",
    diff_geo=True, blend_materials=True)


def pt_render_with_sg(gen, lgtSGs, specular_reflectance, roughness, diffuse_albedo, normal,
                      viewdirs, blending_weights=None, diffuse_rgb=None, training=False):
    """The early prototype: one uniform-hemisphere sample through the
    warped-SG BRDF of a K=1 global material; no secondary ray."""
    K = specular_reflectance.shape[0]
    wi = sampling.uniform_hemisphere_sampling(gen, normal.detach()).detach()
    light = sampling.sg_light_eval(wi, lgtSGs)

    normal_k, viewdirs_k, wi_k = normal[:, None, :], viewdirs[:, None, :], wi[:, None, :]
    inv_r4 = 1.0 / (roughness ** 4)                      # [K,1]
    brdf_lambdas = 2.0 * inv_r4[None, :, :]              # [1,K,1]
    brdf_mus = (inv_r4 / np.pi).expand(K, 3)[None]       # [1,K,3]
    v_dot_lobe = torch.clamp((normal_k * viewdirs_k).sum(-1, keepdim=True), min=0.0)
    warp_lobes = 2 * v_dot_lobe * normal_k - viewdirs_k
    warp_lobes = warp_lobes / (safe_norm(warp_lobes) + TINY_NUMBER)
    warp_lambdas = brdf_lambdas / (4 * v_dot_lobe + TINY_NUMBER)

    new_half = wi_k + viewdirs_k
    new_half = new_half / (safe_norm(new_half) + TINY_NUMBER)
    v_dot_h = torch.clamp((viewdirs_k * new_half).sum(-1, keepdim=True), min=0.0)
    F = specular_reflectance[None] + (1.0 - specular_reflectance[None]) * torch.pow(
        2.0, -(5.55473 * v_dot_h + 6.8316) * v_dot_h)
    dot1 = torch.clamp((wi_k * normal_k).sum(-1, keepdim=True), min=0.0)
    dot2 = torch.clamp((viewdirs_k * normal_k).sum(-1, keepdim=True), min=0.0)
    k_ = (roughness + 1.0) ** 2 / 8.0
    G = (dot1 / (dot1 * (1 - k_) + k_ + TINY_NUMBER)) * (
        dot2 / (dot2 * (1 - k_) + k_ + TINY_NUMBER))
    Moi = F * G / (4 * dot1 * dot2 + TINY_NUMBER)
    fs = (Moi * brdf_mus) * torch.exp(
        warp_lambdas * ((wi_k * warp_lobes).sum(-1, keepdim=True) - 1.0))
    fs = fs[:, 0, :]  # K=1

    w_i_dot_n = torch.clamp((wi * normal).sum(-1, keepdim=True), min=0.0)
    specular_rgb = torch.clamp(2 * np.pi * light * fs * w_i_dot_n, min=0.0)
    if diffuse_rgb is None:
        diffuse_rgb = torch.clamp(2 * np.pi * light * (diffuse_albedo / np.pi) * w_i_dot_n,
                                  min=0.0)
    return {
        "sg_rgb": specular_rgb + diffuse_rgb,
        "sg_specular_rgb": specular_rgb,
        "sg_diffuse_rgb": diffuse_rgb,
        "sg_diffuse_albedo": diffuse_albedo,
        "n_sdf_evals": 0,
    }
