"""PhySG's Step-2 frame with live geometry in plain PyTorch: the networks of
NeFII's `confs_sg/physg.conf` (IDR's SDF net with no geometry feature, an
IDR radiance net with a tanh output, a diffuse-albedo MLP with one global
roughness and one global white specular reflectance, an SG light), the
attached SDF and its input gradient, IDR's differentiable surface point and
eikonal term (Yariv et al. 2020, eq. 3 and sec. 3.3), and PhySG's closed-form
render under an SG light (Zhang et al. 2021, sec. 3-4).

It follows the program only in what the program draws or searches: the
primary trace (points, hit, distances) and the eikonal points. Everything
else it computes again from the weights and the inputs, by autograd where
the program writes the chain rule out: the SDF and its input gradient with
their graph to the parameters (so a loss on the gradient reaches them by
second-order autograd), the surface points, the materials, the SG colours and
every loss term.

Departures from the papers, each as NeFII's code has it:
  * IDR eq. 3 divides by <grad f, v> floored in magnitude at 1e-8.
  * The SG product is written relative to the sharper lobe (PhySG's code):
    lambda = l2 t, mu = mu1 mu2 exp(l2 (t - r - 1)) with r = l1 / l2 and
    t = min(sqrt(r^2 + 1 + 2 r <x1, x2>), r + 1), which is the product's
    lambda = |l1 x1 + l2 x2| and exp(lambda - l1 - l2) without the
    cancellation of two large sharpnesses in fp32, and t capped at the
    triangle bound against round-off.
  * The clamped cosine is the SG fit mu 32.7080, lambda 0.0315 less the
    constant 31.7003, and the integral of an SG over the hemisphere the
    smooth-step fit of PhySG's code (`hemisphere_int`).
  * GGX's NDF as an SG (lambda 2 / r^4, mu 1 / (pi r^4)), warped to the
    reflection direction with lambda / (4 <v, n>); Fresnel (Schlick, with the
    spherical-Gaussian exponent 2^(-(5.55473 c + 6.8316) c)) and Smith's
    shadowing with k = (r + 1)^2 / 8 taken at the warped lobe and folded
    into its amplitude, with 1e-6 added to each denominator.
  * The specular reflectance is remapped to 0.16 s^2 (Filament's f0), and
    roughness is floored at 0.089 (as NeFII's material net does).
Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import nets as N
from portbench.reference import pipeline as R

TINY = 1e-6
MU_COS, LAMBDA_COS, ALPHA_COS = 32.7080, 0.0315, 31.7003


class RadianceNet:
    """conf["model"]["rendering_network"] (mode idr, normalize_output):
    (tanh(x) + 1) / 2 of a ReLU MLP on (x, v, n[, feature])."""

    def __init__(self, c: Dict, feature_size: int):
        if c.get("mode", "idr") != "idr" or not c.get("normalize_output", True):
            raise ValueError("the PhySG reference holds the idr mode with normalize_output")
        self.mv, self.mx = int(c.get("multires_view", 0)), int(c.get("multires_xyz", 0))
        d0 = (int(c.get("d_in", 9)) + feature_size + N.embed_dim(self.mv) - 3
              + N.embed_dim(self.mx) - 3)
        self.dims = [d0] + list(c["dims"]) + [int(c.get("d_out", 3))]
        self.shapes = N.layer_shapes(self.dims)
        self.layers = [N.Layer(f"rendering_network.layers.{l}", bool(c.get("weight_norm", True)))
                       for l in range(len(self.shapes))]

    def __call__(self, p, pts, normals, view_dirs, feats, q=None):
        parts = [N.embed(pts, self.mx), N.embed(view_dirs, self.mv), normals]
        x = torch.cat(parts + ([feats] if feats is not None and feats.shape[-1] else []), -1)
        for l, layer in enumerate(self.layers):
            x = layer(p, x, q)
            if l < len(self.layers) - 1:
                x = F.relu(x)
        return (torch.tanh(x) + 1.0) / 2.0


class MaterialNet:
    """conf["model"]["envmap_material_network"] as physg.conf sets it: an ELU
    MLP giving the diffuse albedo, one global roughness and one global white
    specular reflectance (both through a sigmoid), an SG light."""

    def __init__(self, c: Dict, feature_size: int):
        if c.get("same_mlp") or c.get("roughness_mlp") or c.get("specular_mlp") \
                or c.get("fix_specular_albedo") or not c.get("white_specular") \
                or int(c.get("num_base_materials", 1)) != 1 or c.get("white_light") \
                or c.get("upper_hemi") or c.get("use_normal", False) \
                or c.get("light_type", "sg") != "sg":
            raise ValueError("the PhySG reference holds physg.conf's material net only")
        self.multires = int(c.get("multires", 0))
        self.dims = [N.embed_dim(self.multires) + feature_size] + list(c["dims"]) + [3]
        self.shapes = N.layer_shapes(self.dims)
        self.layers = [N.Layer(f"envmap_material_network.diffuse_albedo_layers.{l}", False)
                       for l in range(len(self.shapes))]
        self.num_lgt_sgs = int(c["num_lgt_sgs"])

    def __call__(self, p, pts, feats, fake_roughness=False, q=None):
        x = N.embed(pts, self.multires)
        if feats is not None and feats.shape[-1]:
            x = torch.cat([x, feats], -1)
        for l, layer in enumerate(self.layers):
            x = layer(p, x, q)
            if l < len(self.layers) - 1:
                x = F.elu(x)
        albedo = torch.sigmoid(x)
        rough = (1 - N.TINY_ROUGHNESS) * torch.sigmoid(p["envmap_material_network.roughness"]) \
            + N.TINY_ROUGHNESS
        if fake_roughness:
            rough = 0 * rough + 0.5
        spec = 0.16 * torch.sigmoid(p["envmap_material_network.specular_reflectance"]) ** 2
        return albedo, rough, spec.expand(1, 3)

    def leaves(self):
        return [n for L in self.layers for n in L.leaves()] + [
            "envmap_material_network.lgtSGs", "envmap_material_network.specular_reflectance",
            "envmap_material_network.roughness"]


class Model:
    """The PhySG frame's networks; `q` rounds every product's inputs (the control)."""

    def __init__(self, conf_model: Dict, q=None):
        if conf_model.get("render_type", "sg") != "sg" or conf_model.get("render_background") \
                or conf_model.get("correct_normal") or conf_model.get("use_fused_sdf"):
            raise ValueError("the PhySG reference holds the closed-form sg render on the plain "
                             "nets, with no background")
        fs = int(conf_model["feature_vector_size"])
        self.sdf = N.SDFNet(conf_model["implicit_network"], fs)
        self.render = RadianceNet(conf_model["rendering_network"], fs)
        self.mat = MaterialNet(conf_model["envmap_material_network"], fs)
        self.bounding_sphere = float(conf_model["ray_tracer"].get("object_bounding_sphere", 1.0))
        self.q = q

    def leaf_names(self) -> Dict[str, list]:
        return {"sdf": [n for L in self.sdf.layers for n in L.leaves()],
                "render": [n for L in self.render.layers for n in L.leaves()],
                "material": self.mat.leaves()}


# ---- the closed-form SG render ---------------------------------------------------

def _unit(x):
    return x / (R.safe_norm(x) + TINY)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def sg_product(x1, l1, m1, x2, l2, m2):
    """The product of two SGs (lobe, sharpness, amplitude) as one, written
    relative to the second, the sharper (the module's note)."""
    r = l1 / l2
    t = torch.minimum(torch.sqrt(r * r + 1.0 + 2.0 * r * _dot(x1, x2)), r + 1.0)
    return (r / t) * x1 + (1.0 / t) * x2, l2 * t, m1 * m2 * torch.exp(l2 * (t - r - 1.0))


def hemisphere_integral(lam, cos_beta):
    """The integral over the hemisphere about n of an SG of sharpness lam whose
    lobe makes cos_beta with n: the fit of PhySG's code, a smooth step
    between the lobe's integral over the whole sphere and over none of it."""
    lam = lam + TINY
    t = torch.sqrt(lam) * (1.6988 + 10.8438 / lam) / (1.0 + 6.2201 / lam + 10.2415 / (lam * lam))
    inv_a = torch.exp(-t)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    s_up = (1.0 - inv_a * inv_b) / (1.0 - inv_a + inv_b - inv_a * inv_b)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    s_down = (b - inv_a) / ((1.0 - inv_a) * (b + 1.0))
    s = torch.where(cos_beta >= 0, s_up, s_down)
    whole = 2.0 * math.pi / lam * (1.0 - torch.exp(-lam))
    below = 2.0 * math.pi / lam * (torch.exp(-lam) - torch.exp(-2.0 * lam))
    return below * (1.0 - s) + whole * s


def _cosine_integral(n, x, lam, mu):
    """The integral over the hemisphere about n of the SGs (x, lam, mu) times
    the clamped cosine: the cosine's SG times each, less ALPHA_COS times the
    SG itself."""
    xp, lp, mp = sg_product(n, LAMBDA_COS, MU_COS, x, lam, mu)
    return mp * hemisphere_integral(lp, _dot(xp, n)) - mu * ALPHA_COS * hemisphere_integral(
        lam, _dot(x, n))


def render_sg(lgt, spec, rough, albedo, n, v):
    """Closed-form colours of points (albedo, normal, view [P,3]) of one
    material (spec [1,3], rough [1,1]) under the SG light lgt [M,7] ->
    (rgb, specular, diffuse) [P,3]."""
    xl, ll, ml = _unit(lgt[:, :3]), lgt[:, 3:4].abs(), lgt[:, 4:].abs()   # [M,3|1|3]
    inv_r4 = 1.0 / rough ** 4
    # GGX's NDF as an SG about n, warped to the reflection direction
    v_n = torch.clamp(_dot(v, n), min=0.0)                                  # [P,1]
    xw = _unit(2 * v_n * n - v)
    lw = 2.0 * inv_r4 / (4 * v_n + TINY)
    # Fresnel and shadowing at the warped lobe, folded into its amplitude
    h = _unit(xw + v)
    v_h = torch.clamp(_dot(v, h), min=0.0)
    fresnel = spec + (1.0 - spec) * torch.pow(2.0, -(5.55473 * v_h + 6.8316) * v_h)
    l_n = torch.clamp(_dot(xw, n), min=0.0)
    k = (rough + 1.0) ** 2 / 8.0
    shadow = l_n / (l_n * (1 - k) + k + TINY) * (v_n / (v_n * (1 - k) + k + TINY))
    mw = (inv_r4 / math.pi) * fresnel * shadow / (4 * l_n * v_n + TINY)    # [P,3]
    # every light lobe times the warped BRDF lobe, then the cosine's integral
    x3, l3, m3 = sg_product(xl[None], ll[None], ml[None], xw[:, None], lw[:, None], mw[:, None])
    specular = torch.clamp(_cosine_integral(n[:, None], x3, l3, m3).sum(1), min=0.0)
    # diffuse: the light lobes with the albedo / pi in their amplitude
    md = ml[None] * (albedo / math.pi)[:, None]
    diffuse = torch.clamp(_cosine_integral(n[:, None], xl[None].expand_as(md), ll[None],
                                           md).sum(1), min=0.0)
    return specular + diffuse, specular, diffuse


# ---- live geometry --------------------------------------------------------------

def sdf_grad(M: Model, P, x):
    """The SDF and its input gradient at x [n,3], both keeping their graph to
    the parameters (and to x where x has one), by autograd."""
    with torch.enable_grad():
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        sdf, feat = M.sdf.forward(P, x, M.q)
        (g,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    return sdf, feat, g


def surface_points(sdf_at, sdf_grad_value, dists, cam, dirs):
    """IDR eq. 3: c + (t0 - (f(x0) - f0) / <grad f(x0), v>) v, the value of
    x0 with the gradient of f's parameters."""
    dot = _dot(sdf_grad_value, dirs)
    dot = torch.where(dot.abs() < 1e-8, torch.full_like(dot, 1e-8), dot)
    return cam + (dists - (sdf_at - sdf_at.detach()) / dot) * dirs


def forward(M: Model, P, batch, primary, eik_pts, fake_r=False):
    """The PhySG training frame of one batch {uv [1,S,2], pose, intrinsics,
    object_mask} given the program's primary trace (points, hit, dists [N])
    and eikonal points [E,3] -> per-pixel outputs, `grad_theta` [E+N,3] and
    the shaded rays' colours."""
    uv = batch["uv"]
    if uv.dim() != 3:
        raise ValueError("the PhySG reference holds one ray a pixel")
    B, S = uv.shape[:2]
    dirs, cam = R.camera_rays(uv, batch["pose"], batch["intrinsics"])
    dirs = dirs.reshape(-1, 3)
    cam = cam[:, None].expand(B, S, 3).reshape(-1, 3)
    obj = batch["object_mask"].reshape(-1)
    pts, hit, dists = primary
    n_rays, n_eik = pts.shape[0], eik_pts.shape[0]
    sdf_all, _, grad_theta = sdf_grad(M, P, torch.cat([eik_pts, pts]))
    sdf_out = sdf_all[n_eik:, None]
    sel = (hit & obj).nonzero()[:, 0]
    x = surface_points(sdf_out[sel], grad_theta[n_eik:][sel].detach(), dists[sel, None],
                       cam[sel], dirs[sel])
    _, feat, g = sdf_grad(M, P, x)
    n = g / (R.safe_norm(g) + 1e-6)
    view = -dirs[sel]
    v = view / (R.safe_norm(view) + 1e-6)
    idr = M.render(P, x, n, v, feat, M.q)
    albedo, rough, spec = M.mat(P, x, feat, fake_r, M.q)
    rgb, _, _ = render_sg(P["envmap_material_network.lgtSGs"], spec, rough, albedo, n, v)

    def dense(val, fill):
        o = torch.full((n_rays,) + val.shape[1:], fill, dtype=val.dtype, device=val.device)
        return o.index_put((sel,), val)

    return {"points": pts, "surface_points": x, "idr_rgb_values": dense(idr, 1.0),
            "sg_rgb_values": dense(rgb, 1.0), "normal_values": dense(n, 1.0),
            "network_object_mask": hit, "object_mask": obj, "sdf_output": sdf_out,
            "grad_theta": grad_theta}


def loss(conf_loss: Dict, out, gt_rgb, alpha):
    """IDR's loss as physg.conf sets it: the terms of `pipeline.loss` and the
    eikonal term, the mean of (|grad f| - 1)^2 over the eikonal and the traced
    points."""
    if float(conf_loss.get("background_rgb_weight", 0.0)) != 0.0:
        raise ValueError("the PhySG reference holds no background term")
    # the background term has weight 0 here, so its kind does not matter
    total, terms = R.loss({**conf_loss, "env_loss_type": "L2"}, out, gt_rgb, alpha)
    terms["eikonal_loss"] = ((torch.linalg.norm(out["grad_theta"], dim=1) - 1) ** 2).mean()
    return total + float(conf_loss.get("eikonal_weight", 0.0)) * terms["eikonal_loss"], terms
