"""The benchmark's weights of a PhySG conf: every leaf of its networks at a
seeded initialisation, the SDF net fitted to the scene (`physg_weights`, the
counterpart of harness.make_weights, whose scene.init_weights holds no
material net with a global roughness)."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import harness, scene
from portbench.reference import nets as N
from portbench.reference import physg as PH


def physg_weights(conf_model, seed: int, p, device):
    """The weights: the radiance and material nets and the light from the
    run's seed; the SDF net from its geometric initialisation fitted to the
    scene, both drawn from FIT_SEED (harness.make_weights' for this conf)."""
    P = init_weights(conf_model, harness.generator(device, harness.seeds(seed, 1)[0]), device)
    g_fit = harness.generator(device, harness.FIT_SEED)
    geo = init_weights(conf_model, g_fit, device)
    P.update({k: v for k, v in geo.items() if k.startswith("implicit_network.")})
    err = scene.fit_sdf(conf_model, P, g_fit, p["fit_steps"], p["fit_batch"], device)
    return P, err


def init_weights(conf_model: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every leaf of physg.conf's networks at a seeded initialisation: the
    SDF net's geometric one (scene.init_weights'), the radiance net's
    kaiming-uniform hidden layers and uniform output, the material net's
    uniform layers, the light's lobes on a Fibonacci sphere with the port's
    energy normalisation, the global roughness uniform in [1.5, 2) and the
    specular reflectance |normal| (before their sigmoids)."""
    M = PH.Model(conf_model)
    P = _sdf_init(M.sdf, conf_model["implicit_network"], gen, device)
    n_uni = sum(a * b for a, b in M.render.shapes) + sum(a * b + b for a, b in M.mat.shapes) + 1
    uni = torch.rand(n_uni, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(M.mat.num_lgt_sgs * 7 + 1, generator=gen, device=device)
    ui = 0
    for l, (a, b) in enumerate(M.render.shapes):
        bound = math.sqrt(6.0 / a) if l < len(M.render.shapes) - 1 else 1.0 / math.sqrt(a)
        w = uni[ui:ui + a * b].reshape(b, a) * bound
        ui += a * b
        pre = M.render.layers[l].prefix
        P[pre + ".v"], P[pre + ".g"] = w.contiguous(), torch.linalg.norm(w, dim=1, keepdim=True)
        P[pre + ".b"] = torch.zeros(b, device=device)
    for l, (a, b) in enumerate(M.mat.shapes):
        bound = 1.0 / math.sqrt(a)
        P[M.mat.layers[l].prefix + ".w"] = (uni[ui:ui + a * b].reshape(b, a) * bound).contiguous()
        ui += a * b
        P[M.mat.layers[l].prefix + ".b"] = (uni[ui:ui + b] * bound).contiguous()
        ui += b
    m = M.mat.num_lgt_sgs
    lgt = nrm[:m * 7].reshape(m, 7).clone()
    lgt[:, -2:] = lgt[:, -3:-2].repeat(1, 2)
    lgt[:, 3:4] = 20.0 + (lgt[:, 3:4] * 100.0).abs()
    lam = lgt[:, 3:4]
    energy = lgt[:, 4:].abs() * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))
    lgt[:, 4:] = lgt[:, 4:].abs() / energy.sum(0, keepdim=True) * 2.0 * math.pi
    lgt[:, :3] = N.fibonacci_sphere(m).to(device)
    P["envmap_material_network.lgtSGs"] = lgt
    P["envmap_material_network.specular_reflectance"] = nrm[m * 7:].reshape(1, 1).abs()
    P["envmap_material_network.roughness"] = (1.5 + 0.5 * (uni[ui:] + 1) / 2).reshape(1, 1)
    return P


def _sdf_init(sdf: N.SDFNet, ic: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The SDF net's geometric initialisation (a sphere of radius `bias`), as
    scene.init_weights draws it."""
    n_nrm = sum(a * b for a, b in sdf.shapes)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    P, ni = {}, 0
    bias, d0 = float(ic.get("bias", 1.0)), sdf.dims[0]
    for l, (a, b) in enumerate(sdf.shapes):
        z = nrm[ni:ni + a * b].reshape(b, a)
        ni += a * b
        if l == len(sdf.shapes) - 1:
            w = math.sqrt(math.pi) / math.sqrt(a) + 1e-4 * z
            bb = torch.full((b,), -bias, device=device)
        else:
            w = math.sqrt(2.0 / b) * z
            if l == 0 and sdf.multires > 0:
                w = torch.cat([w[:, :3], torch.zeros_like(w[:, 3:])], 1)
            elif l in sdf.skip_in and sdf.multires > 0:
                w = torch.cat([w[:, :a - (d0 - 3)], torch.zeros_like(w[:, a - (d0 - 3):])], 1)
            bb = torch.zeros(b, device=device)
        pre = sdf.layers[l].prefix
        P[pre + ".v"], P[pre + ".g"] = w.contiguous(), torch.linalg.norm(w, dim=1, keepdim=True)
        P[pre + ".b"] = bb.contiguous()
    return P
