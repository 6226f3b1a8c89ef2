"""The benchmark's scene, made from the seed: the analytic union of three
spheres (a non-convex object, so secondary rays hit it again), posed views on
a ring written in the port's dataset layout (image/*.png, mask/*.png,
cam_dict_norm.json), lit by a seeded SG light, and every network's weights:
the SDF net fitted to the union's distance field, the others at their
seeded initialisation. All of it is computed on the device in a few large
calls; only the images go through the host, to be written.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import nets as N

CENTERS = ((0.25, 0.0, 0.0), (-0.2, 0.15, 0.1), (0.0, -0.25, -0.15))
RADII = (0.45, 0.35, 0.3)
ALBEDOS = ((0.8, 0.35, 0.25), (0.3, 0.7, 0.35), (0.3, 0.4, 0.85))
AMBIENT = 0.15
CAM_DISTANCE = 2.5
# focal length as a multiple of the image width: the union (radius ~0.7 at
# 2.5) then spans about four fifths of a view's width, a third of its pixels
FOCAL = 1.3


def true_sdf(p: torch.Tensor) -> torch.Tensor:
    c = torch.tensor(CENTERS, device=p.device)
    r = torch.tensor(RADII, device=p.device)
    return (torch.linalg.norm(p[:, None, :] - c[None], dim=-1) - r[None]).min(-1).values


def ring_cameras(n: int, res: int, phase: float = 0.0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """n cameras on a ring about the origin, looking at it, elevations
    alternating; -> [(K [4,4], C2W [4,4])]."""
    out = []
    f = FOCAL * res
    for i in range(n):
        az = 2 * math.pi * (i + phase) / n
        el = 0.35 * math.sin(2.3 * i + 1.0)
        eye = CAM_DISTANCE * np.array([math.cos(el) * math.sin(az), math.sin(el),
                                       -math.cos(el) * math.cos(az)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        C2W = np.eye(4)
        C2W[:3, 0], C2W[:3, 1], C2W[:3, 2], C2W[:3, 3] = right, up, fwd, eye
        K = np.eye(4)
        K[0, 0] = K[1, 1] = f
        K[0, 2] = K[1, 2] = res / 2.0
        out.append((K, C2W))
    return out


def seeded_light(gen: torch.Generator, n_lobes: int, device) -> torch.Tensor:
    """An SG light of n lobes [n,7] for the images: lobes in the upper
    half, sharpness 5-30, warm-to-cool colours."""
    u = torch.rand(n_lobes, 6, generator=gen, device=device)
    z = 0.2 + 0.8 * u[:, 0]
    phi = 2 * math.pi * u[:, 1]
    s = torch.sqrt(1 - z * z)
    lobes = torch.stack([s * torch.cos(phi), z, s * torch.sin(phi)], -1)
    lam = 5.0 + 25.0 * u[:, 2:3]
    mu = (0.3 + 0.7 * u[:, 3:6]) * lam / (2 * math.pi) * 2.0 / n_lobes
    return torch.cat([lobes, lam, mu], -1)


def render_view(K, C2W, res: int, light: torch.Tensor, device) -> Tuple[np.ndarray, np.ndarray]:
    """One ray a pixel (the pixel's integer coordinate) into the union: the
    albedo of the sphere hit under the SG light's cosine-weighted
    irradiance plus an ambient floor. -> (uint8 [res,res,3], mask bool)."""
    v, u = torch.meshgrid(torch.arange(res, device=device, dtype=torch.float64),
                          torch.arange(res, device=device, dtype=torch.float64), indexing="ij")
    Kt = torch.as_tensor(K, device=device)
    C = torch.as_tensor(C2W, device=device)
    d = torch.stack([(u - Kt[0, 2]) / Kt[0, 0], (v - Kt[1, 2]) / Kt[1, 1], torch.ones_like(u)], -1)
    d = d.reshape(-1, 3) @ C[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    eye = C[:3, 3]
    best = torch.full((d.shape[0],), float("inf"), device=device, dtype=torch.float64)
    which = torch.full((d.shape[0],), -1, device=device, dtype=torch.int64)
    for k, (c, r) in enumerate(zip(CENTERS, RADII)):
        oc = eye - torch.tensor(c, device=device, dtype=torch.float64)
        b = d @ oc
        disc = b * b - (oc @ oc - r * r)
        t = -b - torch.sqrt(disc.clamp(min=0))
        closer = (disc > 0) & (t > 0) & (t < best)
        best = torch.where(closer, t, best)
        which = torch.where(closer, torch.full_like(which, k), which)
    hit = which >= 0
    p = eye + best.clamp(max=10)[:, None] * d
    cs = torch.tensor(CENTERS, device=device, dtype=torch.float64)
    n = p - cs[which.clamp(min=0)]
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    lg = light.double()
    lobes, lam, mu = lg[:, :3], lg[:, 3:4], lg[:, 4:]
    # a lobe's energy along its axis, weighted by the clamped cosine
    energy = mu * 2 * math.pi / lam * (1 - torch.exp(-2 * lam))
    irr = torch.clamp(n @ lobes.T, min=0) @ energy / math.pi
    alb = torch.tensor(ALBEDOS, device=device, dtype=torch.float64)[which.clamp(min=0)]
    rgb = torch.where(hit[:, None], alb * (AMBIENT + irr), torch.zeros_like(alb))
    img = (rgb.clamp(0, 1) * 255 + 0.5).to(torch.uint8).reshape(res, res, 3)
    return img.cpu().numpy(), hit.reshape(res, res).cpu().numpy()


def _png(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, np.uint8)
    ctype = 0 if img.ndim == 2 else 2
    H, W = img.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)], 1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                                                  0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_split(d: str, cams, res: int, light: torch.Tensor, device) -> Dict[str, list]:
    """Write the views of `cams` in the dataset layout; -> the images as
    written (uint8 numpy), in view order."""
    os.makedirs(os.path.join(d, "image"), exist_ok=True)
    os.makedirs(os.path.join(d, "mask"), exist_ok=True)
    js, imgs = {}, []
    for i, (K, C2W) in enumerate(cams):
        img, mask = render_view(K, C2W, res, light, device)
        name = f"{i:03d}.png"
        _png(os.path.join(d, "image", name), img)
        _png(os.path.join(d, "mask", name), mask.astype(np.uint8) * 255)
        js[name] = {"K": K.reshape(-1).tolist(), "W2C": np.linalg.inv(C2W).reshape(-1).tolist()}
        imgs.append(img)
    with open(os.path.join(d, "cam_dict_norm.json"), "w") as f:
        json.dump(js, f)
    return {"images": imgs}


# ---- weights --------------------------------------------------------------------

def _weight_norm(P: Dict[str, torch.Tensor], prefix: str, w: torch.Tensor, b: torch.Tensor):
    P[prefix + ".v"] = w.contiguous()
    P[prefix + ".g"] = torch.linalg.norm(w, dim=1, keepdim=True)
    P[prefix + ".b"] = b.contiguous()


def init_weights(conf_model: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the three networks and the light, at their seeded
    initialisation: the SDF net's geometric one (a sphere of radius
    `bias`), the radiance net's kaiming-uniform hidden layers and uniform
    output, the material net's uniform layers, the light's lobes on a
    Fibonacci sphere. One uniform and one normal draw in all."""
    fs = int(conf_model["feature_vector_size"])
    sdf = N.SDFNet(conf_model["implicit_network"], fs)
    rnd = N.RenderNet(conf_model["rendering_network"], fs)
    mat = N.MaterialNet(conf_model["envmap_material_network"], fs)
    n_uni = sum(a * b for a, b in rnd.shapes) + sum(a * b + b for a, b in mat.shapes)
    n_nrm = sum(a * b for a, b in sdf.shapes) + mat.num_lgt_sgs * 7
    uni = torch.rand(n_uni, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    P: Dict[str, torch.Tensor] = {}
    ui = ni = 0
    ic = conf_model["implicit_network"]
    bias = float(ic.get("bias", 1.0))
    d0 = sdf.dims[0]
    for l, (a, b) in enumerate(sdf.shapes):
        z = nrm[ni:ni + a * b].reshape(b, a)
        ni += a * b
        last = l == len(sdf.shapes) - 1
        if last:
            w = math.sqrt(math.pi) / math.sqrt(a) + 1e-4 * z
            bb = torch.full((b,), -bias, device=device)
        else:
            w = math.sqrt(2.0 / b) * z
            if l == 0 and sdf.multires > 0:
                w = torch.cat([w[:, :3], torch.zeros_like(w[:, 3:])], 1)
            elif l in sdf.skip_in and sdf.multires > 0:
                w = torch.cat([w[:, :a - (d0 - 3)], torch.zeros_like(w[:, a - (d0 - 3):])], 1)
            bb = torch.zeros(b, device=device)
        _weight_norm(P, sdf.layers[l].prefix, w, bb)
    for l, (a, b) in enumerate(rnd.shapes):
        bound = math.sqrt(6.0 / a) if l < len(rnd.shapes) - 1 else 1.0 / math.sqrt(a)
        w = uni[ui:ui + a * b].reshape(b, a) * bound
        ui += a * b
        _weight_norm(P, rnd.layers[l].prefix, w, torch.zeros(b, device=device))
    for l, (a, b) in enumerate(mat.shapes):
        bound = 1.0 / math.sqrt(a)
        P[mat.layers[l].prefix + ".w"] = (uni[ui:ui + a * b].reshape(b, a) * bound).contiguous()
        ui += a * b
        P[mat.layers[l].prefix + ".b"] = (uni[ui:ui + b] * bound).contiguous()
        ui += b
    M = mat.num_lgt_sgs
    lgt = nrm[ni:ni + M * 7].reshape(M, 7).clone()
    lgt[:, -2:] = lgt[:, -3:-2].repeat(1, 2)
    lgt[:, 3:4] = 20.0 + (lgt[:, 3:4] * 100.0).abs()
    lam = lgt[:, 3:4]
    energy = lgt[:, 4:].abs() * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))
    lgt[:, 4:] = lgt[:, 4:].abs() / energy.sum(0, keepdim=True) * 2.0 * math.pi
    lgt[:, :3] = N.fibonacci_sphere(M).to(device)
    P["envmap_material_network.lgtSGs"] = lgt
    return P


def fit_sdf(conf_model: Dict, P: Dict[str, torch.Tensor], gen: torch.Generator, steps: int,
            batch: int, device) -> float:
    """Fit the SDF net's leaves in P to the union's distance field: L1 on
    seeded samples, half uniform in the bounding cube and half within ~0.05
    of the surfaces, Adam at 1e-3. -> the last step's L1."""
    fs = int(conf_model["feature_vector_size"])
    sdf = N.SDFNet(conf_model["implicit_network"], fs)
    names = [n for L in sdf.layers for n in L.leaves()]
    leaves = {n: P[n].clone().requires_grad_(True) for n in names}
    opt = torch.optim.Adam(list(leaves.values()), lr=1e-3)
    cs = torch.tensor(CENTERS, device=device)
    rs = torch.tensor(RADII, device=device)
    u = torch.rand(steps, batch, 4, generator=gen, device=device)
    g = torch.randn(steps, batch // 2, 4, generator=gen, device=device)
    last = 0.0
    # the fit is the benchmark's set-up, not the program: its products may
    # take TF32 (the flags are put back before the program runs)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        last = _fit_steps(sdf, leaves, opt, u, g, cs, rs, steps, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for n in names:
        P[n] = leaves[n].detach()
    return last


def _fit_steps(sdf, leaves, opt, u, g, cs, rs, steps, batch) -> float:
    last = 0.0
    for i in range(steps):
        far = u[i, : batch // 2, :3] * 2 - 1
        k = (u[i, batch // 2:, 3] * 3).long().clamp(max=2)
        dirs = g[i, :, :3] / torch.linalg.norm(g[i, :, :3], dim=-1, keepdim=True)
        near = cs[k] + dirs * (rs[k] + 0.05 * g[i, :, 3])[:, None]
        x = torch.cat([far, near])
        err = (sdf.sdf(leaves, x) - true_sdf(x)).abs().mean()
        opt.zero_grad(set_to_none=True)
        err.backward()
        opt.step()
        if i == steps - 1:
            last = float(err.detach())
    return last
