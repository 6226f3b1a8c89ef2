"""The Step-2 frame in plain PyTorch: camera rays, the shading of hit points
by the radiance, material and SG-light nets, NeFII's path-traced estimator
with indirect light (`pt_render_indirect_mlp`: cos / GGX-BRDF / SG-mixture
strategies under the power heuristic, visibility and the radiance net at
the secondary hits), the pixel reduction of multi-ray batches, IDR's loss
terms, the secondary self-distillation and Adam.

It follows the program where the program draws: `Replay` hands it, in the
order the program made them, the Monte-Carlo directions the program drew
and the traces the program ran (the primary trace, and each secondary
trace's points, hits and distances). Everything else it computes again
from the weights and the inputs: every network output, every pdf and MIS
weight, every shaded colour, every loss term, every gradient and update.
The traces themselves are held apart, against `tracer.Tracer` on the same
rays (`check.trace_stage`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import nets as N

STRATEGIES = ("cos", "brdf", "mix_sg")


class Replay:
    """The program's draws and secondary traces of one forward, in order:
    ("draw", name, wi [M,3]) and ("trace", origins [P,3], dirs [P,3],
    points [P,3], hit [P], dists [P])."""

    def __init__(self, events: List[tuple]):
        self.events, self.i = events, 0

    def _next(self, kind):
        if self.i >= len(self.events) or self.events[self.i][0] != kind:
            got = self.events[self.i][0] if self.i < len(self.events) else "nothing"
            raise RuntimeError(f"replay: expected a {kind} at event {self.i}, the program made "
                               f"{got}")
        ev = self.events[self.i]
        self.i += 1
        return ev

    def draw(self, name: str, n: int) -> torch.Tensor:
        _, got, wi = self._next("draw")
        if got != name or wi.shape[0] != n:
            raise RuntimeError(f"replay: expected {n} {name} directions, the program drew "
                               f"{wi.shape[0]} {got}")
        return wi

    def trace(self, n: int):
        _, _, _, pts, hit, d = self._next("trace")
        if pts.shape[0] != n:
            raise RuntimeError(f"replay: expected a trace of {n} rays, the program's had "
                               f"{pts.shape[0]}")
        return pts, hit, d

    def done(self) -> bool:
        return self.i == len(self.events)


class Model:
    def __init__(self, conf_model: Dict, q=None):
        fs = int(conf_model["feature_vector_size"])
        self.sdf = N.SDFNet(conf_model["implicit_network"], fs)
        self.render = N.RenderNet(conf_model["rendering_network"], fs)
        self.mat = N.MaterialNet(conf_model["envmap_material_network"], fs)
        if conf_model.get("render_type") != "pt_render_indirect_mlp" \
                or conf_model.get("fast_multi_ray") or conf_model.get("correct_normal"):
            raise ValueError("the reference holds pt_render_indirect_mlp without "
                             "fast_multi_ray or correct_normal")
        self.background = bool(conf_model.get("render_background", False))
        self.q = q


def safe_norm(x):
    return torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def camera_rays(uv, pose, intr):
    """uv [B,S,2], pose [B,4,4], intrinsics [B,4,4] -> (dirs [B,S,3], cam [B,3])."""
    fx, fy = intr[:, 0, 0][:, None], intr[:, 1, 1][:, None]
    cx, cy, sk = intr[:, 0, 2][:, None], intr[:, 1, 2][:, None], intr[:, 0, 1][:, None]
    x, y = uv[..., 0], uv[..., 1]
    xl = (x - cx + cy * sk / fy - sk * y / fy) / fx
    yl = (y - cy) / fy
    p = torch.stack([xl, yl, torch.ones_like(x), torch.ones_like(x)], -1)
    world = torch.einsum("bij,bsj->bsi", pose, p)[..., :3]
    cam = pose[:, :3, 3]
    d = world - cam[:, None]
    return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12), cam


# ---- the estimator ---------------------------------------------------------------

def ggx(wi, n, v, rough, spec):
    h = wi + v
    h = h / (safe_norm(h) + N.TINY)
    ndh = torch.clamp((n * h).sum(-1, keepdim=True), min=0.0)
    r2 = rough ** 2
    root = ndh ** 2 + (1 - ndh ** 2) / (r2 ** 2)
    D = 1.0 / (math.pi * r2 ** 2 * root * root)
    vdh = torch.clamp((v * h).sum(-1, keepdim=True), min=0.0)
    Fr = spec + (1.0 - spec) * torch.pow(2.0, -(5.55473 * vdh + 6.8316) * vdh)
    d1 = torch.clamp((v * n).sum(-1, keepdim=True), min=0.0)
    d2 = torch.clamp((wi * n).sum(-1, keepdim=True), min=0.0)
    k = (rough + 1.0) ** 2 / 8.0
    G = d1 / (d1 * (1 - k) + k + N.TINY) * d2 / (d2 * (1 - k) + k + N.TINY)
    return Fr * D * G / (4 * d1 * d2 + N.TINY)


def pdf(name, wi, n, v, rough, lgt):
    if name == "cos":
        return torch.clamp((wi * n).sum(-1, keepdim=True), min=N.TINY) / math.pi
    if name == "brdf":
        h = wi + v
        nh = torch.linalg.norm(h, dim=-1, keepdim=True)
        h = torch.where(nh > N.TINY, h / (nh + N.TINY), n)
        c = torch.clamp((h * n).sum(-1, keepdim=True), min=N.TINY)
        root = c ** 2 + (1 - c ** 2) / rough ** 4
        ph = c / (math.pi * rough ** 4 * root * root)
        return ph / (4 * torch.clamp((h * v).sum(-1, keepdim=True), min=N.TINY))
    xis, lam, mu = N.split_sg(lgt)
    w = mu.sum(-1)[None] * torch.clamp(n @ xis.t(), min=N.TINY)
    alpha = w / w.sum(-1, keepdim=True)
    c = lam / (2 * math.pi * (1 - torch.exp(-2.0 * lam)))
    return (alpha * c[None] * torch.exp((wi @ xis.t() - 1.0) * lam[None])).sum(-1, keepdim=True)


def shade(M: Model, P, pts, view, rep: Replay, fake_r=False, training=False):
    """get_rbg_value at surface points [m,3] seen along view [m,3]."""
    q = M.q
    _, feat, g = M.sdf.sdf_feature_grad(P, pts, q)
    n = g / (safe_norm(g) + 1e-6)
    v = view / (safe_norm(view) + 1e-6)
    idr = M.render(P, pts, n, v, feat, q)
    albedo, rough, spec = M.mat(P, pts, feat, fake_r, q)
    lgt = P["envmap_material_network.lgtSGs"]
    m = pts.shape[0]
    wis = [rep.draw(s, m) for s in STRATEGIES]
    nd, vd, rd, ld = n.detach(), v.detach(), rough.detach(), lgt.detach()
    pm = [[pdf(sj, wis[i], nd, vd, rd, ld).detach() for sj in STRATEGIES]
          for i in range(len(STRATEGIES))]
    S = len(STRATEGIES)
    lp, hm, _ = rep.trace(S * m)
    spec_rgb = torch.zeros_like(albedo)
    diff_rgb = torch.zeros_like(albedo)
    for i in range(S):
        wi = wis[i]
        p_i, h_i = lp[i * m:(i + 1) * m], hm[i * m:(i + 1) * m]
        vis = 1 - h_i.float()[:, None]
        ind = torch.zeros(m, 3, dtype=pts.dtype, device=pts.device)
        sel = h_i.nonzero()[:, 0]
        if sel.numel():
            _, f2, g2 = M.sdf.sdf_feature_grad(P, p_i[sel], q)
            n2 = g2 / (safe_norm(g2) + 1e-6)
            v2 = -wi[sel]
            v2 = v2 / (safe_norm(v2) + 1e-6)
            ind = ind.index_put((sel,), M.render(P, p_i[sel], n2, v2, f2, q))
        light = N.sg_eval(wi, lgt) * vis + (1 - vis) * ind
        fs = ggx(wi, n, v, rough, spec)
        pdf_i = torch.clamp(pm[i][i], min=N.TINY)
        total = sum(torch.clamp(pm[i][j], min=N.TINY) ** 2 if j == i else pm[i][j] ** 2
                    for j in range(S))
        weight = pdf_i ** 2 / torch.clamp(total, min=N.TINY)
        cos = torch.clamp((wi * n).sum(-1, keepdim=True), min=0.0)
        spec_rgb = spec_rgb + torch.clamp(weight * light * fs * cos / pdf_i, min=0.0)
        diff_rgb = diff_rgb + torch.clamp(weight * light * albedo / math.pi * cos / pdf_i,
                                          min=0.0)
    out = dict(normals=n, idr=idr, sg=spec_rgb + diff_rgb, spec_rgb=spec_rgb, diff_rgb=diff_rgb,
               albedo=albedo, rough=rough, spec=spec)
    if training:
        out["pool"] = (lp.reshape(S, m, 3), hm.reshape(S, m), torch.stack(wis))
    return out


def _mean_pixel(x, bs, r, vector=False):
    x2 = x[:, None] if x.dim() == 1 else x
    x2 = x2.reshape(bs, r, x2.shape[-1])
    if vector:
        x2 = x2[:, 0]
    elif x2.dtype == torch.bool:
        x2 = x2.all(1)
    else:
        x2 = x2.mean(1)
    return x2[:, 0] if x.dim() == 1 else x2


def forward(M: Model, P, batch, primary, rep: Replay, *, training=False, fake_r=False,
            limit=0):
    """forward_with_uv of a frozen geometry on a batch {uv [1,S,R,2] or
    [1,S,2], pose, intrinsics, object_mask}, given the program's primary
    trace (points, hit, dists [N]) -> per-pixel outputs, and with `limit`
    the secondary-hit pool."""
    uv = batch["uv"]
    B, S = uv.shape[:2]
    R = uv.shape[2] if uv.dim() == 4 else 1
    obj = batch["object_mask"].reshape(B, S, 1).expand(B, S, R).reshape(-1)
    dirs, cam = camera_rays(uv.reshape(B, S * R, 2), batch["pose"], batch["intrinsics"])
    dirs = dirs.reshape(-1, 3)
    pts, hit = primary[0], primary[1]
    n_rays = pts.shape[0]
    sel = hit.nonzero()[:, 0]
    with torch.no_grad():
        sdf_out = M.sdf.sdf(P, pts, M.q)[:, None] if training else None
    r = shade(M, P, pts[sel], -dirs[sel], rep, fake_r, training)

    def dense(v, fill):
        o = torch.full((n_rays,) + v.shape[1:], fill, dtype=v.dtype, device=v.device)
        return o.index_put((sel,), v)

    sg = dense(r["sg"], 1.0)
    if M.background:
        sg = torch.where(hit[:, None], sg, N.sg_eval(dirs, P["envmap_material_network.lgtSGs"]))
    out = {"points": pts, "idr_rgb_values": dense(r["idr"], 1.0), "sg_rgb_values": sg,
           "normal_values": dense(r["normals"], 1.0), "network_object_mask": hit,
           "object_mask": obj,
           "sg_diffuse_rgb_values": dense(r["diff_rgb"], 1.0),
           "sg_diffuse_albedo_values": dense(r["albedo"], 1.0),
           "sg_specular_rgb_values": dense(r["spec_rgb"], 0.0),
           "sg_roughness_values": dense(r["rough"], 0.0),
           "sg_specular_reflection_values": dense(r["spec"].expand(sel.numel(), 3), 0.0)}
    if training:
        out["sdf_output"] = sdf_out
    pool = None
    if limit > 0:
        pool = _pool(r["pool"], sel, n_rays, rep, limit)
    bs = B * S
    for k in list(out):
        if k == "normal_values":
            out[k] = _mean_pixel(out[k], bs, R, vector=True)
        else:
            out[k] = _mean_pixel(out[k], bs, R)
    return out, pool


def _pool(shaded, sel, n_rays, rep: Replay, limit):
    """The secondary-hit pool [S', N] and the first `limit` hits of it."""
    lp, hm, wi = shaded
    S = lp.shape[0]
    dev = lp.device
    pts = torch.zeros(S, n_rays, 3, device=dev)
    mask = torch.zeros(S, n_rays, dtype=torch.bool, device=dev)
    dirs = torch.zeros(S, n_rays, 3, device=dev)
    pts[:, sel], mask[:, sel], dirs[:, sel] = lp, hm, wi
    miss = torch.ones(n_rays, dtype=torch.bool, device=dev)
    miss[sel] = False
    miss = miss.nonzero()[:, 0]
    hits = mask.sum(1)
    if miss.numel():
        for s, name in enumerate(STRATEGIES):
            if s > 0 and int(hits[:s].sum()) >= limit:
                break
            w = rep.draw(name, miss.numel())
            p2, h2, _ = rep.trace(miss.numel())
            pts[s, miss], mask[s, miss], dirs[s, miss] = p2, h2, w
            hits[s] += h2.sum()
    keep = min(S, int((hits.cumsum(0) < limit).sum()) + 1)
    flat = mask[:keep].reshape(-1)
    n_hit = int(flat.sum())
    order = torch.argsort((~flat).to(torch.int8), stable=True)[:min(limit, n_hit)]
    return pts[:keep].reshape(-1, 3)[order], dirs[:keep].reshape(-1, 3)[order]


def distil_loss(M: Model, P, points, dirs, R, rep: Replay, fake_r=False):
    """Self-distillation: L1 between the path-traced and the radiance net's
    colour at the pool's hits [K,3], each seen along R copies of its ray."""
    K = points.shape[0]
    p = points[:, None].expand(K, R, 3).reshape(-1, 3)
    d = dirs[:, None].expand(K, R, 3).reshape(-1, 3)
    r = shade(M, P, p, -d, rep, fake_r, training=True)
    sg, idr = _mean_pixel(r["sg"], K, R), _mean_pixel(r["idr"], K, R)
    return (sg - idr).abs().mean()


# ---- the loss ----------------------------------------------------------------------

def _masked_mean(x, m):
    m = m.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    den = (m * torch.ones_like(x)).sum()
    return torch.where(den > 0, (x * m).sum() / den.clamp(min=1.0), torch.zeros_like(den))


def loss(conf_loss: Dict, out, gt_rgb, alpha):
    """IDR's loss as NeFII's conf sets it: L1 rgb of both renders on hit
    and masked pixels, the mask BCE on -alpha sdf, the normal smoothness of
    2x2 patches, the L2 background on missed unmasked pixels."""
    for k in ("idr_ssim_weight", "sg_ssim_weight", "view_diff_weight",
              "roughnesssmooth_weight"):
        if float(conf_loss.get(k, 0.0)) != 0.0:
            raise ValueError(f"the reference holds no {k}")
    if conf_loss.get("loss_type", "L1") != "L1" or conf_loss.get("env_loss_type", "L1") != "L2":
        raise ValueError("the reference holds the L1 rgb and L2 background losses")
    gt = gt_rgb.reshape(-1, 3)
    net, obj = out["network_object_mask"], out["object_mask"]
    hit = net & obj
    t = {"idr_rgb_loss": _masked_mean((out["idr_rgb_values"] - gt).abs(), hit),
         "sg_rgb_loss": _masked_mean((out["sg_rgb_values"] - gt).abs(), hit)}
    x = -alpha * out["sdf_output"][:, 0]
    z = obj.to(x.dtype)
    bce = torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    outside = ~hit
    t["mask_loss"] = torch.where(outside.sum() > 0,
                                 (bce * outside.to(x.dtype)).sum() / obj.shape[0] / alpha,
                                 torch.zeros_like(x[0]))
    rp = int(conf_loss.get("r_patch", -1))
    if rp >= 1 and float(conf_loss.get("normalsmooth_weight", 0.0)) != 0.0:
        p = 4 * rp * rp
        nm = out["normal_values"].reshape(-1, p, 3)
        var = ((nm - nm.mean(1, keepdim=True)) ** 2).sum(1) / max(p - 1, 1)
        t["normalsmooth_loss"] = _masked_mean(var, hit.reshape(-1, p).all(-1))
    else:
        t["normalsmooth_loss"] = torch.zeros_like(t["mask_loss"])
    if float(conf_loss.get("background_rgb_weight", 0.0)) > 0:
        d = out["sg_rgb_values"] - gt
        t["background_rgb_loss"] = _masked_mean(d * d, ~net & ~obj)
    else:
        t["background_rgb_loss"] = torch.zeros_like(t["mask_loss"])
    w = {"idr_rgb_loss": "idr_rgb_weight", "sg_rgb_loss": "sg_rgb_weight",
         "mask_loss": "mask_weight", "normalsmooth_loss": "normalsmooth_weight",
         "background_rgb_loss": "background_rgb_weight"}
    total = sum(float(conf_loss.get(w[k], 0.0)) * v for k, v in t.items())
    return total, t


# ---- Adam --------------------------------------------------------------------------

class Adam:
    """Adam (0.9, 0.999, 1e-8) over a list of leaves at a constant rate."""

    def __init__(self, leaves: List[torch.Tensor], lr: float):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(x) for x in leaves]
        self.v = [torch.zeros_like(x) for x in leaves]

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for x, m, v in zip(self.leaves, self.m, self.v):
            g = x.grad if x.grad is not None else torch.zeros_like(x)
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            x.sub_(self.lr * m / (bc1 * (torch.sqrt(v / bc2) + 1e-8)))
            x.grad = None
