"""IDR's ray tracer in plain PyTorch: a bidirectional sphere trace with a
back-step line search, then, on the rays it leaves unfinished, an n-step
sign-change sampler and a secant or bisection rootfind (Yariv et al. 2020,
sec. 3.2 and the supplement; NeFII's conf `ray_tracer` block). It evaluates
every live ray each iteration through `sdf_fn(pts [P,3]) -> [P]` and counts
the evaluations, which the benchmark takes as the work a trace needs.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def sphere_intersection(cam: torch.Tensor, dirs: torch.Tensor, r: float):
    """Per ray (cam [N,3], dirs [N,3]): near/far distances to the sphere of
    radius r, clamped to >= 0.01, and whether the ray meets it."""
    b = (dirs * cam).sum(-1)
    under = b * b - ((cam * cam).sum(-1) - r * r)
    hit = under > 0
    s = torch.sqrt(torch.where(hit, under, torch.zeros_like(under)))
    near = torch.where(hit, -s - b, torch.zeros_like(b)).clamp(min=0.01)
    far = torch.where(hit, s - b, torch.zeros_like(b)).clamp(min=0.01)
    return near, far, hit


class Tracer:
    def __init__(self, c: Dict, secondary: Dict = None):
        c = {**c, **(secondary or {})}
        self.r = float(c.get("object_bounding_sphere", 1.0))
        self.thresh = float(c.get("sdf_threshold", 5e-5))
        self.ls_step = float(c.get("line_search_step", 0.5))
        self.ls_iters = int(c.get("line_step_iters", 1))
        self.st_iters = int(c.get("sphere_tracing_iters", 10))
        self.n_steps = int(c.get("n_steps", 100))
        self.n_root = int(c.get("n_rootfind_steps", 8))
        self.secant = c.get("rootfind_method", "bisection") == "secant"
        self.evals = 0

    def __call__(self, sdf_fn: Callable, cam: torch.Tensor, dirs: torch.Tensor):
        """Rays (cam [N,3], dirs [N,3]) -> (points [N,3], hit [N], dists [N])."""
        near, far, inter = sphere_intersection(cam, dirs, self.r)
        acc_s = torch.where(inter, near, torch.zeros_like(near))
        acc_e = torch.where(inter, far, torch.zeros_like(far))

        def at(d, m):
            out = torch.zeros_like(d)
            i = m.nonzero()[:, 0]
            if i.numel():
                self.evals += i.numel()
                out[i] = sdf_fn(cam[i] + d[i, None] * dirs[i]).to(out.dtype)
            return out

        def head(unf, nxt):
            cur = torch.where(unf, nxt, torch.zeros_like(nxt))
            cur = torch.where(cur <= self.thresh, torch.zeros_like(cur), cur)
            return cur, unf & (cur > self.thresh)

        curr_s, unf_s = head(inter, at(acc_s, inter))
        curr_e, unf_e = head(inter, at(acc_e, inter))
        it = 0
        while it < self.st_iters and bool((unf_s | unf_e).any()):
            acc_s = acc_s + curr_s
            acc_e = acc_e - curr_e
            nxt_s, nxt_e = at(acc_s, unf_s), at(acc_e, unf_e)
            for j in range(self.ls_iters):
                np_s, np_e = nxt_s < 0, nxt_e < 0
                if not bool((np_s | np_e).any()):
                    break
                f = (1.0 - self.ls_step) * 2.0 ** (-j)
                acc_s = torch.where(np_s, acc_s - f * curr_s, acc_s)
                acc_e = torch.where(np_e, acc_e + f * curr_e, acc_e)
                nxt_s = torch.where(np_s, at(acc_s, np_s), nxt_s)
                nxt_e = torch.where(np_e, at(acc_e, np_e), nxt_e)
            crossed = ~(acc_s < acc_e)
            unf_s, unf_e = unf_s & ~crossed, unf_e & ~crossed
            curr_s, unf_s = head(unf_s, nxt_s)
            curr_e, unf_e = head(unf_e, nxt_e)
            it += 1

        hit = acc_s < acc_e
        dists = acc_s.clone()
        sel = unf_s.nonzero()[:, 0]
        if sel.numel():
            s_hit, s_d = self._sampler(sdf_fn, cam[sel], dirs[sel], acc_s[sel], acc_e[sel])
            dists[sel] = s_d
            hit[sel] = s_hit
        return cam + dists[:, None] * dirs, hit, dists

    def _sampler(self, sdf_fn, cam, dirs, a, b):
        n = self.n_steps
        t = torch.linspace(0.0, 1.0, n, device=cam.device)[None, :]
        z = a[:, None] + t * (b - a)[:, None]
        pts = cam[:, None, :] + z[..., None] * dirs[:, None, :]
        self.evals += pts.shape[0] * n
        sd = sdf_fn(pts.reshape(-1, 3)).reshape(-1, n).to(z.dtype)
        idx = torch.argmin(torch.sign(sd) * torch.arange(n, 0, -1, device=cam.device,
                                                         dtype=sd.dtype), dim=-1)

        def take(x, i):
            return torch.gather(x, 1, i[:, None])[:, 0]

        sd_hi = take(sd, idx)
        surface = sd_hi < 0
        d = torch.where(surface, take(z, idx), take(z, torch.argmin(sd, dim=-1)))
        prev = (idx - 1) % n
        root = self._root(sdf_fn, take(sd, prev), sd_hi, take(z, prev), take(z, idx), cam, dirs)
        return surface, torch.where(surface, root, d)

    def _root(self, sdf_fn, s_lo, s_hi, z_lo, z_hi, cam, dirs):
        work = (s_lo > 0) & (s_hi < 0) & (z_hi > z_lo)

        def predict():
            if self.secant:
                return torch.clamp(-s_lo * (z_hi - z_lo) / (s_hi - s_lo + 1e-8) + z_lo, 0.0, 2e1)
            return (z_lo + z_hi) / 2.0

        z = predict()
        i = 0
        while i < self.n_root and bool(work.any()):
            self.evals += cam.shape[0]
            s = sdf_fn(cam + z[:, None] * dirs).to(z.dtype)
            lo, hi = s > 0, (s < 0) if self.secant else ~(s > 0)
            z_lo, s_lo = torch.where(lo, z, z_lo), torch.where(lo, s, s_lo)
            z_hi, s_hi = torch.where(hi, z, z_hi), torch.where(hi, s, s_hi)
            z = predict()
            work = work & ((z_hi - z_lo) > 1e-6)
            i += 1
        return z
