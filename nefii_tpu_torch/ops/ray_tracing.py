"""Sphere tracing through a learned SDF (counterpart of
nefii_tpu/ops/ray_tracing.py).

Same numerics as the JAX RayTracer, restructured for eager PyTorch: where the
JAX tracer evaluates the SDF on every ray each iteration and masks the
results (static shapes for XLA), this tracer gathers the rays that still need
an evaluation and evaluates only those. Those are the dense semantics
(`budget=None`) of the JAX tracer, without its static compaction budgets, so
every overflow counter is 0.

The SDF is a closure `sdf_fn(pts [P,3]) -> [P]`. With `training=True` the
tracer adds the JAX tracer's training extras: the points of the rays that
miss, for the mask loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from nefii_tpu_torch.utils.camera import get_sphere_intersection
from nefii_tpu_torch.utils.telemetry import host_sync, span


def eval_chunked(sdf_fn: Callable, pts: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """sdf_fn over [P,3] points in chunks of at most `chunk` (bounds peak memory)."""
    P = pts.shape[0]
    if not chunk or P <= chunk:
        return sdf_fn(pts)
    return torch.cat([sdf_fn(pts[i:i + chunk]) for i in range(0, P, chunk)])


class TraceResult(NamedTuple):
    points: torch.Tensor       # [N, 3] surface (or fallback) points
    object_mask: torch.Tensor  # [N] bool: the network thinks the ray hit
    dists: torch.Tensor        # [N] distance along the ray
    # SDF point evaluations this tracer executed. It counts only the gathered
    # rays it evaluates, so it is lower than the JAX tracer's dense count
    # (which evaluates every ray each iteration) for the same trace.
    n_evals: int = 0


@dataclass(frozen=True)
class RayTracer:
    object_bounding_sphere: float = 1.0
    sdf_threshold: float = 5.0e-5
    line_search_step: float = 0.5
    line_step_iters: int = 1
    sphere_tracing_iters: int = 10
    n_steps: int = 100
    n_rootfind_steps: int = 8
    sdf_chunk: int = 100_000
    rootfind_method: str = "bisection"

    def __post_init__(self):
        if self.rootfind_method not in ("bisection", "secant"):
            raise ValueError(f"rootfind_method {self.rootfind_method!r}: bisection or secant")

    # ------------------------------------------------------------------
    def __call__(
        self,
        sdf_fn: Callable,
        cam_loc: torch.Tensor,         # [B, 3]
        object_mask: torch.Tensor,     # [B*S] bool
        ray_directions: torch.Tensor,  # [B, S, 3]
        training: bool = False,
        sphere_trace_fn: Optional[Callable] = None,
        gen: Optional[torch.Generator] = None,
        steps01: Optional[torch.Tensor] = None,
    ) -> TraceResult:
        """Trace the rays. `sphere_trace_fn` replaces the bidirectional trace
        (the K3 kernel, with the 6-output contract of the JAX
        `_sphere_trace`); the fallback sampler and, with `training`, the
        min-SDF points of the rays that miss keep using `sdf_fn`. The
        min-SDF points share one [n_steps] uniform vector, `steps01`, drawn
        from `gen` unless given."""
        B, S, _ = ray_directions.shape
        N = B * S
        si, mask_intersect = get_sphere_intersection(
            cam_loc, ray_directions, r=self.object_bounding_sphere)
        cam = cam_loc[:, None, :].expand(B, S, 3).reshape(N, 3)
        dirs = ray_directions.reshape(N, 3)
        near = si[..., 0].reshape(N)
        far = si[..., 1].reshape(N)
        mask_intersect = mask_intersect.reshape(N)
        object_mask = object_mask.reshape(N)

        with span("sphere_trace"):
            if sphere_trace_fn is not None:
                acc_start, acc_end, unfinished_start, min_dis, max_dis, n_evals = sphere_trace_fn(
                    cam, dirs, mask_intersect, near, far)
            else:
                acc_start, acc_end, unfinished_start, n_evals = self._sphere_trace(
                    sdf_fn, cam, dirs, mask_intersect, near, far)
                zero = torch.zeros_like(near)
                min_dis = torch.where(mask_intersect, near, zero)
                max_dis = torch.where(mask_intersect, far, zero)

        network_object_mask = acc_start < acc_end
        dists = acc_start.clone()
        with host_sync("sampler.unfinished"):
            sel = unfinished_start.nonzero()[:, 0]
        if sel.numel():
            # fallback sampler for the rays the tracer did not converge on
            with span("ray_sampler"):
                _, s_obj, s_dists, s_evals = self._ray_sampler_dense(
                    sdf_fn, cam[sel], dirs[sel], object_mask[sel], acc_start[sel], acc_end[sel],
                    training)
            n_evals += s_evals
            dists[sel] = s_dists
            network_object_mask[sel] = s_obj
        if training:
            with span("min_sdf_points"):
                dists, m_evals = self._miss_points(
                    sdf_fn, cam, dirs, object_mask, network_object_mask, unfinished_start,
                    mask_intersect, acc_start, min_dis, max_dis, dists, gen, steps01)
            n_evals += m_evals
        points = cam + dists[:, None] * dirs
        return TraceResult(points, network_object_mask, dists, n_evals)

    def _miss_points(self, sdf_fn, cam, dirs, object_mask, network_object_mask, sampler_mask,
                     mask_intersect, acc_start, min_dis, max_dis, dists, gen, steps01):
        """Training extras for the mask loss: rays that missed the sphere get
        the point of the ray closest to the origin, rays inside it that
        missed the surface (or disagree with the object mask) the point of
        minimal SDF. -> (dists, evaluations)."""
        in_mask = ~network_object_mask & object_mask & ~sampler_mask
        out_mask = ~object_mask & ~sampler_mask
        mask_left_out = (in_mask | out_mask) & ~mask_intersect
        proj_dis = -(dirs * cam).sum(-1)
        dists = torch.where(mask_left_out, proj_dis, dists)
        mask = (in_mask | out_mask) & mask_intersect
        min_dis = torch.where(network_object_mask & out_mask, acc_start, min_dis)
        if steps01 is None:
            steps01 = torch.rand(self.n_steps, generator=gen, device=cam.device)
        with host_sync("tracer.miss_points"):
            sel = mask.nonzero()[:, 0]
        if not sel.numel():
            return dists, 0
        dists = dists.clone()
        dists[sel] = self._minimal_sdf_points(sdf_fn, cam[sel], dirs[sel], min_dis[sel],
                                              max_dis[sel], steps01.to(cam.device))
        return dists, sel.numel() * self.n_steps

    def _minimal_sdf_points(self, sdf_fn, cam, dirs, min_dis, max_dis, steps01):
        """The point of minimal SDF among n_steps points along each ray, at the
        shared fractions `steps01` of [min_dis, max_dis]."""
        n = self.n_steps
        steps = steps01[None, :] * (max_dis - min_dis)[:, None] + min_dis[:, None]
        pts = cam[:, None, :] + steps[..., None] * dirs[:, None, :]
        sd = eval_chunked(sdf_fn, pts.reshape(-1, 3), self.sdf_chunk).reshape(-1, n)
        mi = torch.argmin(sd, dim=-1)
        return torch.gather(steps, 1, mi[:, None])[:, 0]

    # ------------------------------------------------------------------
    def _sdf_at(self, sdf_fn, cam, dirs, acc_s, acc_e, m_s, m_e):
        """SDF at the start points of the m_s rays and the end points of the
        m_e rays in one call; zero elsewhere. Returns (sd_s, sd_e, n_evaluated)."""
        with host_sync("tracer.gather"):
            i_s = m_s.nonzero()[:, 0]
        with host_sync("tracer.gather"):
            i_e = m_e.nonzero()[:, 0]
        pts = torch.cat([cam[i_s] + acc_s[i_s, None] * dirs[i_s],
                         cam[i_e] + acc_e[i_e, None] * dirs[i_e]])
        sd = eval_chunked(sdf_fn, pts, self.sdf_chunk) if pts.shape[0] else pts[:, 0]
        sd_s = torch.zeros_like(acc_s)
        sd_e = torch.zeros_like(acc_e)
        sd_s[i_s] = sd[: i_s.numel()].to(sd_s.dtype)
        sd_e[i_e] = sd[i_s.numel():].to(sd_e.dtype)
        return sd_s, sd_e, pts.shape[0]

    def _head(self, unf_s, unf_e, next_s, next_e):
        thresh = self.sdf_threshold
        zero = torch.zeros_like(next_s)
        curr_s = torch.where(unf_s, next_s, zero)
        curr_s = torch.where(curr_s <= thresh, zero, curr_s)
        curr_e = torch.where(unf_e, next_e, zero)
        curr_e = torch.where(curr_e <= thresh, zero, curr_e)
        return curr_s, curr_e, unf_s & (curr_s > thresh), unf_e & (curr_e > thresh)

    def _trace_phase(self, sdf_fn, cam, dirs, state, max_iter):
        """Bidirectional trace iterations until no ray is live or `max_iter`.

        state = [it, curr_s, curr_e, unf_s, unf_e, acc_s, acc_e, n_ev]."""
        it, curr_s, curr_e, unf_s, unf_e, acc_s, acc_e, n_ev = state
        while it < max_iter:
            with host_sync("tracer.live_any"):
                if not bool((unf_s | unf_e).any()):
                    break
            acc_s = acc_s + curr_s
            acc_e = acc_e - curr_e
            next_s, next_e, k = self._sdf_at(sdf_fn, cam, dirs, acc_s, acc_e, unf_s, unf_e)
            n_ev += k
            # back-step line search for rays that crossed the surface
            j = 0
            while j < self.line_step_iters:
                np_s, np_e = next_s < 0, next_e < 0
                with host_sync("tracer.crossed_any"):
                    if not bool((np_s | np_e).any()):
                        break
                factor = (1.0 - self.line_search_step) * 2.0 ** (-j)
                acc_s = torch.where(np_s, acc_s - factor * curr_s, acc_s)
                acc_e = torch.where(np_e, acc_e + factor * curr_e, acc_e)
                sd_s, sd_e, k = self._sdf_at(sdf_fn, cam, dirs, acc_s, acc_e, np_s, np_e)
                n_ev += k
                next_s = torch.where(np_s, sd_s, next_s)
                next_e = torch.where(np_e, sd_e, next_e)
                j += 1
            not_crossed = acc_s < acc_e
            unf_s = unf_s & not_crossed
            unf_e = unf_e & not_crossed
            curr_s, curr_e, unf_s, unf_e = self._head(unf_s, unf_e, next_s, next_e)
            it += 1
        return [it, curr_s, curr_e, unf_s, unf_e, acc_s, acc_e, n_ev]

    def _sphere_trace(self, sdf_fn, cam, dirs, mask_intersect, near, far):
        """Bidirectional sphere tracing -> (acc_start, acc_end, unfinished_start, n_evals)."""
        zero = torch.zeros_like(near)
        acc_start = torch.where(mask_intersect, near, zero)
        acc_end = torch.where(mask_intersect, far, zero)
        next_s, next_e, n_ev = self._sdf_at(
            sdf_fn, cam, dirs, acc_start, acc_end, mask_intersect, mask_intersect)
        curr_s, curr_e, unf_s, unf_e = self._head(mask_intersect, mask_intersect, next_s, next_e)
        state = [0, curr_s, curr_e, unf_s, unf_e, acc_start, acc_end, n_ev]
        _, _, _, unf_s, _, acc_s, acc_e, n_ev = self._trace_phase(
            sdf_fn, cam, dirs, state, self.sphere_tracing_iters)
        return acc_s, acc_e, unf_s, n_ev

    # ------------------------------------------------------------------
    def _ray_sampler_dense(self, sdf_fn, cam, dirs, object_mask, acc_start, acc_end,
                           training=False):
        """n_steps-point sign-change sampler + rootfind (`rootfind_method`:
        bisection or secant) on the given rays. In
        training only the rays inside the object mask take the root."""
        N, n = cam.shape[0], self.n_steps
        intervals = torch.linspace(0.0, 1.0, n, device=cam.device)[None, :]
        pts_intervals = acc_start[:, None] + intervals * (acc_end - acc_start)[:, None]
        points = cam[:, None, :] + pts_intervals[..., None] * dirs[:, None, :]
        sdf_val = eval_chunked(sdf_fn, points.reshape(-1, 3), self.sdf_chunk).reshape(N, n)

        # first sign flip: sign * descending arange puts argmin on the first min
        tmp = torch.sign(sdf_val) * torch.arange(n, 0, -1, device=cam.device, dtype=sdf_val.dtype)
        idx = torch.argmin(tmp, dim=-1)

        def take(arr, i):
            return torch.gather(arr, 1, i[:, None])[:, 0]

        sampler_dists = take(pts_intervals, idx)
        sdf_at_idx = take(sdf_val, idx)
        net_surface = sdf_at_idx < 0
        # non-surface rays: the point of minimal SDF instead
        p_out = ~(object_mask & net_surface)
        sampler_dists = torch.where(p_out, take(pts_intervals, torch.argmin(sdf_val, dim=-1)),
                                    sampler_dists)

        prev = (idx - 1) % n  # x[idx-1] wraps at idx == 0, as in the reference
        find_root = self._secant if self.rootfind_method == "secant" else self._bisection
        z_pred, bisect_evals = find_root(
            sdf_fn, take(sdf_val, prev), sdf_at_idx, take(pts_intervals, prev),
            take(pts_intervals, idx), cam, dirs)
        rootfind = (net_surface & object_mask) if training else net_surface
        sampler_dists = torch.where(rootfind, z_pred, sampler_dists)
        sampler_pts = cam + sampler_dists[:, None] * dirs
        return sampler_pts, net_surface, sampler_dists, N * n + bisect_evals

    def _bisection(self, sdf_fn, sdf_low, sdf_high, z_low, z_high, cam, dirs):
        """Masked bisection. Every ray of the batch moves while any ray still
        works, as in the JAX tracer. The batch here is the sampler's rays only,
        while the JAX tracer's dense batch also holds the converged rays, whose
        brackets can keep its loop running longer. A bracketed ray's root then
        differs by less than the 1e-6 bracket width at which it stops; a ray
        without a bracket (idx == 0 wraps to the far end) keeps moving for as
        many iterations as its batch runs, so its point can differ more."""
        work = (sdf_low > 0) & (sdf_high < 0) & (z_high > z_low)
        z_mid = (z_low + z_high) / 2.0
        i = 0
        while i < self.n_rootfind_steps:
            with host_sync("rootfind.any"):
                if not bool(work.any()):
                    break
            sdf_mid = eval_chunked(sdf_fn, cam + z_mid[:, None] * dirs, self.sdf_chunk)
            ind_low = sdf_mid > 0
            z_low = torch.where(ind_low, z_mid, z_low)
            z_high = torch.where(~ind_low, z_mid, z_high)
            z_mid = (z_low + z_high) / 2.0
            work = work & ((z_high - z_low) > 1e-6)
            i += 1
        return z_mid, i * cam.shape[0]

    def _secant(self, sdf_fn, sdf_low, sdf_high, z_low, z_high, cam, dirs):
        """Masked secant rootfind on the same batch as `_bisection` (and with
        its caveat for the rays without a bracket): each step evaluates the
        secant's zero and keeps it as the low or the high end by its sign."""
        eps = 1e-8

        def predict(sdf_low, sdf_high, z_low, z_high):
            z = -sdf_low * (z_high - z_low) / (sdf_high - sdf_low + eps) + z_low
            return torch.clamp(z, 0.0, 2e1)

        work = (sdf_low > 0) & (sdf_high < 0) & (z_high > z_low)
        z_pred = predict(sdf_low, sdf_high, z_low, z_high)
        i = 0
        while i < self.n_rootfind_steps:
            with host_sync("rootfind.any"):
                if not bool(work.any()):
                    break
            sdf_mid = eval_chunked(sdf_fn, cam + z_pred[:, None] * dirs, self.sdf_chunk)
            ind_low, ind_high = sdf_mid > 0, sdf_mid < 0
            z_low = torch.where(ind_low, z_pred, z_low)
            sdf_low = torch.where(ind_low, sdf_mid, sdf_low)
            z_high = torch.where(ind_high, z_pred, z_high)
            sdf_high = torch.where(ind_high, sdf_mid, sdf_high)
            z_pred = predict(sdf_low, sdf_high, z_low, z_high)
            work = work & ((z_high - z_low) > 1e-6)
            i += 1
        return z_pred, i * cam.shape[0]
