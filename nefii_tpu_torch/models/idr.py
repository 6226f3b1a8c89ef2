"""IDRNetwork — the composite render pipeline (counterpart of
nefii_tpu/models/idr.py).

Owns the implicit SDF net, the IDR radiance net, the envmap/material net and
the tracers. `forward_with_uv` renders pixels (multi-ray AA reduced by
`mean_pixel`, or with `fast_multi_ray` one pixel-mean ray traced and shaded
a pixel and its R Monte-Carlo samples averaged) with any of the JAX
package's 13 render types: the 12 of `PT_RENDER_TYPES` (path traced by
ops/path_tracing.py, `path_tracing_sg` its one-sample warped-SG prototype)
or `sg` (the closed-form SG renderer of the PhySG baseline), and the light
(SG mixture or constant map) as background of the rays that miss. With
`training=True` and `freeze_geo=True` (Step 2 on a frozen geometry) it keeps
the autograd graph through the rendering and material networks and the
light; the trace, the
surface points and every output of the implicit net are values, as the JAX
package's stop-gradients make them. With `freeze_geo=False` the geometry
trains too: the trace stays a value, and the implicit net keeps its graph
through the surface points of IDR eq. 3 (`sample_network`), the mask loss's
sdf, the eikonal gradients (second-order autograd) and the shading's
feature and normal; at the secondary hits the features stay attached and the
normals are detached. The pose may be a [B,7] quaternion + translation
that requires grad (camera training): the trace runs on detached rays, and
the pose's gradient comes through the view directions of the shading (and
the background) and, with live geometry, through the surface points of IDR
eq. 3. `forward_with_point` shades given points for the secondary
self-distillation step, with the normals detached.

Differences by design from the JAX pipeline, results unchanged:
  * Only hit rays are shaded (a dynamic gather; the JAX pipeline shades all
    rays and masks, or compacts to a static `shade_fraction` budget). Miss
    rays get the same defaults.
  * The static compaction budgets do not exist; every `OVERFLOW_KEYS` entry
    of the output is 0.
  * `use_fused_sdf` routes the tracer's SDF queries through the K1 kernel and
    the shading's sdf/feature/normal through the K2 kernel for CUDA tensors,
    and through their plain PyTorch versions for CPU tensors. K2 has no
    backward, so it serves only value-only shading (frozen geometry, or not
    training), as in the JAX package; with live geometry the shading runs
    the plain graph-keeping sdf_feature_grad.
    `use_fused_trace` runs the bidirectional trace of the primary and the
    secondary tracer through the K3 kernel. A kernel that fails raises;
    nothing falls back silently.

In training the secondary-hit pool of the self-distillation step is the JAX
pipeline's: the shaded rays' secondary hits, and those traced from the points
of the rays that missed (which the JAX pipeline shades too), in its
[strategy, ray] order. The pool is built only where it is asked for
(`secondary_limit` > 0: the trainer's distilling steps), and the missed
rays' part only for the strategies that hold the first `secondary_limit`
hits.

`remat_strategies` checkpoints each MIS strategy's secondary shading, and
`forward_with_uv(remat=True)` (the trainer's `train.remat`) checkpoints what
is differentiable after the primary trace (`torch.utils.checkpoint`) in
two regions -- one forward of the eikonal and traced points (the mask
loss's sdf, the eikonal gradients), and the shading -- each recomputed on
its own in the backward in place of keeping its activations. The primary
trace stays outside, so the backward does not re-trace it; the recompute
redraws the Monte-Carlo samples from the generator state of the first run.
No region calls autograd.grad: the normals and eikonal gradients come from
ImplicitNetwork._sdf_input_grad, tensor ops that checkpointing recomputes
as it recomputes any other.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.models.material import EnvmapMaterialNetwork
from nefii_tpu_torch.models.rendering import RenderingNetwork
from nefii_tpu_torch.models.sample_network import sample_network
from nefii_tpu_torch.ops import path_tracing as ptr
from nefii_tpu_torch.ops import sampling
from nefii_tpu_torch.ops.kernels.fused_mlp import build_fused_sdf, build_fused_sdf_feature_grad
from nefii_tpu_torch.ops.kernels.fused_trace import build_fused_sphere_trace
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.ops.sg import render_with_sg, safe_norm
from nefii_tpu_torch.utils.camera import get_camera_params
from nefii_tpu_torch.utils.telemetry import host_sync, span

PT_RENDER_TYPES = {
    # the warped-SG prototype (ops/path_tracing.py pt_render_with_sg)
    "path_tracing_sg": dict(),
    "path_tracing": dict(strategies=("cos", "brdf"), shadow=None),
    "path_tracing_shadow": dict(strategies=("cos", "brdf", "mix_sg"), shadow="hard"),
    "path_tracing_diff_shadow": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="soft", diff_geo=True,
        sphere_fallback=True,
    ),
    "pt_render_diff_shadow_indirect": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=True,
        sphere_fallback=True,
    ),
    "pt_render_diff_shadow_indirect_mlp": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=True,
    ),
    "pt_render_indirect_mlp": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=False,
    ),
    "pt_render_indirect_mlp_memsave": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=False,
        speed_first=False,
    ),
    "pt_render_shadow_indirect_mlp_envmap": dict(
        strategies=("cos", "brdf", "env2d"), shadow="indirect", diff_geo=False,
        light_type="constant",
    ),
    "pt_render_shadow_indirect_mlp_envmap_memsave": dict(
        strategies=("cos", "brdf", "env2d"), shadow="indirect", diff_geo=False,
        light_type="constant", speed_first=False,
    ),
    "pt_render_diff_shadow_indirect_blend": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=True,
        sphere_fallback=True, blend_materials=True,
    ),
    "pt_render_diff_shadow2_indirect_blend": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=True,
        blend_materials=True,
    ),
}
PT_SG_RENDER_TYPE = "path_tracing_sg"
# the closed-form SG render (ops/sg.py render_with_sg): no secondary rays
SG_RENDER_TYPE = "sg"

OVERFLOW_KEYS = (
    "sampler_overflow", "minsdf_overflow", "shade_overflow",
    "secondary_overflow", "trace_overflow", "indirect_overflow",
    "cull_overflow", "rootfind_overflow",
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The JAX tracer's static compaction budgets: caps that exist only because XLA
# needs static shapes, exact while they are not exceeded. The port's tracer
# gathers, which is their `None` (dense) setting, so a conf's values are dropped.
_STATIC_BUDGET_KEYS = ("sampler_budget", "minsdf_budget", "rootfind_budget", "compact_after",
                       "compact_budget")


def _dense_tracer_conf(tracer_conf: Dict) -> Dict:
    return {k: v for k, v in tracer_conf.items() if k not in _STATIC_BUDGET_KEYS}


def checkpoint_drawing(fn, gen: torch.Generator, *args):
    """torch.utils.checkpoint of fn(*args), where fn draws from `gen`: the
    recompute in the backward draws what the first run drew (checkpoint
    restores only the global RNG states), and leaves `gen` as it found it."""
    state = gen.get_state()
    ran = []

    def run(*a):
        if not ran:
            ran.append(True)
            return fn(*a)
        now = gen.get_state()
        gen.set_state(state)
        try:
            return fn(*a)
        finally:
            gen.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class IDRNetwork(nn.Module):
    def __init__(
        self,
        feature_vector_size: int,
        implicit_network: ImplicitNetwork,
        rendering_network: RenderingNetwork,
        envmap_material_network: EnvmapMaterialNetwork,
        ray_tracer: RayTracer,
        render_type: str = "pt_render_indirect_mlp",
        fast_multi_ray: bool = False,
        render_background: bool = False,
        correct_normal: bool = False,
        use_fused_sdf: bool = False,
        fused_sdf_dtype: str = "float32",
        use_fused_trace: bool = False,
        secondary_ray_tracer: Optional[RayTracer] = None,
        object_bounding_sphere: float = 1.0,
        remat_strategies: bool = False,
    ):
        super().__init__()
        self.fast_multi_ray = fast_multi_ray
        self.feature_vector_size = feature_vector_size
        self.implicit_network = implicit_network
        self.rendering_network = rendering_network
        self.envmap_material_network = envmap_material_network
        self.ray_tracer = ray_tracer
        self.secondary_ray_tracer = secondary_ray_tracer
        self.render_type = render_type
        self.render_background = render_background
        self.correct_normal = correct_normal
        self.use_fused_sdf = use_fused_sdf
        self.fused_sdf_dtype = _DTYPES[fused_sdf_dtype]
        self.use_fused_trace = use_fused_trace
        self.object_bounding_sphere = object_bounding_sphere
        self.remat_strategies = remat_strategies

    # ------------------------------------------------------------------
    @classmethod
    def from_conf(cls, conf, device=None, seed: int = 0) -> "IDRNetwork":
        """Build from a `model{...}` conf section; parameters get the seeded
        init (geometric init for the SDF) and live on `device`."""
        fvs = conf.get_int("feature_vector_size")
        correct_normal = conf.get_bool("correct_normal", default=False)
        implicit = ImplicitNetwork(feature_vector_size=fvs, device=device,
                                   **conf.get_config("implicit_network").as_plain_dict())
        rendering = RenderingNetwork(feature_vector_size=fvs, device=device,
                                     **conf.get_config("rendering_network").as_plain_dict())
        material = EnvmapMaterialNetwork(
            correct_normal=correct_normal, feature_vector_size=fvs, device=device,
            **conf.get_config("envmap_material_network").as_plain_dict())
        tracer_conf = _dense_tracer_conf(conf.get_config("ray_tracer").as_plain_dict())
        tracer = RayTracer(**tracer_conf)
        secondary = None
        try:
            sec_over = conf.get_config("secondary_ray_tracer").as_plain_dict()
        except Exception:
            sec_over = None
        if sec_over:
            secondary = RayTracer(**{**tracer_conf, **_dense_tracer_conf(sec_over)})
        model = cls(
            feature_vector_size=fvs,
            implicit_network=implicit,
            rendering_network=rendering,
            envmap_material_network=material,
            ray_tracer=tracer,
            render_type=conf.get_string("render_type", default="sg"),
            fast_multi_ray=conf.get_bool("fast_multi_ray", default=False),
            render_background=conf.get_bool("render_background", default=False),
            correct_normal=correct_normal,
            use_fused_sdf=conf.get_bool("use_fused_sdf", default=False),
            fused_sdf_dtype=conf.get_string("fused_sdf_dtype", default="float32"),
            use_fused_trace=conf.get_bool("use_fused_trace", default=False),
            secondary_ray_tracer=secondary,
            object_bounding_sphere=conf.get_float("ray_tracer.object_bounding_sphere"),
            remat_strategies=conf.get_bool("remat_strategies", default=False),
        )
        model.reset_parameters(seed)
        return model

    def reset_parameters(self, seed: int) -> None:
        dev = self.implicit_network.layers[0].b.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for net in (self.implicit_network, self.rendering_network, self.envmap_material_network):
            net.reset_parameters(gen)

    def _render_spec(self) -> Optional[Dict]:
        """The path-tracing settings of render_type, or None for "sg". Raises
        for a type that does not exist; the check waits for the first
        render, as a model that is never rendered (Step 1's) needs none."""
        if self.render_type == SG_RENDER_TYPE:
            return None
        if self.render_type not in PT_RENDER_TYPES:
            raise ValueError(f"render_type {self.render_type!r}: one of "
                             f"{sorted([*PT_RENDER_TYPES, SG_RENDER_TYPE])}")
        return PT_RENDER_TYPES[self.render_type]

    # ------------------------------------------------------------------
    def _sdf_closure(self):
        """SDF closure for the tracers: the K1 kernel path when use_fused_sdf."""
        imp = self.implicit_network
        if self.use_fused_sdf:
            return build_fused_sdf(imp, self.fused_sdf_dtype)
        return imp.sdf

    def _sfg_closure(self, value_only: bool = True, normal_graph: bool = True):
        """(sdf, feature, grad) closure for shading, where the whole policy
        of the implicit net's graph is decided: the K2 kernel path when
        use_fused_sdf and the outputs are values (frozen geometry, not
        training, or the secondary-hit pool); otherwise the plain
        sdf_feature_grad, which keeps the graph unless value_only, the
        gradient's (the normal's) only where `normal_graph`."""
        imp = self.implicit_network
        if value_only and self.use_fused_sdf:
            return build_fused_sdf_feature_grad(imp)
        return lambda pts: imp.sdf_feature_grad(pts, value_only, normal_graph)

    def _fused_trace_closure(self, tracer: RayTracer):
        """The K3 whole-trace closure for `tracer` when use_fused_trace, else
        None (the gathered trace through sdf_fn). The trace is fp32: K3 runs
        the fp32 chain whatever fused_sdf_dtype says, as the TPU kernel does."""
        if self.use_fused_trace:
            return build_fused_sphere_trace(self.implicit_network, tracer)
        return None

    def scene_fns(self, sdf_fn, sfg_fn, value_only: bool = True) -> ptr.SceneFns:
        """The path tracer's closures: the secondary tracer (K1 through
        `sdf_fn`, K3 when use_fused_trace), the plain implicit net and its
        gradient (values when `value_only`, else with their graph, the
        gradient by `_sdf_input_grad`), the radiance net, and `sfg_fn`."""
        self._render_spec()
        tracer = self.secondary_ray_tracer or self.ray_tracer
        trace_fn = self._fused_trace_closure(tracer)
        imp = self.implicit_network

        def trace(origins, dirs, gen=None, training=False, steps01=None):
            with torch.no_grad():
                res = tracer(sdf_fn, origins, torch.ones(origins.shape[0], dtype=torch.bool,
                                                         device=origins.device),
                             dirs[:, None, :], training=training, sphere_trace_fn=trace_fn,
                             gen=gen, steps01=steps01)
            return res.points, res.object_mask, res.dists, res.n_evals

        def implicit(pts):
            with torch.set_grad_enabled(not value_only and torch.is_grad_enabled()):
                return imp(pts)

        return ptr.SceneFns(trace=trace, implicit=implicit,
                            implicit_grad=lambda pts: imp.sdf_feature_grad(pts, value_only)[2],
                            radiance=self.rendering_network, implicit_with_grad=sfg_fn,
                            feature_size=self.feature_vector_size,
                            bounding_sphere=self.object_bounding_sphere)

    # ------------------------------------------------------------------
    def forward_with_uv(self, inputs: Dict[str, torch.Tensor], gen: torch.Generator, *,
                        training: bool = False, freeze_geo: bool = False,
                        fake_roughness: bool = False, fake_specular: bool = False,
                        steps01: Optional[torch.Tensor] = None,
                        secondary_limit: int = 0, remat: bool = False,
                        all_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                        secondary_steps01: Optional[torch.Tensor] = None):
        """Render the rays of `inputs` (uv [B,S,2] or multi-ray [B,S,R,2],
        pose [B,4,4] or [B,7], intrinsics, object_mask). Without `training`
        no graph is kept. With `fast_multi_ray` a multi-ray batch traces the
        pixel-mean uv [B,S] and the path tracer repeats each shaded point R
        times, its outputs averaged per pixel.
        `steps01` injects the tracer's min-SDF step vector (training), and
        `secondary_steps01` the secondary tracer's (training, `diff_geo`).

        With `training` and not `freeze_geo` the geometry trains: the output
        holds the eikonal gradients `grad_theta` at N//2 points uniform in
        the bounding box (or `inputs["eik_override"]`) and at the traced
        points, and the shading runs at the rays that hit and are in the
        object mask, at the points of IDR eq. 3. `remat` checkpoints all of
        it (the trace excepted).

        With `training` and `secondary_limit` > 0 a path-traced render's
        output holds the secondary-hit pool [S', N] (`secondary_points`,
        `secondary_mask`, `secondary_dir`) of the first S' strategies, equal
        to the JAX pipeline's: S' is the fewest strategies whose hits reach
        the limit, or every strategy (a limit of S * N or more gives the
        whole pool). In a multi-process run `inputs` is this rank's slice
        of the batch and `all_reduce` sums a tensor over the ranks: each
        strategy's hit count is summed, so that every rank keeps the
        strategies the whole batch's first `secondary_limit` hits need."""
        self._render_spec()
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            return self._forward_with_uv(inputs, gen, training, training and not freeze_geo,
                                         fake_roughness, fake_specular, steps01,
                                         secondary_limit, remat, all_reduce, secondary_steps01)

    def _forward_with_uv(self, inputs, gen, training, live, fake_roughness, fake_specular,
                         steps01, secondary_limit, remat, all_reduce, secondary_steps01):
        intrinsics, uv, pose = inputs["intrinsics"], inputs["uv"], inputs["pose"]
        object_mask = inputs["object_mask"].reshape(-1)
        multi_ray = uv.dim() == 4
        fast = multi_ray and self.fast_multi_ray
        R = 1
        if multi_ray:
            B, S, R, D = uv.shape
            if fast:
                uv = uv.mean(dim=2)
            else:
                uv = uv.reshape(B, S * R, D)
                object_mask = object_mask.reshape(B, S, 1).expand(B, S, R).reshape(-1)

        ray_dirs, cam_loc = get_camera_params(uv, pose, intrinsics)
        batch_size, num_pixels, _ = ray_dirs.shape
        N = batch_size * num_pixels

        sdf_fn = self._sdf_closure()
        imp = self.implicit_network
        with torch.no_grad(), span("primary_trace"):
            # the trace, the points and the sdf carry no gradient
            trace = self.ray_tracer(sdf_fn, cam_loc, object_mask, ray_dirs, training=training,
                                    sphere_trace_fn=self._fused_trace_closure(self.ray_tracer),
                                    gen=gen, steps01=steps01)
            sdf_output = imp(trace.points)[:, 0:1] if training and not live else None
        points, network_object_mask = trace.points, trace.object_mask
        ray_dirs_flat = ray_dirs.reshape(-1, 3)
        view_dirs = -ray_dirs_flat
        grad_theta = None
        shade_kw = dict(training=training, fake_roughness=fake_roughness,
                        fake_specular=fake_specular, multi_ray_R=R if fast else 1,
                        secondary_steps01=secondary_steps01)

        if live:
            surface_mask = network_object_mask & object_mask
            eik_pts = inputs.get("eik_override")
            if eik_pts is None:
                obs = self.object_bounding_sphere
                eik_pts = torch.rand(N // 2, 3, generator=gen, device=points.device)
                eik_pts = eik_pts * (2 * obs) - obs
            cam_flat = cam_loc[:, None, :].expand(batch_size, num_pixels, 3).reshape(-1, 3)
            with host_sync("pipeline.surface"):
                sel = surface_mask.nonzero()[:, 0]
            n_eik = eik_pts.shape[0]
            if remat and torch.is_grad_enabled():
                def region(fn, *a):
                    return checkpoint_drawing(fn, gen, *a)
            else:
                def region(fn, *a):
                    return fn(*a)

            def shade(diff_points, view):
                with span("shading"):
                    return self.get_rbg_value(diff_points, view, gen, sdf_fn, value_only=False,
                                              **shade_kw)

            def geometry(p):
                sdf, _, grad = imp.sdf_feature_grad(p, value_only=False)
                return sdf[n_eik:, None], grad

            # two regions, each recomputed on its own in the backward under
            # remat: one forward of the eikonal and traced points gives the
            # attached sdf and the eikonal gradients
            sdf_output, grad_theta = region(geometry, torch.cat([eik_pts.to(points), points]))
            # IDR eq. 3 at the shaded rays: the traced points' values, with the
            # implicit net's gradient as a value
            surface_grad = grad_theta[n_eik:][sel].detach()
            surface_output = sdf_output[sel]
            diff_points = sample_network(surface_output, surface_output.detach(), surface_grad,
                                         trace.dists[sel, None], cam_flat[sel],
                                         ray_dirs_flat[sel])
            ret = region(shade, diff_points, -ray_dirs_flat[sel])
        else:
            surface_mask = network_object_mask
            # shade the hit rays only; miss rays keep the defaults below
            with host_sync("pipeline.surface"):
                sel = surface_mask.nonzero()[:, 0]
            with span("shading"):
                ret = self.get_rbg_value(points[sel], view_dirs[sel], gen, sdf_fn, **shade_kw)
        em = self.envmap_material_network

        def dense(v, fill):
            out = torch.full((N,) + v.shape[1:], fill, dtype=v.dtype, device=v.device)
            out[sel] = v
            return out

        sg_roughness = ret["sg_roughness"]
        sg_blend = ret["sg_blending_weights"]
        if not em.roughness_mlp:
            if sg_blend is not None:
                sg_roughness = (sg_roughness[None] * sg_blend[..., None]).sum(-2)
            else:
                sg_roughness = sg_roughness[0][None, :].expand(sel.numel(), 1)
        sg_spec = ret["sg_specular_reflectance"]
        if not em.specular_mlp or em.fix_specular_albedo:
            if sg_blend is not None and not em.fix_specular_albedo:
                sg_spec = (sg_spec[None] * sg_blend[..., None]).sum(-2)
            else:
                sg_spec = sg_spec[0][None, :].expand(sel.numel(), 3)

        sg_rgb_values = dense(ret["sg_rgb"], 1.0)
        if self.render_background:
            sg_rgb_values = torch.where(surface_mask[:, None], sg_rgb_values,
                                        self.get_background_rgb(ray_dirs_flat))

        z = torch.zeros((), dtype=torch.int64)
        output = {
            "points": points,
            "idr_rgb_values": dense(ret["idr_rgb"], 1.0),
            "sg_rgb_values": sg_rgb_values,
            "normal_values": dense(ret["normals"], 1.0),
            "network_object_mask": network_object_mask,
            "object_mask": object_mask,
            "sg_diffuse_rgb_values": dense(ret["sg_diffuse_rgb"], 1.0),
            "sg_diffuse_albedo_values": dense(ret["sg_diffuse_albedo"], 1.0),
            "sg_specular_rgb_values": dense(ret["sg_specular_rgb"], 0.0),
            "sg_roughness_values": dense(sg_roughness, 0.0),
            "sg_specular_reflection_values": dense(sg_spec, 0.0),
            # SDF point evaluations executed: primary trace, shading,
            # secondary trace and the secondary hits' fused evaluations
            "n_sdf_evals": trace.n_evals + ret["n_sdf_evals"],
            **{k: z for k in OVERFLOW_KEYS},
        }
        if training:
            output["sdf_output"] = sdf_output
            output["grad_theta"] = grad_theta
            if secondary_limit > 0 and "secondary_mask" in ret:
                # the pool is values in both modes: K2 when use_fused_sdf
                pool_pts, pool_view, pool_sel = points, view_dirs, sel
                if fast:
                    # the path tracer's rays: each pixel's point R times
                    pool_pts, pool_view = (x.repeat_interleave(R, 0) for x in (points, view_dirs))
                    pool_sel = (sel[:, None] * R + torch.arange(R, device=sel.device)).reshape(-1)
                with torch.no_grad(), span("secondary_pool"):
                    pool, n_evals = self._secondary_pool(
                        ret, pool_sel, pool_pts, pool_view, gen, sdf_fn, self._sfg_closure(),
                        secondary_limit, all_reduce=all_reduce,
                        fake_roughness=fake_roughness, fake_specular=fake_specular)
                output.update(pool)
                output["n_sdf_evals"] = output["n_sdf_evals"] + n_evals
        if multi_ray and not fast:
            BS = batch_size * S
            keys = ["idr_rgb_values", "sg_rgb_values", "network_object_mask", "object_mask",
                    "sg_diffuse_rgb_values", "sg_diffuse_albedo_values",
                    "sg_specular_rgb_values", "points", "sg_roughness_values",
                    "sg_specular_reflection_values"]
            if training:
                keys.append("sdf_output")
            for k in keys:
                output[k] = self.mean_pixel(output[k], BS, R)
            output["normal_values"] = self.mean_pixel(output["normal_values"], BS, R, vector=True)
        return output

    forward = forward_with_uv

    # ------------------------------------------------------------------
    def _secondary_pool(self, ret, sel, points, view_dirs, gen, sdf_fn, sfg_fn, limit, *,
                        fake_roughness, fake_specular, all_reduce=None):
        """The secondary hits of every ray, [S', N, ...] in the JAX pipeline's
        [strategy, ray] order, and the SDF evaluations it ran: the shaded
        rays' from their shading (`ret`); for the rays that missed, what the
        JAX pipeline runs to get theirs -- sdf, feature and normal at their
        points, the material net's roughness (blended, as the path tracer
        blends it) where the brdf strategy needs it, each strategy's
        directions and the secondary trace -- strategy by
        strategy until the hits reach `limit`. They need no visibility or
        indirect radiance: their colours are defaults. The hit counts stay on
        the device: one read a strategy decides whether to go on. With
        `all_reduce` (a multi-process run) each strategy's count is summed
        over the ranks once it is complete, one scalar a strategy, and every
        rank runs the loop, its missed rays or none."""
        N = points.shape[0]
        S = ret["secondary_mask"].shape[0]
        pool = {}
        for k, fill in (("secondary_points", 0.0), ("secondary_mask", False),
                        ("secondary_dir", 0.0)):
            v = ret[k]
            pool[k] = torch.full((S, N) + v.shape[2:], fill, dtype=v.dtype, device=v.device)
            pool[k][:, sel] = v
        miss = torch.ones(N, dtype=torch.bool, device=points.device)
        with host_sync("pool.upload"):  # the scalar False, copied to the device
            miss[sel] = False
        with host_sync("pool.misses"):
            miss = miss.nonzero()[:, 0]
        hits = pool["secondary_mask"].reshape(S, N).sum(1)
        n_evals = 0
        if miss.numel() or all_reduce is not None:
            if miss.numel():
                pts = points[miss].detach()
                feats, normals, view = self._surface(pts, view_dirs[miss], sfg_fn)
                n_evals += pts.shape[0]
                em = self.envmap_material_network
                lgt, rough = em.get_lgtSGs(), None
                trace = self.scene_fns(sdf_fn, sfg_fn).trace
            spec = self._render_spec()
            for s, name in enumerate(spec["strategies"]):
                if s > 0:
                    with host_sync("pool.hits"):
                        if int(hits[:s].sum()) >= limit:
                            break
                if miss.numel():
                    if name == "brdf" and rough is None:
                        mat = em(pts, feats, normals, fake_roughness=fake_roughness,
                                 fake_specular=fake_specular)
                        rough, bw = mat["sg_roughness"], mat["sg_blending_weights"]
                        if spec.get("blend_materials") and bw is not None:
                            rough = (rough[None] * bw[..., None]).sum(-2)
                        rough = rough.expand(pts.shape[0], 1) if rough.shape[0] == 1 else rough
                    wi, _ = ptr.sample_direction(name, gen, normals, view, rough, lgt)
                    lp, hm, _, ne = trace(pts, wi)
                    n_evals += ne
                    pool["secondary_points"][s, miss] = lp
                    pool["secondary_mask"][s, miss, 0] = hm
                    pool["secondary_dir"][s, miss] = wi
                    hits[s] += hm.sum()
                if all_reduce is not None:
                    hits[s] = all_reduce(hits[s:s + 1])[0]
        # the strategies before the one whose hits reach the limit, and that one
        with host_sync("pool.keep"):
            keep = min(S, int((hits.cumsum(0) < limit).sum()) + 1)
        return {k: v[:keep] for k, v in pool.items()}, n_evals

    def _surface(self, points, view_dirs, sfg_fn):
        """-> (feature, unit normal, unit view direction) at surface points
        [M,3], with the graph that `sfg_fn` (_sfg_closure) keeps."""
        _, feature_vectors, g = sfg_fn(points)
        if self.feature_vector_size == 0:
            feature_vectors = None
        normals = g / (safe_norm(g) + 1e-6)
        view_dirs = view_dirs / (safe_norm(view_dirs) + 1e-6)
        if self.correct_normal:
            normals = self.envmap_material_network.apply_correct_normal(normals, points)
        return feature_vectors, normals, view_dirs

    # ------------------------------------------------------------------
    def forward_with_point(self, inputs: Dict[str, torch.Tensor], gen: torch.Generator, *,
                           freeze_geo: bool = True, fake_roughness: bool = False,
                           fake_specular: bool = False,
                           secondary_steps01: Optional[torch.Tensor] = None):
        """Secondary self-distillation forward: shade the points [K,R,3] seen
        along ray_dirs [K,R,3] and average over R. Trains with the normals
        detached; without `freeze_geo` the features keep their graph, so the
        implicit net trains through them (the JAX package's
        forward_with_point)."""
        self._render_spec()
        points, ray_dirs = inputs["points"], inputs["ray_dirs"]
        K, R, _ = points.shape
        ret = self.get_rbg_value(points.reshape(-1, 3), -ray_dirs.reshape(-1, 3), gen,
                                 self._sdf_closure(), training=True, value_only=freeze_geo,
                                 normal_graph=False, secondary_steps01=secondary_steps01,
                                 fake_roughness=fake_roughness, fake_specular=fake_specular)
        return {"idr_rgb_values": self.mean_pixel(ret["idr_rgb"], K, R),
                "sg_rgb_values": self.mean_pixel(ret["sg_rgb"], K, R)}

    # ------------------------------------------------------------------
    def get_rbg_value(self, points, view_dirs, gen, sdf_fn, *, training=False,
                      value_only=True, normal_graph=True, fake_roughness=False,
                      fake_specular=False, multi_ray_R=1, secondary_steps01=None):
        """Shading of surface points [M,3] seen along view_dirs [M,3], by
        render_type: the closed-form SG render, or the path tracer. The
        implicit net's sdf, feature and normal are values (K2 or the plain
        sdf_feature_grad) when `value_only`, else they keep their graph, the
        normal's only where `normal_graph` and never at the secondary hits;
        the radiance and material nets keep their graph. `multi_ray_R` > 1
        (fast_multi_ray) path-traces each point R times and averages its
        colours; the secondary-hit pool keeps the M*R rays. The SG render has
        no samples, so it shades each point once. `secondary_steps01` injects
        the secondary tracer's min-SDF vector (a test hook)."""
        sfg_fn = self._sfg_closure(value_only, normal_graph)
        sec_fn = self._sfg_closure(value_only, normal_graph=False)
        feature_vectors, normals, view_dirs = self._surface(points, view_dirs, sfg_fn)
        em = self.envmap_material_network
        idr_rgb = self.rendering_network(points, normals, view_dirs, feature_vectors)
        mat = em(points, feature_vectors, normals, fake_roughness=fake_roughness,
                 fake_specular=fake_specular)
        spec = self._render_spec()
        if spec is None:
            sg_ret = render_with_sg(mat["sg_lgtSGs"], mat["sg_specular_reflectance"],
                                    mat["sg_roughness"], mat["sg_diffuse_albedo"], normals,
                                    view_dirs, blending_weights=mat["sg_blending_weights"])
            sg_ret["n_sdf_evals"] = 0
        else:
            R = multi_ray_R
            pt_in = [mat["sg_specular_reflectance"], mat["sg_roughness"],
                     mat["sg_diffuse_albedo"], normals, view_dirs, points]
            bw = mat["sg_blending_weights"]
            if R > 1:
                # the per-point inputs (JAX idr.py get_rbg_value's rep)
                per_point = [em.specular_mlp and not em.fix_specular_albedo, em.roughness_mlp,
                             True, True, True, True]
                pt_in = [x.repeat_interleave(R, 0) if p else x for x, p in zip(pt_in, per_point)]
                bw = bw.repeat_interleave(R, 0) if bw is not None else None
            if self.render_type == PT_SG_RENDER_TYPE:
                sg_ret = ptr.pt_render_with_sg(gen, mat["sg_lgtSGs"], *pt_in[:5],
                                               training=training)
            else:
                sg_ret = ptr.pt_render_core(
                    gen, mat["sg_lgtSGs"], *pt_in, self.scene_fns(sdf_fn, sec_fn, value_only),
                    blending_weights=bw, training=training,
                    remat_strategies=self.remat_strategies, trace_steps01=secondary_steps01,
                    **spec)
            if R > 1:
                for k in ("sg_rgb", "sg_specular_rgb", "sg_diffuse_rgb", "sg_diffuse_albedo"):
                    sg_ret[k] = self.mean_pixel(sg_ret[k], points.shape[0], R)
        return {
            "normals": normals,
            "idr_rgb": idr_rgb,
            **sg_ret,
            "n_sdf_evals": sg_ret["n_sdf_evals"] + points.shape[0],
            "sg_roughness": mat["sg_roughness"],
            "sg_specular_reflectance": mat["sg_specular_reflectance"],
            "sg_blending_weights": mat["sg_blending_weights"],
        }

    # ------------------------------------------------------------------
    def get_background_rgb(self, light_dir: torch.Tensor) -> torch.Tensor:
        """The light's radiance along the miss rays' directions [N,3]: the SG
        mixture, or the constant map's nearest texel."""
        em = self.envmap_material_network
        if em.light_type == "sg":
            return sampling.sg_light_eval(light_dir, em.get_lgtSGs())
        return sampling.envmap_lookup(light_dir, em.get_lgtSGs())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_sg_rgb(self, mask, normals, view_dirs, diffuse_albedo):
        """Closed-form SG shading of given normals and albedo [N,3] under the
        model's light and global materials; the rays outside `mask` [N] get
        the defaults."""
        normals = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-6)
        view_dirs = view_dirs / (torch.linalg.norm(view_dirs, dim=-1, keepdim=True) + 1e-6)
        em = self.envmap_material_network
        roughness, spec = em.get_base_materials()
        sg_ret = render_with_sg(em.get_lgtSGs(), spec, roughness, diffuse_albedo, normals,
                                view_dirs)
        m = mask[:, None]
        return {
            "sg_rgb_values": torch.where(m, sg_ret["sg_rgb"], 1.0),
            "sg_diffuse_rgb_values": torch.where(m, sg_ret["sg_diffuse_rgb"], 1.0),
            "sg_diffuse_albedo_values": diffuse_albedo,
            "sg_specular_rgb_values": torch.where(m, sg_ret["sg_specular_rgb"], 1.0),
            "sg_roughness": roughness,
            "sg_specular_reflectance": spec,
            "sg_blending_weights": None,
        }

    # ------------------------------------------------------------------
    @staticmethod
    def mean_pixel(x: torch.Tensor, bs: int, r: int, vector: bool = False) -> torch.Tensor:
        """Reduce per-ray values [bs*r, ...] to per-pixel [bs, ...]."""
        no_dim = x.dim() == 1
        if no_dim:
            x = x[:, None]
        x = x.reshape(bs, r, x.shape[-1])
        if vector:
            x = x[:, 0, :]
        elif x.dtype == torch.bool:
            x = x.all(dim=1)
        else:
            x = x.mean(dim=1)
        return x[:, 0] if no_dim else x
