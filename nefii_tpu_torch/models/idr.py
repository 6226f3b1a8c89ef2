"""IDRNetwork — the composite render pipeline (counterpart of
nefii_tpu/models/idr.py).

Owns the implicit SDF net, the IDR radiance net, the envmap/material net and
the tracers. `forward_with_uv` renders pixels (multi-ray AA reduced by
`mean_pixel`) with `render_type = pt_render_indirect_mlp`, and the SG
environment as background of the rays that miss. With `training=True` and
`freeze_geo=True` (Step 2 on a frozen geometry) it keeps the autograd graph
through the rendering and material networks and the light; the trace, the
surface points and every output of the implicit net are values, as the JAX
package's stop-gradients make them. `forward_with_point` shades given points
for the secondary self-distillation step. Unfrozen geometry is not ported.

Differences by design from the JAX pipeline, results unchanged:
  * Only hit rays are shaded (a dynamic gather; the JAX pipeline shades all
    rays and masks, or compacts to a static `shade_fraction` budget). Miss
    rays get the same defaults.
  * The static compaction budgets do not exist; every `OVERFLOW_KEYS` entry
    of the output is 0.
  * `use_fused_sdf` routes the tracer's SDF queries through the K1 kernel and
    the shading's sdf/feature/normal through the K2 kernel for CUDA tensors,
    and through their plain PyTorch versions for CPU tensors.
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
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.profiler import record_function

from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.models.material import EnvmapMaterialNetwork
from nefii_tpu_torch.models.rendering import RenderingNetwork
from nefii_tpu_torch.ops import path_tracing as ptr
from nefii_tpu_torch.ops import sampling
from nefii_tpu_torch.ops.kernels.fused_mlp import build_fused_sdf, build_fused_sdf_feature_grad
from nefii_tpu_torch.ops.kernels.fused_trace import build_fused_sphere_trace
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.ops.sg import safe_norm
from nefii_tpu_torch.utils.camera import get_camera_params

PT_RENDER_TYPES = {
    "pt_render_indirect_mlp": dict(
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=False,
    ),
}

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
    ):
        super().__init__()
        if render_type not in PT_RENDER_TYPES:
            raise NotImplementedError(f"render_type {render_type!r}: the port renders "
                                      f"{sorted(PT_RENDER_TYPES)}")
        if fast_multi_ray:
            raise NotImplementedError("fast_multi_ray is not ported")
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
        )
        model.reset_parameters(seed)
        return model

    def reset_parameters(self, seed: int) -> None:
        dev = self.implicit_network.layers[0].b.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for net in (self.implicit_network, self.rendering_network, self.envmap_material_network):
            net.reset_parameters(gen)

    # ------------------------------------------------------------------
    def _sdf_closure(self):
        """SDF closure for the tracers: the K1 kernel path when use_fused_sdf."""
        imp = self.implicit_network
        if self.use_fused_sdf:
            return build_fused_sdf(imp, self.fused_sdf_dtype)
        return imp.sdf

    def _sfg_closure(self):
        """(sdf, feature, grad) closure for shading: the K2 kernel path when
        use_fused_sdf (the render is value-only)."""
        if self.use_fused_sdf:
            return build_fused_sdf_feature_grad(self.implicit_network)
        return self.implicit_network.sdf_feature_grad

    def _fused_trace_closure(self, tracer: RayTracer):
        """The K3 whole-trace closure for `tracer` when use_fused_trace, else
        None (the gathered trace through sdf_fn). The trace is fp32: K3 runs
        the fp32 chain whatever fused_sdf_dtype says, as the TPU kernel does."""
        if self.use_fused_trace:
            return build_fused_sphere_trace(self.implicit_network, tracer)
        return None

    def scene_fns(self, sdf_fn, sfg_fn) -> ptr.SceneFns:
        tracer = self.secondary_ray_tracer or self.ray_tracer
        trace_fn = self._fused_trace_closure(tracer)

        def trace(origins, dirs):
            res = tracer(sdf_fn, origins, torch.ones(origins.shape[0], dtype=torch.bool,
                                                     device=origins.device), dirs[:, None, :],
                         sphere_trace_fn=trace_fn)
            return res.points, res.object_mask, res.n_evals

        return ptr.SceneFns(trace=trace, radiance=self.rendering_network,
                            implicit_with_grad=sfg_fn, feature_size=self.feature_vector_size)

    # ------------------------------------------------------------------
    def forward_with_uv(self, inputs: Dict[str, torch.Tensor], gen: torch.Generator, *,
                        training: bool = False, freeze_geo: bool = False,
                        fake_roughness: bool = False, fake_specular: bool = False,
                        steps01: Optional[torch.Tensor] = None,
                        secondary_limit: int = 0):
        """Render the rays of `inputs` (uv [B,S,2] or multi-ray [B,S,R,2],
        pose, intrinsics, object_mask). Without `training` no graph is kept.
        `steps01` injects the tracer's min-SDF step vector (training).

        With `training` and `secondary_limit` > 0 the output holds the
        secondary-hit pool [S', N] (`secondary_points`, `secondary_mask`,
        `secondary_dir`) of the first S' strategies, equal to the JAX
        pipeline's: S' is the fewest strategies whose hits reach the limit, or
        every strategy (a limit of S * N or more gives the whole pool)."""
        if training and not freeze_geo:
            raise NotImplementedError(
                "training with unfrozen geometry is not ported (ROADMAP.md queue 1, item 1): "
                "pass --freeze_geometry")
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            return self._forward_with_uv(inputs, gen, training, fake_roughness, fake_specular,
                                         steps01, secondary_limit)

    def _forward_with_uv(self, inputs, gen, training, fake_roughness, fake_specular, steps01,
                         secondary_limit):
        intrinsics, uv, pose = inputs["intrinsics"], inputs["uv"], inputs["pose"]
        object_mask = inputs["object_mask"].reshape(-1)
        multi_ray = uv.dim() == 4
        R = 1
        if multi_ray:
            B, S, R, D = uv.shape
            uv = uv.reshape(B, S * R, D)
            object_mask = object_mask.reshape(B, S, 1).expand(B, S, R).reshape(-1)

        ray_dirs, cam_loc = get_camera_params(uv, pose, intrinsics)
        batch_size, num_pixels, _ = ray_dirs.shape
        N = batch_size * num_pixels

        sdf_fn = self._sdf_closure()
        sfg_fn = self._sfg_closure()
        with torch.no_grad(), record_function("primary_trace"):
            # the trace, the points and the sdf carry no gradient
            trace = self.ray_tracer(sdf_fn, cam_loc, object_mask, ray_dirs, training=training,
                                    sphere_trace_fn=self._fused_trace_closure(self.ray_tracer),
                                    gen=gen, steps01=steps01)
            sdf_output = self.implicit_network(trace.points)[:, 0:1] if training else None
        points, surface_mask = trace.points, trace.object_mask
        ray_dirs_flat = ray_dirs.reshape(-1, 3)
        view_dirs = -ray_dirs_flat

        # shade the hit rays only; miss rays keep the defaults below
        sel = surface_mask.nonzero()[:, 0]
        with record_function("shading"):
            ret = self.get_rbg_value(points[sel], view_dirs[sel], gen, sdf_fn, sfg_fn,
                                     training=training, fake_roughness=fake_roughness,
                                     fake_specular=fake_specular)
        em = self.envmap_material_network

        def dense(v, fill):
            out = torch.full((N,) + v.shape[1:], fill, dtype=v.dtype, device=v.device)
            out[sel] = v
            return out

        sg_roughness = ret["sg_roughness"]
        if not em.roughness_mlp:
            sg_roughness = sg_roughness[0][None, :].expand(sel.numel(), 1)
        sg_spec = ret["sg_specular_reflectance"]
        if not em.specular_mlp or em.fix_specular_albedo:
            sg_spec = sg_spec[0][None, :].expand(sel.numel(), 3)

        sg_rgb_values = dense(ret["sg_rgb"], 1.0)
        if self.render_background:
            bg = sampling.sg_light_eval(ray_dirs_flat, em.get_lgtSGs())
            sg_rgb_values = torch.where(surface_mask[:, None], sg_rgb_values, bg)

        z = torch.zeros((), dtype=torch.int64)
        output = {
            "points": points,
            "idr_rgb_values": dense(ret["idr_rgb"], 1.0),
            "sg_rgb_values": sg_rgb_values,
            "normal_values": dense(ret["normals"], 1.0),
            "network_object_mask": surface_mask,
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
            output["grad_theta"] = None
            if secondary_limit > 0:
                with torch.no_grad(), record_function("secondary_pool"):
                    pool, n_evals = self._secondary_pool(
                        ret, sel, points, view_dirs, gen, sdf_fn, sfg_fn, secondary_limit,
                        fake_roughness=fake_roughness, fake_specular=fake_specular)
                output.update(pool)
                output["n_sdf_evals"] = output["n_sdf_evals"] + n_evals
        if multi_ray:
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
                        fake_roughness, fake_specular):
        """The secondary hits of every ray, [S', N, ...] in the JAX pipeline's
        [strategy, ray] order, and the SDF evaluations it ran: the shaded
        rays' from their shading (`ret`); for the rays that missed, what the
        JAX pipeline runs to get theirs -- sdf, feature and normal at their
        points, the material net's roughness where the brdf strategy needs
        it, each strategy's directions and the secondary trace -- strategy by
        strategy until the hits reach `limit`. They need no visibility or
        indirect radiance: their colours are defaults. The hit counts stay on
        the device: one read a strategy decides whether to go on."""
        N = points.shape[0]
        S = ret["secondary_mask"].shape[0]
        pool = {}
        for k, fill in (("secondary_points", 0.0), ("secondary_mask", False),
                        ("secondary_dir", 0.0)):
            v = ret[k]
            pool[k] = torch.full((S, N) + v.shape[2:], fill, dtype=v.dtype, device=v.device)
            pool[k][:, sel] = v
        miss = torch.ones(N, dtype=torch.bool, device=points.device)
        miss[sel] = False
        miss = miss.nonzero()[:, 0]
        hits = pool["secondary_mask"].reshape(S, N).sum(1)
        n_evals = 0
        if miss.numel():
            pts = points[miss].detach()
            feats, normals, view = self._surface(pts, view_dirs[miss], sfg_fn)
            n_evals += pts.shape[0]
            em = self.envmap_material_network
            lgt, rough = em.get_lgtSGs(), None
            trace = self.scene_fns(sdf_fn, sfg_fn).trace
            for s, name in enumerate(PT_RENDER_TYPES[self.render_type]["strategies"]):
                if s > 0 and int(hits[:s].sum()) >= limit:
                    break
                if name == "brdf" and rough is None:
                    rough = em(pts, feats, normals, fake_roughness=fake_roughness,
                               fake_specular=fake_specular)["sg_roughness"]
                    rough = rough.expand(pts.shape[0], 1) if rough.shape[0] == 1 else rough
                wi, _ = ptr.sample_direction(name, gen, normals, view, rough, lgt)
                lp, hm, ne = trace(pts, wi)
                n_evals += ne
                pool["secondary_points"][s, miss] = lp
                pool["secondary_mask"][s, miss, 0] = hm
                pool["secondary_dir"][s, miss] = wi
                hits[s] += hm.sum()
        # the strategies before the one whose hits reach the limit, and that one
        keep = min(S, int((hits.cumsum(0) < limit).sum()) + 1)
        return {k: v[:keep] for k, v in pool.items()}, n_evals

    def _surface(self, points, view_dirs, sfg_fn):
        """-> (feature, unit normal, unit view direction) at surface points
        [M,3]: the implicit net's values (K2 or the plain sdf_feature_grad)."""
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
                           fake_specular: bool = False):
        """Secondary self-distillation forward: shade the points [K,R,3] seen
        along ray_dirs [K,R,3] and average over R. Trains, with the normals
        detached; the geometry is frozen."""
        if not freeze_geo:
            raise NotImplementedError(
                "training with unfrozen geometry is not ported (ROADMAP.md queue 1, item 1)")
        points, ray_dirs = inputs["points"], inputs["ray_dirs"]
        K, R, _ = points.shape
        ret = self.get_rbg_value(points.reshape(-1, 3), -ray_dirs.reshape(-1, 3), gen,
                                 self._sdf_closure(), self._sfg_closure(), training=True,
                                 fake_roughness=fake_roughness, fake_specular=fake_specular)
        return {"idr_rgb_values": self.mean_pixel(ret["idr_rgb"], K, R),
                "sg_rgb_values": self.mean_pixel(ret["sg_rgb"], K, R)}

    # ------------------------------------------------------------------
    def get_rbg_value(self, points, view_dirs, gen, sdf_fn, sfg_fn, *, training=False,
                      fake_roughness=False, fake_specular=False):
        """Shading of surface points [M,3] seen along view_dirs [M,3]. The
        implicit net's sdf, feature and normal are values (K2 or the plain
        sdf_feature_grad); the radiance and material nets keep their graph."""
        feature_vectors, normals, view_dirs = self._surface(points, view_dirs, sfg_fn)
        em = self.envmap_material_network
        idr_rgb = self.rendering_network(points, normals, view_dirs, feature_vectors)
        mat = em(points, feature_vectors, normals, fake_roughness=fake_roughness,
                 fake_specular=fake_specular)
        sg_ret = ptr.pt_render_core(
            gen, mat["sg_lgtSGs"], mat["sg_specular_reflectance"], mat["sg_roughness"],
            mat["sg_diffuse_albedo"], normals, view_dirs, points,
            self.scene_fns(sdf_fn, sfg_fn), training=training,
            **PT_RENDER_TYPES[self.render_type],
        )
        return {
            "normals": normals,
            "idr_rgb": idr_rgb,
            **sg_ret,
            "n_sdf_evals": sg_ret["n_sdf_evals"] + points.shape[0],
            "sg_roughness": mat["sg_roughness"],
            "sg_specular_reflectance": mat["sg_specular_reflectance"],
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
