"""The render-type family in eval: the port's IDRNetwork.forward_with_uv for
each of the 11 render types the earlier slices did not cover, against the
JAX package on the same numpy-seeded inputs and JAX-initialised weights; the
background of a constant light; the memsave types against their
speed_first twins. The engine alone, the env2d functions, the constant
envmap, the secant rootfind and the render CLI are in
test_torch_port_render_types_engine.py.

The Monte-Carlo directions are injected on both sides: each sampler (cos,
brdf, mix_sg, env2d, uniform hemisphere) returns wi = normalize(s n + 0.9
t(n)), t a fixed smooth function of the normal per strategy and s = -3 where
another smooth function of the normal says so (those secondary rays enter
the surface and hit, the others leave it and miss), with the strategy's
canonical pdf for it. The same surface point then gets the same direction
in both packages, whatever order they shade their rays in.

Gates (the parity suite's): path-traced sg_* images at >= 60 dB PSNR,
albedo, roughness, normals, IDR radiance and points at >= 80 dB. The port
runs the plain versions of K1 and K2 (CPU tensors); the JAX package its jnp
networks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.config import parse_string
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.ops import sampling as js
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.idr import PT_RENDER_TYPES, IDRNetwork
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.utils.checkpoints import params_from_jax

from test_idr_forward import SMALL_CONF

ESTIMATOR_DB = 60.0
FORWARD_DB = 80.0
# the render types of this slice: all but "sg" and pt_render_indirect_mlp
NEW_TYPES = tuple(t for t in PT_RENDER_TYPES if t != "pt_render_indirect_mlp")
B, S, R = 1, 10, 3


def type_conf(rt: str) -> str:
    """SMALL_CONF for render type `rt` with the JAX dispatch test's tweaks
    (tests/test_idr_forward.py test_all_render_types_dispatch): a constant
    light for the envmap types, global roughness and specular for
    path_tracing_sg, K = 2 global base materials for the blend types; fp32
    plain K1/K2 in the port."""
    t = SMALL_CONF.replace("render_type = pt_render_indirect_mlp",
                           f"render_type = {rt}\n    use_fused_sdf = True\n"
                           "    fused_sdf_dtype = float32")
    opts = PT_RENDER_TYPES[rt]
    if opts.get("light_type") == "constant":
        t = t.replace("white_light = False", "white_light = False\n        light_type = constant")
    if rt == "path_tracing_sg" or opts.get("blend_materials"):
        for k in ("roughness_mlp", "specular_mlp", "same_mlp"):
            t = t.replace(f"{k} = True", f"{k} = False")
    if opts.get("blend_materials"):
        t = (t.replace("num_base_materials = 1", "num_base_materials = 2")
             .replace("fix_specular_albedo = True", "fix_specular_albedo = False"))
    return t


def build(conf_text: str, seed: int = 0):
    conf = parse_string(conf_text).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    return jmodel, params, params_from_jax(IDRNetwork.from_conf(conf), flatten_tree(params))


def _dir_tables():
    rs = np.random.RandomState(7)
    return ([(rs.randn(3, 3) * 2.0).astype(np.float32) for _ in range(4)],
            [rs.randn(3).astype(np.float32) for _ in range(4)],
            rs.randn(3).astype(np.float32))


def patch_samplers(mp, mod, xp, inward=True):
    """Replace the five samplers of `mod` (jax.numpy or torch as `xp`) by the
    deterministic directions of the module docstring (`inward=False`: no
    ray turned into the surface)."""
    A, c, turn = _dir_tables()

    def wi_for(k, n):
        if xp is jnp:
            t = jnp.sin(n @ jnp.asarray(A[k]) + jnp.asarray(c[k]))
            side = jnp.where(jnp.sin(3.0 * n @ jnp.asarray(turn)) > 0.4, -3.0, 1.0)[..., None] \
                if inward else 1.0
            w = side * n + 0.9 * t / jnp.linalg.norm(t, axis=-1, keepdims=True)
            return w / jnp.linalg.norm(w, axis=-1, keepdims=True)
        t = torch.sin(n @ torch.from_numpy(A[k]) + torch.from_numpy(c[k]))
        side = torch.where(torch.sin(3.0 * n @ torch.from_numpy(turn)) > 0.4, -3.0,
                           1.0)[..., None] if inward else 1.0
        w = side * n + 0.9 * t / torch.linalg.norm(t, dim=-1, keepdim=True)
        return w / torch.linalg.norm(w, dim=-1, keepdim=True)

    mp.setattr(mod, "cos_sampling", lambda key, n: (
        wi_for(0, n), mod.pdf_fn_cos(wi_for(0, n), n, None, None, None)))
    mp.setattr(mod, "brdf_sampling", lambda key, n, r, v: (
        wi_for(1, n), mod.pdf_fn_brdf_ggx(wi_for(1, n), n, v, r, None)))
    mp.setattr(mod, "mix_sg_sampling_shared", lambda key, n, lgt: (
        wi_for(2, n), mod.pdf_fn_mix_sg_shared(wi_for(2, n), n, None, None, lgt)))
    mp.setattr(mod, "constant_2d_light_sampling", lambda key, n, lgt: (
        wi_for(2, n), mod.pdf_fn_constant_2d_light(wi_for(2, n), n, None, None, lgt)))
    mp.setattr(mod, "uniform_hemisphere_sampling", lambda key, n: wi_for(3, n))


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-30))


def _inputs():
    """B x S pixels of R rays around the image centre (every ray hits the
    sphere of the geometric init)."""
    W = 64
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2] = K[1, 2] = W / 2
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -2.0]
    rs = np.random.RandomState(0)
    base = rs.uniform(W / 2 - 9, W / 2 + 9, (B, S, 1, 2))
    uv = (base + rs.uniform(-0.5, 0.5, (B, S, R, 2))).astype(np.float32)
    return {"intrinsics": K[None], "uv": uv, "pose": pose[None],
            "object_mask": np.ones((B, S), bool)}


# ---------------------------------------------------------------------------
# eval forward, one render type at a time
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NEW_TYPES)
def outputs(request):
    rt = request.param
    jmodel, params, model = build(type_conf(rt))
    inputs = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp, js, jnp)
        patch_samplers(mp, ts, torch)
        jout = jax.jit(lambda p: jmodel.forward(
            p, {k: jnp.asarray(v) for k, v in inputs.items()}, jax.random.PRNGKey(1)))(params)
        jout = {k: np.asarray(v) for k, v in jout.items() if v is not None}
        fm.reset_launch_counts()
        with torch.no_grad():
            tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in inputs.items()},
                                         torch.Generator().manual_seed(1))
    tout = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in tout.items()}
    return rt, jout, tout, dict(fm.LAUNCHES)


def test_render_type_hits_and_secondary_rays(outputs):
    """Every primary ray hits in both packages; the injected directions send
    some secondary rays into the surface (hits) and some out (misses)."""
    rt, jout, tout, launches = outputs
    assert jout["network_object_mask"].all()
    np.testing.assert_array_equal(tout["network_object_mask"], jout["network_object_mask"])
    assert all(n == 0 for n in launches.values())  # CPU tensors: the plain versions
    shadow = PT_RENDER_TYPES[rt].get("shadow")
    assert tout["n_sdf_evals"] > 0
    if shadow is not None:
        m = jout["secondary_mask"]
        assert m.any() and not m.all(), rt


@pytest.mark.parametrize("key,gate", [
    ("sg_rgb_values", ESTIMATOR_DB),
    ("sg_diffuse_rgb_values", ESTIMATOR_DB),
    ("sg_specular_rgb_values", ESTIMATOR_DB),
    ("sg_diffuse_albedo_values", FORWARD_DB),
    ("sg_roughness_values", FORWARD_DB),
    ("sg_specular_reflection_values", FORWARD_DB),
    ("normal_values", FORWARD_DB),
    ("idr_rgb_values", FORWARD_DB),
])
def test_render_type_matches_jax(outputs, key, gate):
    rt, jout, tout, _ = outputs
    assert tout[key].shape == jout[key].shape
    assert np.isfinite(tout[key]).all()
    assert np.abs(jout[key]).max() > 0
    p = psnr(tout[key], jout[key])
    assert p >= gate, f"{rt} {key}: PSNR {p:.1f} dB < {gate} dB"


def test_background_of_a_constant_light():
    """All rays miss: every pixel is the constant map's texel along its ray."""
    jmodel, params, model = build(type_conf("pt_render_shadow_indirect_mlp_envmap"))
    inputs = _inputs()
    inputs["pose"] = inputs["pose"].copy()
    inputs["pose"][0, :3, 3] = [0.0, 3.0, -2.0]  # the object is out of view
    jout = jax.jit(lambda p: jmodel.forward(
        p, {k: jnp.asarray(v) for k, v in inputs.items()}, jax.random.PRNGKey(1)))(params)
    with torch.no_grad():
        tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in inputs.items()},
                                     torch.Generator().manual_seed(1))
    assert not np.asarray(jout["network_object_mask"]).any()
    assert np.abs(np.asarray(jout["sg_rgb_values"])).max() > 0
    # each pixel is the mean of its R rays' texels
    np.testing.assert_allclose(tout["sg_rgb_values"].numpy(), np.asarray(jout["sg_rgb_values"]),
                               rtol=1e-6)


def test_memsave_types_match_their_speed_first_twins():
    """One trace a strategy gives the batched trace's image (the JAX test's
    atol), for the SG and the constant light."""
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    for fast, slow in (("pt_render_indirect_mlp", "pt_render_indirect_mlp_memsave"),
                       ("pt_render_shadow_indirect_mlp_envmap",
                        "pt_render_shadow_indirect_mlp_envmap_memsave")):
        _, _, model = build(type_conf(slow))
        outs = []
        for rt in (fast, slow):
            model.render_type = rt
            with pytest.MonkeyPatch.context() as mp, torch.no_grad():
                patch_samplers(mp, ts, torch)
                outs.append(model.forward_with_uv(inputs, torch.Generator().manual_seed(1)))
        for k in ("sg_rgb_values", "sg_specular_rgb_values", "sg_diffuse_rgb_values"):
            np.testing.assert_allclose(outs[1][k].numpy(), outs[0][k].numpy(), atol=1e-4,
                                       err_msg=f"{slow} {k}")


def test_unknown_render_type_is_refused():
    _, _, model = build(type_conf("path_tracing"))
    model.render_type = "no_such_type"
    with pytest.raises(ValueError, match="render_type 'no_such_type'"):
        model.forward_with_uv({k: torch.from_numpy(v) for k, v in _inputs().items()},
                              torch.Generator())
