"""The render slice end to end: the port's IDRNetwork.forward_with_uv (eval,
pt_render_indirect_mlp, multi-ray AA) against the JAX package's, on the same
weights and rays, with the Monte-Carlo samples injected on both sides.

The patched samplers return, for every strategy, the direction
normalize(n + 0.9 t) with one fixed numpy table t per strategy, and the pdf of
the strategy's canonical pdf function for it: the contract of the JAX
engine's `wi_override` hook. Every ray of the fixture hits the surface, so
both packages shade the same rays in the same order.

Gates (the parity suite's): path-traced sg_* images at >= 60 dB PSNR (the
estimator gate: secondary traces and indirect radiance accumulate rounding
differences), albedo, roughness, normals and the IDR radiance at >= 80 dB
(the full-forward gate). Both sides use fp32 SDF evaluation; the port goes
through the plain versions of both fused kernels (use_fused_sdf, CPU
tensors); the JAX package on CPU through its jnp networks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.config import parse_string
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.ops import sampling as js
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.idr import OVERFLOW_KEYS, IDRNetwork
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.utils.checkpoints import params_from_jax

from test_idr_forward import SMALL_CONF

ESTIMATOR_DB = 60.0
FORWARD_DB = 80.0
B, S, R = 1, 10, 3
CONF = SMALL_CONF.replace(
    "render_type = pt_render_indirect_mlp",
    "render_type = pt_render_indirect_mlp\n    use_fused_sdf = True\n"
    "    fused_sdf_dtype = float32")


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-30))


def _inputs():
    W = 64
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2] = K[1, 2] = W / 2
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -2.0]
    rs = np.random.RandomState(0)
    base = rs.uniform(W / 2 - 7, W / 2 + 7, (B, S, 1, 2))
    uv = (base + rs.uniform(-0.5, 0.5, (B, S, R, 2))).astype(np.float32)
    return {"intrinsics": K[None], "uv": uv, "pose": pose[None],
            "object_mask": np.ones((B, S), bool)}


def _tables():
    rs = np.random.RandomState(7)
    t = rs.randn(3, B * S * R, 3)
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)


def _patch(mp, mod, xp, tables):
    """Replace the three samplers of `mod` (jax.numpy or torch as `xp`)."""
    def wi_for(k, normal):
        t = xp.asarray(tables[k][: normal.shape[0]]) if xp is jnp else \
            torch.from_numpy(tables[k][: normal.shape[0]].copy())
        assert t.shape[0] == normal.shape[0]
        w = normal + 0.9 * t
        norm = (w * w).sum(-1, keepdims=True) ** 0.5 if xp is jnp else \
            torch.linalg.norm(w, dim=-1, keepdim=True)
        return w / norm

    def cos(key, normal):
        wi = wi_for(0, normal)
        return wi, mod.pdf_fn_cos(wi, normal, None, None, None)

    def brdf(key, normal, roughness, viewdir):
        wi = wi_for(1, normal)
        return wi, mod.pdf_fn_brdf_ggx(wi, normal, viewdir, roughness, None)

    def mix_sg(key, normal, lgtSGs):
        wi = wi_for(2, normal)
        return wi, mod.pdf_fn_mix_sg_shared(wi, normal, None, None, lgtSGs)

    mp.setattr(mod, "cos_sampling", cos)
    mp.setattr(mod, "brdf_sampling", brdf)
    mp.setattr(mod, "mix_sg_sampling_shared", mix_sg)


@pytest.fixture(scope="module")
def models():
    conf = parse_string(CONF).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, params_from_jax(IDRNetwork.from_conf(conf), flatten_tree(params))


@pytest.fixture(scope="module")
def outputs(models):
    jmodel, params, model = models
    inputs = _inputs()
    tables = _tables()
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, js, jnp, tables)
        _patch(mp, ts, torch, tables)
        jout = jmodel.forward(params, {k: jnp.asarray(v) for k, v in inputs.items()},
                              jax.random.PRNGKey(1), training=False)
        jout = {k: np.asarray(v) for k, v in jout.items() if v is not None}
        fm.reset_launch_counts()
        tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in inputs.items()},
                                     torch.Generator().manual_seed(1))
    launches = dict(fm.LAUNCHES)
    tout = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in tout.items()}
    return jout, tout, launches


def test_all_rays_hit_and_masks_agree(outputs):
    jout, tout, launches = outputs
    assert jout["network_object_mask"].all()
    np.testing.assert_array_equal(tout["network_object_mask"], jout["network_object_mask"])
    # CPU tensors: the plain versions ran, no CUDA launch
    assert launches and all(n == 0 for n in launches.values())
    for k in OVERFLOW_KEYS:
        assert int(tout[k]) == 0
    assert tout["n_sdf_evals"] > 0


@pytest.mark.parametrize("key,gate", [
    ("sg_rgb_values", ESTIMATOR_DB),
    ("sg_diffuse_rgb_values", ESTIMATOR_DB),
    ("sg_specular_rgb_values", ESTIMATOR_DB),
    ("sg_diffuse_albedo_values", FORWARD_DB),
    ("sg_roughness_values", FORWARD_DB),
    ("sg_specular_reflection_values", FORWARD_DB),
    ("normal_values", FORWARD_DB),
    ("idr_rgb_values", FORWARD_DB),
    ("points", FORWARD_DB),
])
def test_slice_output_matches_jax(outputs, key, gate):
    jout, tout, _ = outputs
    assert tout[key].shape == jout[key].shape == ((B * S, 3) if key != "sg_roughness_values"
                                                  else (B * S, 1))
    assert np.isfinite(tout[key]).all()
    assert np.abs(jout[key]).max() > 0
    p = _psnr(tout[key], jout[key])
    assert p >= gate, f"{key}: PSNR {p:.1f} dB < {gate} dB"


def test_background_rays_get_the_sg_environment(models):
    """All rays miss: no shading, every pixel is the SG light along its ray
    (render_background), in both packages."""
    jmodel, params, model = models
    inputs = _inputs()
    inputs["pose"] = inputs["pose"].copy()
    inputs["pose"][0, :3, 3] = [0.0, 3.0, -2.0]  # the object is out of view
    jout = jmodel.forward(params, {k: jnp.asarray(v) for k, v in inputs.items()},
                          jax.random.PRNGKey(1), training=False)
    tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in inputs.items()},
                                 torch.Generator().manual_seed(1))
    assert not np.asarray(jout["network_object_mask"]).any()
    assert not tout["network_object_mask"].any()
    p = _psnr(tout["sg_rgb_values"].numpy(), np.asarray(jout["sg_rgb_values"]))
    assert p >= FORWARD_DB, p


def test_pt_render_core_wi_override_matches_jax(models, outputs):
    """The estimator alone through its `wi_override` hook: the same surface
    points, normals, materials and directions into both engines (secondary
    trace, visibility, indirect radiance through the plain K1/K2, MIS)."""
    from nefii_tpu.ops import path_tracing as jptr
    from nefii_tpu_torch.ops import path_tracing as tptr

    jmodel, params, model = models
    jout, _, _ = outputs
    rs = np.random.RandomState(3)
    pts = jout["points"].astype(np.float32)
    n = jout["normal_values"].astype(np.float32)
    view = np.array([0.0, 0.0, -2.0], np.float32) - pts
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    N = pts.shape[0]
    rough = rs.uniform(0.2, 0.8, (N, 1)).astype(np.float32)
    albedo = rs.uniform(0.1, 0.9, (N, 3)).astype(np.float32)
    spec = np.full((1, 3), 0.04, np.float32)
    lgt = np.asarray(params["envmap_material_network"]["lgtSGs"])
    wi = [w / np.linalg.norm(w, axis=-1, keepdims=True)
          for w in (n + 0.9 * rs.randn(3, N, 3)).astype(np.float32)]
    args = (lgt, spec, rough, albedo, n, view, pts)
    jret = jptr.pt_render_core(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args),
        jmodel.scene_fns(params, value_only=True), wi_override=[jnp.asarray(w) for w in wi],
        strategies=("cos", "brdf", "mix_sg"), shadow="indirect", diff_geo=False)
    with torch.no_grad():
        tret = tptr.pt_render_core(
            torch.Generator().manual_seed(0), *(torch.from_numpy(a.copy()) for a in args),
            model.scene_fns(model._sdf_closure(), model._sfg_closure()),
            wi_override=[torch.from_numpy(w) for w in wi])
    for k in ("sg_rgb", "sg_diffuse_rgb", "sg_specular_rgb"):
        ref = np.asarray(jret[k])
        assert np.abs(ref).max() > 0
        p = _psnr(tret[k].numpy(), ref)
        assert p >= ESTIMATOR_DB, f"{k}: PSNR {p:.1f} dB < {ESTIMATOR_DB} dB"
