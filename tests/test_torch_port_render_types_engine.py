"""The render-type family's pieces against the JAX package on the same
numpy-seeded inputs and JAX-initialised weights: the engine pt_render_core
alone (through wi_override) for each shadow x diff_geo x sphere_fallback set
the render types use, env2d with a constant map and K = 2 unblended
materials; the secondary trace's miss points; pt_render_with_sg and the
uniform-hemisphere sampler; the env2d sampler's functions; compute_envmap_2d
against jax.image.resize; the render CLI's envmap.exr of a constant light;
the secant rootfind. The models and the gates are those of
test_torch_port_render_types.py (PSNR >= 60 dB for path-traced images)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.ops import path_tracing as jptr
from nefii_tpu.ops import sampling as js
from nefii_tpu.ops import sg as jsg
from nefii_tpu.ops.ray_tracing import RayTracer as JRayTracer
from nefii_tpu_torch.ops import path_tracing as tptr
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.ops import sg as tsg
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.utils.camera import get_sphere_intersection

from test_torch_port_render_types import ESTIMATOR_DB, build, psnr, type_conf


# ---------------------------------------------------------------------------
# the engine alone, through wi_override
# ---------------------------------------------------------------------------

# (shadow, diff_geo, sphere_fallback, strategies, light): the combinations the
# render types use, env2d with a constant map, and K = 2 unblended materials
ENGINE_CASES = {
    "no_shadow": (None, False, False, ("cos", "brdf"), "sg"),
    "hard": ("hard", False, False, ("cos", "brdf", "mix_sg"), "sg"),
    "soft_fallback": ("soft", True, True, ("cos", "brdf", "mix_sg"), "sg"),
    "indirect_diff_geo_fallback": ("indirect", True, True, ("cos", "brdf", "mix_sg"), "sg"),
    "indirect_diff_geo": ("indirect", True, False, ("cos", "brdf", "mix_sg"), "sg"),
    "indirect": ("indirect", False, False, ("cos", "brdf", "mix_sg"), "sg"),
    "indirect_env2d": ("indirect", False, False, ("cos", "brdf", "env2d"), "constant"),
    "hard_k2_unblended": ("hard", False, False, ("cos", "mix_sg"), "sg"),
}


@pytest.fixture(scope="module")
def engine_models():
    return {"sg": build(type_conf("pt_render_diff_shadow_indirect_mlp")),
            "constant": build(type_conf("pt_render_shadow_indirect_mlp_envmap"))}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_pt_render_core_matches_jax(engine_models, case):
    """The same surface points, normals, materials and directions (a third of
    them into the surface) into both engines: secondary trace, visibility,
    indirect radiance, MIS. The K = 2 case sums two global materials (the
    JAX package's full forward cannot reach it: its brdf sampler broadcasts
    [K,1] roughness against [N,1], so the case runs without that strategy)."""
    shadow, diff_geo, fallback, strategies, light = ENGINE_CASES[case]
    jmodel, params, model = engine_models[light]
    rs = np.random.RandomState(3)
    N = 48
    d = rs.randn(N, 3)
    n = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    # on the surface of the geometric init (a sphere of radius ~0.6): two
    # Newton steps of the JAX net's sdf along its gradient
    pts = jnp.asarray(0.6 * n, jnp.float32)
    imp = jmodel.implicit_network
    for _ in range(2):
        g = imp.gradient(params["implicit_network"], pts)
        pts = pts - imp.sdf(params["implicit_network"], pts)[:, None] * g / \
            jnp.sum(g * g, -1, keepdims=True)
    pts = np.asarray(pts)
    view = np.array([0.0, 0.0, -2.0], np.float32) - pts
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    albedo = rs.uniform(0.1, 0.9, (N, 3)).astype(np.float32)
    if case.endswith("k2_unblended"):
        rough = rs.uniform(0.2, 0.8, (2, 1)).astype(np.float32)
        spec = rs.uniform(0.02, 0.08, (2, 3)).astype(np.float32)
    else:
        rough = rs.uniform(0.2, 0.8, (N, 1)).astype(np.float32)
        spec = np.full((1, 3), 0.04, np.float32)
    lgt = np.asarray(jmodel.envmap_material_network.get_lgtSGs(params["envmap_material_network"]))
    sign = np.where(rs.rand(len(strategies), N, 1) < 0.35, -3.0, 1.0)
    wi = [w / np.linalg.norm(w, axis=-1, keepdims=True)
          for w in (sign * n + 0.9 * rs.randn(len(strategies), N, 3)).astype(np.float32)]
    args = (lgt, spec, rough, albedo, n, view, pts)
    kw = dict(strategies=strategies, shadow=shadow, diff_geo=diff_geo, sphere_fallback=fallback,
              light_type=light)
    jret = jax.jit(lambda *a: jptr.pt_render_core(
        jax.random.PRNGKey(0), *a, jmodel.scene_fns(params, value_only=True),
        wi_override=[jnp.asarray(w) for w in wi], **kw))(*(jnp.asarray(a) for a in args))
    with torch.no_grad():
        tret = tptr.pt_render_core(
            torch.Generator().manual_seed(0), *(torch.from_numpy(a.copy()) for a in args),
            model.scene_fns(model._sdf_closure(), model._sfg_closure()),
            wi_override=[torch.from_numpy(w) for w in wi], **kw)
    if shadow is not None:
        hits = np.asarray(jret["secondary_mask"])
        assert hits.any() and not hits.all()
    for k in ("sg_rgb", "sg_diffuse_rgb", "sg_specular_rgb"):
        ref = np.asarray(jret[k])
        assert np.abs(ref).max() > 0 and np.isfinite(tret[k].numpy()).all()
        p = psnr(tret[k].numpy(), ref)
        assert p >= ESTIMATOR_DB, f"{case} {k}: PSNR {p:.1f} dB < {ESTIMATOR_DB} dB"


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_secondary_miss_points_match_jax(engine_models, training):
    """The secondary trace's points and dists at the rays that miss, where
    soft visibility reads the SDF: rays from surface points, a third of them
    into the surface (hits). In training the misses take the min-SDF points
    (the shared vector injected). Masks equal; every point and dist within
    1e-5, the rays beyond 1e-6 counted (ROADMAP Queue 3: a ray without a
    bracket can land elsewhere in the gathered bisection)."""
    jmodel, params, model = engine_models["sg"]
    rs = np.random.RandomState(12)
    N = 192
    n = rs.randn(N, 3)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    pts = jnp.asarray(0.6 * n, jnp.float32)
    imp = jmodel.implicit_network
    for _ in range(2):
        g = imp.gradient(params["implicit_network"], pts)
        pts = pts - imp.sdf(params["implicit_network"], pts)[:, None] * g / \
            jnp.sum(g * g, -1, keepdims=True)
    pts = np.asarray(pts)
    sign = np.where(rs.rand(N, 1) < 0.35, -3.0, 1.0)
    wi = sign * n + 0.9 * rs.randn(N, 3)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jp, jm, jd = jax.jit(lambda o, d: jmodel.scene_fns(params, value_only=True).trace(
        o, d, key, training)[:3])(jnp.asarray(pts), jnp.asarray(wi))
    steps01 = torch.from_numpy(np.array(jax.random.uniform(key, (jmodel.ray_tracer.n_steps,))))
    tp, tm, td, _ = model.scene_fns(model._sdf_closure(), model._sfg_closure()).trace(
        torch.from_numpy(pts), torch.from_numpy(wi), torch.Generator(), training, steps01)
    jm = np.asarray(jm)
    assert jm.any() and (~jm).sum() > N // 2
    np.testing.assert_array_equal(tm.numpy(), jm)
    miss = ~jm
    gap = np.maximum(np.abs(tp.numpy() - np.asarray(jp)).max(-1),
                     np.abs(td.numpy() - np.asarray(jd)))
    print(f"secondary misses ({'training' if training else 'eval'}): "
          f"{int((gap[miss] > 1e-6).sum())} of {int(miss.sum())} beyond 1e-6, the largest "
          f"{gap[miss].max():.3g}; hits {gap[jm].max():.3g}")
    assert gap.max() <= 1e-5


def test_pt_render_with_sg_matches_jax():
    rs = np.random.RandomState(5)
    N = 64
    n = rs.randn(N, 3)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    view = rs.randn(N, 3)
    view = (view / np.linalg.norm(view, axis=-1, keepdims=True)).astype(np.float32)
    wi = rs.randn(N, 3) + 1.5 * n
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    jmodel, params, _ = build(type_conf("path_tracing_sg"))
    lgt = np.asarray(params["envmap_material_network"]["lgtSGs"])
    args = (lgt, np.full((1, 3), 0.04, np.float32), np.full((1, 1), 0.4, np.float32),
            rs.uniform(0.1, 0.9, (N, 3)).astype(np.float32), n, view)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "uniform_hemisphere_sampling", lambda key, nn: jnp.asarray(wi))
        mp.setattr(ts, "uniform_hemisphere_sampling", lambda gen, nn: torch.from_numpy(wi))
        jret = jptr.pt_render_with_sg(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
        tret = tptr.pt_render_with_sg(torch.Generator(),
                                      *(torch.from_numpy(a.copy()) for a in args))
    for k in ("sg_rgb", "sg_specular_rgb", "sg_diffuse_rgb"):
        assert np.abs(np.asarray(jret[k])).max() > 0
        p = psnr(tret[k].numpy(), np.asarray(jret[k]))
        assert p >= ESTIMATOR_DB, f"{k}: PSNR {p:.1f} dB < {ESTIMATOR_DB} dB"


def test_uniform_hemisphere_sampling_matches_jax():
    rs = np.random.RandomState(6)
    n = rs.randn(200, 3)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    u = [rs.rand(200, 1).astype(np.float32) for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        ju, tu = iter(u), iter(u)
        mp.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(next(ju)))
        mp.setattr(ts, "_uniform", lambda gen, shape, like: torch.from_numpy(next(tu)))
        jw = np.asarray(js.uniform_hemisphere_sampling(jax.random.PRNGKey(0), jnp.asarray(n)))
        tw = ts.uniform_hemisphere_sampling(torch.Generator(), torch.from_numpy(n)).numpy()
    assert ((tw * n).sum(-1) >= -1e-6).all()
    np.testing.assert_allclose(tw, jw, atol=1e-6)


# ---------------------------------------------------------------------------
# the env2d light
# ---------------------------------------------------------------------------

def _light_map(H=8, W=16, seed=0):
    return np.abs(np.random.RandomState(seed).randn(H, W, 3)).astype(np.float32)


def _directions(n=4000, seed=1):
    d = np.random.RandomState(seed).randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_envmap_distribution_and_pdf_match_jax():
    m, wi = _light_map(), _directions()
    np.testing.assert_allclose(ts._envmap_distribution(torch.from_numpy(m)).numpy(),
                               np.asarray(js._envmap_distribution(jnp.asarray(m))), rtol=1e-6)
    jp = np.asarray(js.pdf_fn_constant_2d_light(jnp.asarray(wi), None, None, None, jnp.asarray(m)))
    tp = ts.pdf_fn_constant_2d_light(torch.from_numpy(wi), None, None, None,
                                     torch.from_numpy(m)).numpy()
    assert (jp > 0).all()
    # the pdf divides by sin(acos(w_z)): where torch's acos and XLA's differ
    # by an ulp near a pole, the quotient differs by more than 1e-6. Those
    # directions are the witness; every other one holds at rtol 1e-6
    z = np.clip(wi[:, 2], -1.0, 1.0)
    acos_differs = (np.asarray(jnp.arccos(jnp.asarray(z)))
                    != torch.arccos(torch.from_numpy(z)).numpy())
    off = np.abs(tp - jp)[:, 0] > 1e-6 * np.abs(jp)[:, 0]
    assert not (off & ~acos_differs).any() and off.sum() <= 0.001 * len(wi), int(off.sum())
    np.testing.assert_allclose(tp, jp, rtol=1e-4)


def test_envmap_lookup_texels_match_jax():
    """The nearest texel of each direction is JAX's: indices equal (each
    texel of the map holds a distinct value, so equal radiance is an equal
    index)."""
    H, W = 8, 16
    m = np.arange(H * W * 3, dtype=np.float32).reshape(H, W, 3)
    wi = _directions()
    jl = np.asarray(js.envmap_lookup(jnp.asarray(wi), jnp.asarray(m)))
    tl = ts.envmap_lookup(torch.from_numpy(wi), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(tl, jl)


def test_sample_1d_cdf_indices_match_jax():
    rs = np.random.RandomState(2)
    pdf = rs.rand(500, 12).astype(np.float32) + 0.05
    pdf /= pdf.mean(1, keepdims=True)
    r = rs.rand(500, 1).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(r))
        mp.setattr(ts, "_uniform", lambda gen, shape, like: torch.from_numpy(r))
        ji = np.asarray(js._sample_1d_cdf(jax.random.PRNGKey(0), jnp.asarray(pdf)))
        ti = ts._sample_1d_cdf(torch.Generator(), torch.from_numpy(pdf)).numpy()
    assert len(np.unique(ti)) > 6
    np.testing.assert_array_equal(ti, ji)


def test_constant_2d_light_sampling_matches_jax():
    """The uniforms injected on both sides: the sampled texels equal, wi
    within 1e-6 and the pdf within rel 1e-5. The pdf recomputes the texel of
    the sampled direction, which lies on a texel corner, by floor of
    acos/atan2: the samples that land in another texel than they were drawn
    from are counted, and must be as many in both packages."""
    m = _light_map()
    n = 3000
    rs = np.random.RandomState(4)
    u = [rs.rand(n, 1).astype(np.float32) for _ in range(2)]
    normal = _directions(n, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        ju, tu = iter(u), iter(u)
        mp.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(next(ju)))
        mp.setattr(ts, "_uniform", lambda gen, shape, like: torch.from_numpy(next(tu)))
        jw, jp = js.constant_2d_light_sampling(jax.random.PRNGKey(0), jnp.asarray(normal),
                                               jnp.asarray(m))
        tw, tp = ts.constant_2d_light_sampling(torch.Generator(), torch.from_numpy(normal),
                                               torch.from_numpy(m))
    jw, jp, tw, tp = np.asarray(jw), np.asarray(jp), tw.numpy(), tp.numpy()
    np.testing.assert_allclose(tw, jw, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=1e-5)
    # the texel the pdf and the lookup recompute for each sampled direction,
    # which lies on a texel corner: floor of acos/atan2 decides it, and an
    # ulp between torch's and XLA's decides it otherwise at some corners
    H, W, _ = m.shape
    ids = np.arange(H * W * 3, dtype=np.float32).reshape(H, W, 3)
    jt = np.asarray(js.envmap_lookup(jnp.asarray(jw), jnp.asarray(ids)))[:, 0] // 3
    tt = ts.envmap_lookup(torch.from_numpy(tw), torch.from_numpy(ids)).numpy()[:, 0] // 3
    drawn = _drawn_texels(jw, H, W)
    moved_j, moved_t, differ = int((jt != drawn).sum()), int((tt != drawn).sum()), jt != tt
    print(f"samples recomputed into another texel: JAX {moved_j}, port {moved_t} of {n}; "
          f"the packages differ on {int(differ.sum())}")
    # where they differ, it is between the texels around the same corner
    assert (np.abs(jt // W - tt // W)[differ] <= 1).all()
    assert differ.mean() <= 0.05
    jpdf = np.asarray(js.pdf_fn_constant_2d_light(jnp.asarray(jw), None, None, None,
                                                  jnp.asarray(m)))
    tpdf = ts.pdf_fn_constant_2d_light(torch.from_numpy(tw), None, None, None,
                                       torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(tpdf[~differ], jpdf[~differ], rtol=1e-5)


def _drawn_texels(wi, H, W):
    """The texel index v * W + u whose corner each sampled direction is:
    v = phi H / pi, u = (1 - theta / pi) W / 2, rounded."""
    phi = np.arccos(np.clip(wi[:, 2].astype(np.float64), -1.0, 1.0))
    theta = np.arctan2(wi[:, 1].astype(np.float64), wi[:, 0].astype(np.float64))
    v = np.rint(phi / np.pi * H).astype(np.int64)
    u = np.rint((1.0 - theta / np.pi) / 2.0 * W).astype(np.int64) % W
    return np.clip(v, 0, H - 1) * W + u


@pytest.mark.parametrize("size", [(256, 512), (64, 128)], ids=["render", "plot"])
def test_compute_envmap_2d_matches_jax_image_resize(size):
    """The constant map's bilinear resize: 128 rows to 256 (render) and to
    64 (the trainer's plot: JAX antialiases the shrink with a widened
    triangle, renormalised where the border cuts it). The border rows are
    held on their own too."""
    m = _light_map(128, 128, seed=3)
    ref = np.asarray(jsg.compute_envmap(jnp.asarray(m), *size, envmap_type="constant"))
    got = tsg.compute_envmap(torch.from_numpy(m), *size, envmap_type="constant").numpy()
    assert got.shape == ref.shape == size + (3,)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[[0, -1]], ref[[0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-6)


# ---------------------------------------------------------------------------
# the secant rootfind
# ---------------------------------------------------------------------------

def test_secant_rootfind_matches_jax():
    """Rays into the seeded net's sphere, traced with one sphere-tracing
    iteration so that many go to the sampler and its rootfind. The sampler
    on those rays (their brackets from the port's sphere trace) against
    JAX's on the same rays, both on the JAX net's sdf: the hit masks equal
    and the bracketed rays' points within 1e-6, or, on a grazing ray, within
    the root's own precision: 5e-7 (the sdf's rounding, which depends on the
    batch a point is evaluated in, and the two nets' difference by summation
    order, ~4e-7) over the sdf's slope along the ray. The same on the port's
    own net. The rays beyond 1e-6 are counted (ROADMAP Queue 3). The whole
    trace against JAX's: masks equal, points within 1e-5."""
    jmodel, params, model = build(type_conf("path_tracing_shadow"))
    kw = dict(sdf_threshold=5e-5, line_search_step=0.5, line_step_iters=1,
              sphere_tracing_iters=1, n_steps=32, n_rootfind_steps=8, rootfind_method="secant")
    rs = np.random.RandomState(8)
    n = 128
    cam = np.array([[0.0, 0.0, -2.0]], np.float32)
    tgt = rs.uniform(-0.7, 0.7, (1, n, 3)).astype(np.float32)
    dirs = tgt - cam[:, None, :]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jsdf = lambda x: jmodel.implicit_network.sdf(params["implicit_network"], x)  # noqa: E731
    jtracer, tracer = JRayTracer(**kw), RayTracer(**kw)
    tsdf = model.implicit_network.sdf

    c = torch.from_numpy(cam).expand(n, 3).contiguous()
    d = torch.from_numpy(dirs[0])
    si, hit_sphere = get_sphere_intersection(torch.from_numpy(cam), torch.from_numpy(dirs))
    with torch.no_grad():
        acc_s, acc_e, unfinished, _ = tracer._sphere_trace(tsdf, c, d, hit_sphere[0],
                                                           si[0, :, 0], si[0, :, 1])
        sel = unfinished.nonzero()[:, 0]
        args = (c[sel], d[sel], torch.ones(sel.numel(), dtype=torch.bool), acc_s[sel], acc_e[sel])
        tp, tsurf, td, _ = tracer._ray_sampler_dense(tsdf, *args)
        tp_j, tsurf_j, _, _ = tracer._ray_sampler_dense(
            lambda x: torch.from_numpy(np.asarray(jsdf(jnp.asarray(x.numpy())))), *args)
    jp, jsurf = jax.jit(lambda *a: jtracer._ray_sampler_dense(
        jsdf, *a, jnp.ones(sel.numel(), bool), False)[:2])(*(jnp.asarray(a.numpy()) for a in args))
    jp, jsurf = np.asarray(jp), np.asarray(jsurf)
    assert 10 <= jsurf.sum() < sel.numel()
    # the sdf's slope along each ray at its root, by central differences
    h = 1e-3
    dn = d[sel].numpy()
    slope = np.abs(np.asarray(jsdf(jnp.asarray(jp + h * dn))) -
                   np.asarray(jsdf(jnp.asarray(jp - h * dn)))) / (2 * h)
    tol = np.maximum(1e-6, 5e-7 / np.maximum(slope, 1e-12))[:, None]
    for name, mask, pts in (("JAX net", tsurf_j, tp_j), ("port net", tsurf, tp)):
        np.testing.assert_array_equal(mask.numpy(), jsurf, err_msg=name)
        gap = np.abs(pts.numpy() - jp)
        assert (gap <= tol)[jsurf].all(), (name, float(gap[jsurf].max()))
        off = jsurf & (gap.max(-1) > 1e-6)
        print(f"secant on the {name}: {int(off.sum())} of {int(jsurf.sum())} bracketed rays "
              f"beyond 1e-6, the largest {float(gap[jsurf].max()):.3g}")
        assert off.sum() <= 0.05 * jsurf.sum()

    jres = jax.jit(lambda c, d: jtracer(jsdf, c, jnp.ones(n, bool), d))(jnp.asarray(cam),
                                                                         jnp.asarray(dirs))
    with torch.no_grad():
        tres = tracer(tsdf, torch.from_numpy(cam), torch.ones(n, dtype=torch.bool),
                      torch.from_numpy(dirs))
    jm = np.asarray(jres.object_mask)
    np.testing.assert_array_equal(tres.object_mask.numpy(), jm)
    gap = np.abs(tres.points.numpy() - np.asarray(jres.points)).max(-1)[jm]
    print(f"secant: {int((gap > 1e-6).sum())} of {int(jm.sum())} hits beyond 1e-6 of the "
          f"dense JAX trace, the largest {gap.max():.3g}")
    assert gap.max() <= 1e-5
