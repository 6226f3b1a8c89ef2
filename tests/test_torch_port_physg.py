"""Step-2 training with live geometry and the closed-form SG render: the port
against the JAX package on the same numpy-seeded inputs and JAX-initialised
weights (params_from_jax).

Cases and gates:
  * `render_with_sg` on seeded inputs (a random light and the material
    net's initial one), with and without blending weights: atol 1e-6, or
    JAX's own distance from the float64 value of the formula where that is
    larger (its cancellations make it ill-conditioned in fp32); the float64
    value is the JAX package's, run under jax.enable_x64;
  * one unfrozen step of a small PhySG conf (render type "sg") and of the
    small path-traced conf with `use_fused_sdf = true` (K1/K2/K3 plain on the
    CPU): every loss term at rel 1e-5 (a patch variance of near-equal values
    in two parts, `_assert_term`) and every parameter group's gradient, the
    implicit net's included, at a relative L2 of 2e-3; the eikonal points
    injected on both sides (`eik_override`); K2 (no backward) only where no
    graph is kept: the secondary-hit pool of the rays that missed;
  * the live-geometry distillation step: the implicit net trains through the
    features only;
  * `train.remat`, `model.remat_strategies` and both against neither: the
    same loss and gradients bit for bit, with the samples and the eikonal
    points drawn from the generator;
  * `render_sg_rgb` renders as JAX's (confs/sdf.conf's "sg" model is in
    test_torch_port_geometry.py);
  * `exp_runner` trains the PhySG conf without --freeze_geometry and
    `scripts/render.py --num_rays -1` renders its checkpoint: the same EXRs
    as the JAX package's render CLI (the shaded ones at rtol 1e-4).

The Monte-Carlo directions of the path tracer are injected as in
test_torch_port_training.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.config import parse_string
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.models.loss import IDRLoss as JLoss
from nefii_tpu.ops import sampling as js
from nefii_tpu.ops import sg as jsg
from nefii_tpu.parallel import spmd
from nefii_tpu.parallel.mesh import make_mesh
from nefii_tpu.scripts import render as jrender
from nefii_tpu.utils import exr
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models import idr as tidr
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.ops import sg as tsg
from nefii_tpu_torch.scripts import render
from nefii_tpu_torch.training import exp_runner
from nefii_tpu_torch.training.trainer import distillation_loss
from nefii_tpu_torch.utils.checkpoints import params_from_jax

from test_torch_port_training import (
    LOSS_CONF, LOSS_REL, MODEL_CONF, TERMS, _assert_group_grads, _batch,
    _patch_samplers, _rel,
)

SG_ATOL = 1e-6
GROUPS = ("implicit_network", "rendering_network", "envmap_material_network")
# confs/physg.conf at small widths: global materials, no geometry feature
PHYSG_MODEL = """
model {
    feature_vector_size = 0
    implicit_network {
        d_in = 3
        d_out = 1
        dims = [ 64, 64, 64, 64 ]
        geometric_init = True
        bias = 0.6
        skip_in = [2]
        weight_norm = True
        multires = 4
    }
    envmap_material_network {
        multires = 4
        dims = [ 64, 64 ]
        white_specular = True
        white_light = False
        num_lgt_sgs = 8
        num_base_materials = 1
        upper_hemi = False
        fix_specular_albedo = False
    }
    rendering_network {
        mode = idr
        d_in = 9
        d_out = 3
        dims = [ 64, 64 ]
        weight_norm = True
        multires_view = 2
        multires_xyz = 4
        normalize_output = True
    }
    ray_tracer {
        object_bounding_sphere = 1.0
        sdf_threshold = 5.0e-5
        line_search_step = 0.5
        line_step_iters = 1
        sphere_tracing_iters = 5
        n_steps = 32
        n_rootfind_steps = 8
    }
}
"""
PHYSG_TRAIN = """
train {
    expname = port_physg
    dataset_class = datasets.scene_dataset.SceneDataset
    model_class = model.implicit_differentiable_renderer.IDRNetwork
    loss_class = model.loss.IDRLoss
    plot_freq = 1
    val_freq = -1
    ckpt_freq = 100
    num_pixels = 64
    idr_learning_rate = 5e-4
    sg_learning_rate = 5e-4
}
loss {
    idr_rgb_weight = 0.0
    sg_rgb_weight = 1.0
    eikonal_weight = 0.1
    mask_weight = 100.0
    alpha = 50.0
    normalsmooth_weight = 1.0
    r_patch = 1.0
    loss_type = L1
}
""" + PHYSG_MODEL


def _models(model_text):
    conf = parse_string(model_text).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, params_from_jax(IDRNetwork.from_conf(conf), flatten_tree(params))


@pytest.fixture(scope="module")
def physg_models():
    return _models(PHYSG_MODEL)


@pytest.fixture(scope="module")
def pt_models():
    return _models(MODEL_CONF)


# ---------------------------------------------------------------------------
# the closed-form SG renderer
# ---------------------------------------------------------------------------

def _sg_inputs(light, blend):
    rs = np.random.RandomState(3)
    N, K = 64, 3 if blend else 1
    if light == "random":
        lgt = rs.randn(8, 7).astype(np.float32)
        lgt[:, 3] = np.abs(lgt[:, 3]) * 20 + 1
    else:  # the material net's initial light, as JAX initialises it
        jmodel = JIDR.from_conf(parse_string(PHYSG_MODEL).get_config("model"))
        em = jmodel.envmap_material_network
        lgt = np.array(em.get_lgtSGs(em.init_params(jax.random.PRNGKey(0))))
    spec = rs.uniform(0.02, 0.9, (K, 3)).astype(np.float32)
    rough = rs.uniform(0.1, 0.9, (K, 1)).astype(np.float32)
    albedo = rs.uniform(0, 1, (N, 3)).astype(np.float32)
    normal = rs.randn(N, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    view = (normal + 0.8 * rs.randn(N, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    w = rs.uniform(0, 1, (N, K)).astype(np.float32)
    return (lgt, spec, rough, albedo, normal, view), (w / w.sum(-1, keepdims=True) if blend
                                                       else None)


def _x64(fn, *args):
    """fn(*args) in the JAX package at float64: the reference value of the
    formula, independent of the port."""
    with jax.enable_x64(True):
        out = fn(*jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), args))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def _assert_sg_close(name, port, jax_value, exact):
    """port within SG_ATOL of jax_value, or within the JAX package's own
    distance from its float64 value `exact` where that is larger."""
    jax_fp32_err = float(np.abs(jax_value - exact).max())
    err = float(np.abs(port - jax_value).max())
    assert err <= max(SG_ATOL, jax_fp32_err), (name, err, jax_fp32_err)


@pytest.mark.parametrize("light", ["random", "model_init"])
@pytest.mark.parametrize("blend", [False, True], ids=["global", "blended"])
def test_render_with_sg_matches_jax(blend, light):
    """Each output within SG_ATOL of JAX's, or, where the fp32 formula itself
    is further than that from its float64 value (its cancellations: the
    clamped-cosine SG is 32.7 SG - 31.7 SG, and 1/roughness^4), within the
    JAX package's own distance from that float64 value."""
    args, w = _sg_inputs(light, blend)
    j = jsg.render_with_sg(*map(jnp.asarray, args),
                           blending_weights=None if w is None else jnp.asarray(w))
    t = tsg.render_with_sg(*map(torch.from_numpy, args),
                           blending_weights=None if w is None else torch.from_numpy(w))
    exact = _x64(lambda *a: jsg.render_with_sg(*a[:6], blending_weights=a[6]), *args, w)
    for k in ("sg_rgb", "sg_specular_rgb", "sg_diffuse_rgb", "sg_diffuse_albedo"):
        assert np.abs(np.asarray(j[k])).max() > 0, k
        _assert_sg_close(k, t[k].numpy(), np.asarray(j[k]), exact[k])


def test_render_sg_rgb_matches_jax(physg_models):
    jmodel, params, model = physg_models
    rs = np.random.RandomState(5)
    N = 32
    normals = rs.randn(N, 3).astype(np.float32)
    view = rs.randn(N, 3).astype(np.float32)
    albedo = rs.uniform(0, 1, (N, 3)).astype(np.float32)
    mask = rs.uniform(size=N) < 0.7
    j = jmodel.render_sg_rgb(params, jnp.asarray(mask), jnp.asarray(normals), jnp.asarray(view),
                             jnp.asarray(albedo))
    inputs = [torch.from_numpy(a) for a in (mask, normals, view, albedo)]
    t = model.render_sg_rgb(*inputs)
    exact = _x64(lambda p, *a: jmodel.render_sg_rgb(p, mask, *a), params, normals, view, albedo)
    for k in ("sg_rgb_values", "sg_diffuse_rgb_values", "sg_specular_rgb_values",
              "sg_diffuse_albedo_values", "sg_roughness", "sg_specular_reflectance"):
        _assert_sg_close(k, t[k].numpy(), np.asarray(j[k]), exact[k])


@pytest.mark.parametrize("text", [PHYSG_MODEL, MODEL_CONF], ids=["physg", "pt"])
def test_sdf_input_grad_matches_autograd(text):
    """The live gradient, the chain rule in tensor ops, against autograd's:
    its values (atol 1e-6) and its own gradient to the parameters through an
    eikonal loss (second order, rel L2 1e-5)."""
    imp = IDRNetwork.from_conf(parse_string(text).get_config("model"), seed=0).implicit_network
    pts = torch.from_numpy(np.random.RandomState(6).uniform(-0.8, 0.8, (64, 3)).astype(np.float32))
    p = pts.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(imp(p)[:, 0].sum(), p, create_graph=True)
    got = imp.sdf_feature_grad(pts, value_only=False)[2]
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=1e-6)
    params = list(imp.parameters())

    def second(g):
        loss = ((g.norm(dim=-1) - 1.0) ** 2).sum()
        return torch.cat([x.reshape(-1) for x in torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True)])

    a, b = second(got), second(ref)
    assert float((a - b).norm() / b.norm()) <= 1e-5
    assert not imp.sdf_feature_grad(pts, value_only=False, grad_graph=False)[2].requires_grad


# ---------------------------------------------------------------------------
# one unfrozen step
# ---------------------------------------------------------------------------

def _live_step(models, secondary_limit=0):
    """Forward, IDRLoss and backward of both packages with live geometry, on
    _batch() with its eikonal points injected."""
    jmodel, params, model = models
    batch, gt = _batch()
    n_rays = batch["uv"][..., 0].size
    batch["eik_override"] = np.random.RandomState(11).uniform(
        -1.0, 1.0, (n_rays // 2, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    steps01 = np.array(jax.random.uniform(jax.random.split(key, 3)[0],
                                          (jmodel.ray_tracer.n_steps,)))
    jloss, tloss = JLoss(**LOSS_CONF), IDRLoss(**LOSS_CONF)
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)

        def loss_fn(p):
            out = jmodel.forward(p, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                 training=True, freeze_geo=False)
            ld = jloss(out, {k: jnp.asarray(v) for k, v in gt.items()})
            return ld["loss"], (ld, out)

        (_, (jld, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

        build_k2 = tidr.build_fused_sdf_feature_grad

        def k2_values_only(network):
            fn = build_k2(network)

            def guarded(pts):
                assert not torch.is_grad_enabled(), "K2 (no backward) in a live-geometry graph"
                return fn(pts)
            return guarded

        mp.setattr(tidr, "build_fused_sdf_feature_grad", k2_values_only)
        model.zero_grad(set_to_none=True)
        tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0), training=True,
                                     freeze_geo=False, steps01=torch.from_numpy(steps01),
                                     secondary_limit=secondary_limit)
        tld = tloss(tout, {k: torch.from_numpy(v) for k, v in gt.items()})
        tld["loss"].backward()
    return jld, jout, jgrads, tld, tout


@pytest.fixture(scope="module")
def physg_step(physg_models):
    return _live_step(physg_models)


@pytest.fixture(scope="module")
def pt_step(pt_models):
    batch, _ = _batch()
    return _live_step(pt_models, secondary_limit=3 * batch["uv"][..., 0].size)


# the model outputs the loss reads
LOSS_INPUTS = ("network_object_mask", "object_mask", "idr_rgb_values", "sg_rgb_values",
               "normal_values", "sg_roughness_values", "grad_theta", "sdf_output")


def _assert_term(step, term):
    """The port's loss term within LOSS_REL of JAX's. A patch-variance term of
    near-equal values (the roughness of a freshly initialised material net
    over one 2x2 patch: a variance ~1e-7 of values ~0.5) moves by ~1e-4 of
    itself with a one-ulp change of its inputs; such a term is held in two
    parts instead: its inputs within 1e-6 of JAX's, and the JAX loss on the
    port's outputs within LOSS_REL of the port's term."""
    jld, jout, _, tld, tout = step
    got = tld[term].detach()
    if _rel(got, jld[term]) <= LOSS_REL or float(jld[term]) == 0.0:
        return
    assert term in ("normalsmooth_loss", "roughnesssmooth_loss"), (term, _rel(got, jld[term]))
    for k in ("normal_values", "sg_roughness_values"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=1e-6,
                                   err_msg=k)
    _, gt = _batch()
    on_port = JLoss(**LOSS_CONF)({k: jnp.asarray(tout[k].detach().numpy()) for k in LOSS_INPUTS},
                                 {k: jnp.asarray(v) for k, v in gt.items()})
    assert _rel(got, on_port[term]) <= LOSS_REL, term


@pytest.mark.parametrize("term", TERMS)
def test_physg_step_loss_terms_match_jax(physg_step, term):
    jld = physg_step[0]
    for k in ("eikonal_loss", "mask_loss", "sg_rgb_loss"):
        assert float(jld[k]) > 0, k
    _assert_term(physg_step, term)


@pytest.mark.parametrize("group", GROUPS)
def test_physg_step_gradients_match_jax(physg_step, physg_models, group):
    _assert_group_grads(physg_step[2], physg_models[2], group)


@pytest.mark.parametrize("term", TERMS)
def test_live_pt_step_loss_terms_match_jax(pt_step, term):
    jld = pt_step[0]
    for k in ("eikonal_loss", "mask_loss", "sg_rgb_loss", "idr_rgb_loss"):
        assert float(jld[k]) > 0, k
    _assert_term(pt_step, term)


@pytest.mark.parametrize("group", GROUPS)
def test_live_pt_step_gradients_match_jax(pt_step, pt_models, group):
    _assert_group_grads(pt_step[2], pt_models[2], group)


def test_live_pt_step_outputs_match_jax(pt_step):
    """The eikonal gradients, the attached mask-loss sdf and the secondary-hit
    pool of the live step are JAX's."""
    _, jout, _, _, tout = pt_step
    np.testing.assert_allclose(tout["grad_theta"].detach().numpy(),
                               np.asarray(jout["grad_theta"]), atol=1e-5)
    assert tout["sdf_output"].requires_grad
    np.testing.assert_allclose(tout["sdf_output"].detach().numpy(),
                               np.asarray(jout["sdf_output"]), atol=1e-5)
    jm = np.asarray(jout["secondary_mask"])
    assert jm.any()
    np.testing.assert_array_equal(tout["secondary_mask"].numpy(), jm)


def test_live_distillation_step_matches_jax(pt_models):
    """The secondary step with live geometry: normals detached, features
    attached, so the implicit net's gradient comes through the features."""
    jmodel, params, model = pt_models
    rs = np.random.RandomState(4)
    K, Rd = 24, 2
    pts = rs.randn(K, 3)
    pts = (0.6 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)
    dirs = rs.randn(K, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = {"points": np.ascontiguousarray(np.broadcast_to(pts[:, None], (K, Rd, 3))),
             "ray_dirs": np.ascontiguousarray(np.broadcast_to(dirs[:, None], (K, Rd, 3)))}
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)
        fn = jax.jit(spmd.make_point_grad_fn(jmodel, make_mesh(1), freeze_geo=False)())
        jld, jgrads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.ones(K, jnp.float32), jax.random.PRNGKey(0))
        model.zero_grad(set_to_none=True)
        loss = distillation_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 torch.Generator().manual_seed(0), freeze_geo=False)
        loss.backward()
    assert _rel(loss.detach(), jld["loss"]) <= LOSS_REL
    for group in GROUPS:
        _assert_group_grads(jgrads, model, group)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _port_live_grads(model_text, remat, strategies):
    """Loss terms and gradients of one live-geometry step of the port with its
    own draws: samples, eikonal points and min-SDF steps from the generator."""
    conf = parse_string(model_text).get_config("model")
    model = IDRNetwork.from_conf(conf, seed=0)
    model.remat_strategies = strategies
    batch, gt = _batch()
    model.zero_grad(set_to_none=True)
    out = model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(0), training=True,
                                freeze_geo=False, remat=remat)
    ld = IDRLoss(**LOSS_CONF)(out, {"rgb": torch.from_numpy(gt["rgb"])})
    ld["loss"].backward()
    return ({k: v.detach() for k, v in ld.items()},
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None})


@pytest.fixture(scope="module")
def no_remat():
    return _port_live_grads(MODEL_CONF, False, False)


@pytest.mark.parametrize("remat,strategies", [(True, False), (False, True), (True, True)],
                         ids=["train_remat", "remat_strategies", "both"])
def test_remat_gives_the_same_loss_and_gradients(no_remat, remat, strategies):
    ld0, g0 = no_remat
    ld, g = _port_live_grads(MODEL_CONF, remat, strategies)
    for k in ld0:
        assert torch.equal(ld[k], ld0[k]), k
    assert set(g) == set(g0) and any(n.startswith("implicit_network.") for n in g)
    for n in g0:
        assert torch.equal(g[n], g0[n]), n


# ---------------------------------------------------------------------------
# exp_runner and the render CLI on the PhySG conf
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def physg_trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_physg")
    conf_path = d / "physg.conf"
    conf_path.write_text(PHYSG_TRAIN)
    scene = write_sphere_scene(str(d / "scene"), n_views=2, res=16)
    runner = exp_runner.main([
        "--conf", str(conf_path), "--data_split_dir", scene, "--exps_folder_name",
        str(d / "exps"), "--max_niter", "1", "--device", "cpu"])
    return runner, d, scene


def test_exp_runner_trains_physg_with_live_geometry(physg_trained):
    runner, _, _ = physg_trained
    assert [s["iter"] for s in runner.step_stats] == [0, 1]
    assert all(np.isfinite(s["loss"]) for s in runner.step_stats)
    # the uploads, the tracer's reads, the loss's check: counted on the CPU too
    assert all(s["host_syncs"] > 10 for s in runner.step_stats), runner.step_stats
    assert runner.model.render_type == "sg" and not runner.freeze_geo
    before = IDRNetwork.from_conf(parse_string(PHYSG_TRAIN).get_config("model"), seed=0)
    moved = {net: any(not torch.equal(p.detach(), q.detach()) for (n, p), q in
                      zip(runner.model.named_parameters(), before.parameters())
                      if n.startswith(net + "."))
             for net in GROUPS}
    # idr_rgb_weight = 0: the IDR radiance net gets no gradient, as in JAX
    assert moved == {"implicit_network": True, "rendering_network": False,
                     "envmap_material_network": True}
    assert {"train_0.png", "train_0_sg_rgb.exr"} <= set(os.listdir(runner.plots_dir))


def test_render_cli_renders_the_physg_checkpoint_as_jax(physg_trained, tmp_path):
    """`render.py --num_rays -1` on the trained PhySG checkpoint, through both
    packages' CLIs: the same EXRs, the shaded ones within the fp32 noise of
    the SG formula (rtol 1e-4: its cancellations put each package ~1e-5 of a
    value from the float64 result, test_render_with_sg_matches_jax)."""
    runner, d, scene = physg_trained
    argv = ["--conf", str(d / "physg.conf"), "--data_split_dir", scene, "--old_expdir",
            runner.expdir, "--timestamp", runner.timestamp, "--num_rays", "-1",
            "--max_views", "1", "--memory_capacity_level", "8"]
    out = render.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jrender.main(argv + ["--out_dir", str(tmp_path / "jax"), "--no_auto_budget"])
    assert 0 < out.stats[0]["hit_fraction"] < 1 and out.stats[0]["rays"] == 16 * 16
    for name in ("rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo", "roughness",
                 "specular_reflection", "gt"):
        t = exr.read(str(tmp_path / "port" / f"{name}_000.exr"))
        j = exr.read(str(tmp_path / "jax" / f"{name}_000.exr"))
        assert t.shape == j.shape == (16, 16, 3), name
        shaded = name.endswith("_rgb")
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-4 if shaded else 0, err_msg=name)
    # lobes of sharpness up to ~270 turn an ulp of <v, lobe> into ~1e-5 of the SG
    np.testing.assert_allclose(exr.read(str(tmp_path / "port" / "envmap.exr")),
                               exr.read(str(tmp_path / "jax" / "envmap.exr")), atol=1e-5,
                               rtol=1e-4)
