"""Step-2 training through the render types of this slice: the port against
the JAX package on the same numpy-seeded inputs, JAX-initialised weights,
injected Monte-Carlo directions (test_torch_port_render_types.py's: some
secondary rays into the surface, some out) and injected min-SDF vectors of
the primary and, for the `diff_geo` types, the secondary tracer (the JAX
engine draws the latter from its render key, the port from `gen`; the
secondary trace of a `diff_geo` type in training gives its misses the
min-SDF points, at which soft visibility reads the SDF).

Cases, each gated at loss terms rel 1e-5 and every parameter group's
gradient at a relative L2 of 2e-3 (the parity suite's gates):
  * `path_tracing_diff_shadow` with live geometry: the soft-visibility
    gradient into the implicit net;
  * frozen steps of `pt_render_diff_shadow_indirect_blend` (K = 2 blended
    materials, soft visibility and eq. 3 indirect radiance),
    `pt_render_shadow_indirect_mlp_envmap` (the gradient into the [M,M,3]
    map through the lookup's gather) and `path_tracing_sg`, with the
    secondary-hit pool where the type has one;
  * one distillation step of `pt_render_diff_shadow_indirect_mlp` (soft
    visibility at the min-SDF points of its misses);
  * `exp_runner` trains a `diff_geo` conf for 2 iterations without
    --freeze_geometry, a distillation step after each, and plots a
    constant light's envmap;
  * the render CLI renders a checkpoint the JAX package wrote with each
    render type, and writes the envmap.exr of a constant light equal to the
    JAX package's (its write_envmap's compute_envmap) at rtol 1e-5.
The port runs the plain versions of K1, K2 and K3 (CPU tensors)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.models.loss import IDRLoss as JLoss
from nefii_tpu.ops import sampling as js
from nefii_tpu.ops import sg as jsg
from nefii_tpu.parallel import spmd
from nefii_tpu.parallel.mesh import make_mesh
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils import exr
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import PT_RENDER_TYPES, IDRNetwork
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.scripts import render
from nefii_tpu_torch.training import exp_runner

from test_torch_port_physg import LOSS_INPUTS
from test_torch_port_render_types import build, patch_samplers, type_conf
from test_torch_port_training import (
    LOSS_CONF, LOSS_REL, TERMS, TRAIN_CONF, _assert_group_grads, _batch, _rel,
)

GROUPS = ("implicit_network", "rendering_network", "envmap_material_network")


def step_conf(rt: str) -> str:
    """type_conf(rt) with the K3 trace (its plain version on the CPU)."""
    return type_conf(rt).replace("fused_sdf_dtype = float32",
                                 "fused_sdf_dtype = float32\n    use_fused_trace = True")


def _steps01(jmodel, key):
    """The min-SDF vectors the JAX step draws from `key`: the primary
    tracer's (forward_with_uv's k_trace) and the secondary trace's
    (pt_render_core's first trace key, from the render key)."""
    k_trace, _, k_render = jax.random.split(key, 3)
    S = len(PT_RENDER_TYPES[jmodel.render_type].get("strategies", ()))
    sec = jmodel.secondary_ray_tracer or jmodel.ray_tracer
    primary = np.array(jax.random.uniform(k_trace, (jmodel.ray_tracer.n_steps,)))
    if not S:
        return primary, None
    k_sec = jax.random.split(jax.random.split(k_render, S + 1)[S], S)[0]
    return primary, np.array(jax.random.uniform(k_sec, (sec.n_steps,)))


def _step(rt, live):
    """Forward, IDRLoss and backward of both packages on _batch()."""
    jmodel, params, model = build(step_conf(rt))
    batch, gt = _batch()
    if live:
        n_rays = batch["uv"][..., 0].size
        batch["eik_override"] = np.random.RandomState(11).uniform(
            -1.0, 1.0, (n_rays // 2, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    steps01, sec01 = _steps01(jmodel, key)
    jloss, tloss = JLoss(**LOSS_CONF), IDRLoss(**LOSS_CONF)
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp, js, jnp)
        patch_samplers(mp, ts, torch)

        def loss_fn(p):
            out = jmodel.forward(p, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                 training=True, freeze_geo=not live)
            ld = jloss(out, {k: jnp.asarray(v) for k, v in gt.items()})
            return ld["loss"], (ld, out)

        (_, (jld, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        model.zero_grad(set_to_none=True)
        tout = model.forward_with_uv(
            {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(0),
            training=True, freeze_geo=not live, steps01=torch.from_numpy(steps01),
            secondary_steps01=None if sec01 is None else torch.from_numpy(sec01),
            secondary_limit=3 * batch["uv"][..., 0].size)
        tld = tloss(tout, {k: torch.from_numpy(v) for k, v in gt.items()})
        tld["loss"].backward()
    return (jld, jout, jgrads, tld, tout), model


STEPS = {
    "path_tracing_diff_shadow": True,
    "pt_render_diff_shadow_indirect_blend": False,
    "pt_render_shadow_indirect_mlp_envmap": False,
    "path_tracing_sg": False,
}


@pytest.fixture(scope="module", params=list(STEPS))
def step(request):
    rt = request.param
    return rt, STEPS[rt], *_step(rt, STEPS[rt])


@pytest.mark.parametrize("term", TERMS)
def test_step_loss_terms_match_jax(step, term):
    """Each loss term within LOSS_REL of JAX's. A patch-variance term of
    near-equal values (the roughness of a freshly initialised material net
    over one 2x2 patch) moves by ~1e-4 of itself with a one-ulp change of
    its inputs; such a term is held in two parts instead, as in
    test_torch_port_physg.py: its inputs within 1e-6 of JAX's, and the JAX
    loss on the port's outputs within LOSS_REL of the port's term."""
    _, _, (jld, jout, _, tld, tout), _ = step
    got = tld[term].detach()
    assert np.isfinite(float(got))
    if _rel(got, jld[term]) <= LOSS_REL or float(jld[term]) == 0.0:
        return
    assert term in ("normalsmooth_loss", "roughnesssmooth_loss"), (term, _rel(got, jld[term]))
    for k in ("normal_values", "sg_roughness_values"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=1e-6,
                                   err_msg=k)
    _, gt = _batch()
    on_port = JLoss(**LOSS_CONF)(
        {k: None if tout[k] is None else jnp.asarray(tout[k].detach().numpy())
         for k in LOSS_INPUTS},
        {k: jnp.asarray(v) for k, v in gt.items()})
    assert _rel(got, on_port[term]) <= LOSS_REL, term


@pytest.mark.parametrize("group", GROUPS)
def test_step_gradients_match_jax(step, group):
    rt, live, pair, model = step
    if group == "implicit_network" and not live:
        for n, p in model.implicit_network.named_parameters():
            assert p.grad is None or not p.grad.any(), n
        return
    _assert_group_grads(pair[2], model, group)


def test_step_secondary_pool_matches_jax(step):
    """The secondary-hit pool of the types with a shadow (the JAX pipeline's,
    at the hits); none for the others."""
    rt, _, pair, _ = step
    jout, tout = pair[1], pair[4]
    if PT_RENDER_TYPES[rt].get("shadow") is None:
        assert "secondary_mask" not in tout
        return
    jm = np.asarray(jout["secondary_mask"])
    tm = tout["secondary_mask"].numpy()
    assert tm.any() and not tm.all()
    np.testing.assert_array_equal(tm, jm)
    sel = tm[..., 0]
    np.testing.assert_allclose(tout["secondary_points"].numpy()[sel],
                               np.asarray(jout["secondary_points"])[sel], atol=1e-4)


def test_distillation_step_of_a_diff_geo_type_matches_jax():
    """forward_with_point of pt_render_diff_shadow_indirect_mlp, frozen: soft
    visibility at the min-SDF points of the secondary misses (the vector the
    JAX step draws from its key injected), indirect radiance at the eq. 3
    points of the hits."""
    jmodel, params, model = build(step_conf("pt_render_diff_shadow_indirect_mlp"))
    rs = np.random.RandomState(4)
    K, Rd = 24, 2
    pts = rs.randn(K, 3)
    pts = (0.6 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)
    dirs = rs.randn(K, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = {"points": np.ascontiguousarray(np.broadcast_to(pts[:, None], (K, Rd, 3))),
             "ray_dirs": np.ascontiguousarray(np.broadcast_to(dirs[:, None], (K, Rd, 3)))}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)  # make_point_grad_fn's on device 0
    k_sec = jax.random.split(jax.random.split(key, 4)[3], 3)[0]
    sec01 = np.array(jax.random.uniform(k_sec, (jmodel.ray_tracer.n_steps,)))
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp, js, jnp)
        patch_samplers(mp, ts, torch)
        fn = jax.jit(spmd.make_point_grad_fn(jmodel, make_mesh(1), freeze_geo=True)())
        jld, jgrads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.ones(K, jnp.float32), jax.random.PRNGKey(0))
        model.zero_grad(set_to_none=True)
        out = model.forward_with_point({k: torch.from_numpy(v) for k, v in batch.items()},
                                       torch.Generator().manual_seed(0), freeze_geo=True,
                                       secondary_steps01=torch.from_numpy(sec01))
        # the trainer's distillation_loss: L1(sg_rgb, idr_rgb)
        loss = (out["sg_rgb_values"] - out["idr_rgb_values"]).abs().mean()
        loss.backward()
    assert float(jld["loss"]) > 0
    assert _rel(loss.detach(), jld["loss"]) <= LOSS_REL
    for group in ("rendering_network", "envmap_material_network"):
        _assert_group_grads(jgrads, model, group)


def test_exp_runner_trains_a_diff_geo_type(tmp_path):
    """Two iterations of pt_render_diff_shadow_indirect_mlp without
    --freeze_geometry, a distillation step after each: finite losses, and
    every network moved."""
    text = TRAIN_CONF.replace("render_type = pt_render_indirect_mlp",
                              "render_type = pt_render_diff_shadow_indirect_mlp")
    assert text != TRAIN_CONF
    conf_path = tmp_path / "train.conf"
    conf_path.write_text(text)
    scene = write_sphere_scene(str(tmp_path / "scene"), n_views=2, res=16)
    runner = exp_runner.main([
        "--conf", str(conf_path), "--data_split_dir", scene, "--exps_folder_name",
        str(tmp_path / "exps"), "--max_niter", "1", "--secondary_train_interval", "1",
        "--secondary_batch_size", "32", "--device", "cpu"])
    stats = runner.step_stats
    assert [s["iter"] for s in stats] == [0, 1]
    assert all(np.isfinite(s["loss"]) for s in stats)
    assert any(s["secondary_points"] > 0 for s in stats)
    from nefii_tpu_torch.config import parse_string

    before = IDRNetwork.from_conf(parse_string(text).get_config("model"), seed=0)
    for net in GROUPS:
        assert any(not torch.equal(p.detach(), q.detach()) for (n, p), q in
                   zip(runner.model.named_parameters(), before.parameters())
                   if n.startswith(net + ".")), net


def test_exp_runner_plots_the_constant_light(tmp_path):
    """One iteration of a constant-light type: the trainer's plot writes the
    envmap of the [M,M,3] map, resized to 64 x 128 (its shrinking side
    antialiased, as jax.image.resize does)."""
    text = TRAIN_CONF.replace(
        "render_type = pt_render_indirect_mlp",
        "render_type = pt_render_shadow_indirect_mlp_envmap").replace(
        "white_light = False", "white_light = False\n        light_type = constant")
    conf_path = tmp_path / "train.conf"
    conf_path.write_text(text)
    scene = write_sphere_scene(str(tmp_path / "scene"), n_views=1, res=16)
    runner = exp_runner.main([
        "--conf", str(conf_path), "--data_split_dir", scene, "--freeze_geometry",
        "--exps_folder_name", str(tmp_path / "exps"), "--max_niter", "0", "--device", "cpu"])
    assert runner.model.envmap_material_network.light_type == "constant"
    env = exr.read(os.path.join(runner.plots_dir, "train_0_envmap.exr"))
    assert env.shape[:2] == (64, 128) and np.isfinite(env).all() and env.min() >= 0


@pytest.mark.parametrize("rt", ["sg"] + list(PT_RENDER_TYPES))
def test_render_cli_renders_each_type(rt, tmp_path):
    """render.main (--device cpu) on a checkpoint the JAX package wrote:
    finite EXRs for every render type; a constant light's envmap.exr equals
    the JAX package's compute_envmap of the same map (what its write_envmap
    writes) at rtol 1e-5."""
    text = type_conf("pt_render_indirect_mlp" if rt == "sg" else rt)
    if rt == "sg":  # the PhySG baseline's closed-form render: global materials
        text = text.replace("render_type = pt_render_indirect_mlp", "render_type = sg")
        for k in ("roughness_mlp", "specular_mlp", "same_mlp"):
            text = text.replace(f"{k} = True", f"{k} = False")
    conf_text = ("train {\n    expname = port_types\n"
                 "    dataset_class = datasets.scene_dataset.SceneDataset\n"
                 "    model_class = model.implicit_differentiable_renderer.IDRNetwork\n}\n"
                 + text)
    conf_path = tmp_path / "render.conf"
    conf_path.write_text(conf_text)
    jmodel, params, _ = build(text)
    exp = tmp_path / "exps" / "port_types"
    jck.save_collection(str(exp / "2026_01_01" / "checkpoints"), jck.MODEL, "latest", params,
                        {"epoch": 1})
    scene = SceneDataset.write_camera_only_split(str(tmp_path / "scene"), 1, 8, focal=10.0)
    out_dir = tmp_path / "renders"
    runner = render.main([
        "--conf", str(conf_path), "--data_split_dir", scene, "--old_expdir", str(exp),
        "--num_rays", "2", "--device", "cpu", "--out_dir", str(out_dir),
        "--memory_capacity_level", "6"])
    assert runner.model.render_type == rt and len(runner.stats) == 1
    assert 0 < runner.stats[0]["hit_fraction"] < 1
    for name in ("rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo", "roughness"):
        assert np.isfinite(exr.read(str(out_dir / f"{name}_000.exr"))).all(), name
    env = exr.read(str(out_dir / "envmap.exr"))
    assert env.shape[:2] == (256, 512) and np.isfinite(env).all()
    em = jmodel.envmap_material_network
    if em.light_type != "sg":
        ref = np.asarray(jsg.compute_envmap(em.get_lgtSGs(params["envmap_material_network"]),
                                            256, 512, envmap_type="constant"))
        np.testing.assert_allclose(env[..., :3], ref, rtol=1e-5)
