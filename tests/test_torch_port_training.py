"""Step-2 training with frozen geometry: the port against the JAX package on
the same numpy-seeded inputs and JAX-initialised weights (params_from_jax).

Cases and gates:
  * the tracer's training extras (min-SDF and projected points of the rays
    that miss), the shared min-SDF vector injected: masks equal, distances
    within 1e-5;
  * every IDRLoss term on seeded model outputs: rel 1e-5;
  * one frozen-geometry step through IDRNetwork.forward_with_uv and IDRLoss:
    the loss at rel 1e-5 and each parameter group's gradient at a relative
    L2 of 2e-3, the implicit net without gradient;
  * one masked Adam update against optax's multi_transform (atol 1e-6,
    frozen leaves bit-equal);
  * the secondary-distillation loss and gradients against the JAX
    make_point_grad_fn;
  * a two-iteration `exp_runner.main(... --device cpu)` on a 16x16 3-view
    scene, whose checkpoint the JAX package reads and the port's render CLI
    renders, and one step without --freeze_geometry under train.remat and
    model.remat_strategies, in which every network trains.

The Monte-Carlo directions are injected on both sides: each sampler is
replaced by wi = normalize(n + 0.9 t(n)) with t a fixed smooth function of
the normal per strategy, and the strategy's canonical pdf for it. Both
packages then draw the same direction for the same surface point, whatever
order they shade their rays in (the port shades the hit rays, and samples
the secondary rays of the rays that missed apart). The
port runs the plain versions of K1, K2 and K3 (CPU tensors)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nefii_tpu.config import parse_string
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.models.loss import IDRLoss as JLoss
from nefii_tpu.ops import sampling as js
from nefii_tpu.ops.ray_tracing import RayTracer as JRayTracer
from nefii_tpu.parallel import spmd
from nefii_tpu.parallel.mesh import make_mesh
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.ops.kernels import fused_trace as ft
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.scripts import profile_train, render
from nefii_tpu_torch.training import exp_runner
from nefii_tpu_torch.training.trainer import (
    AdamGroup, distillation_loss, multistep_lr, secondary_batch, trainable_names,
)
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils.checkpoints import params_from_jax

from test_idr_forward import SMALL_CONF

LOSS_REL = 1e-5
GRAD_REL_L2 = 2e-3
DIST_ATOL = 1e-5
LOSS_CONF = dict(idr_rgb_weight=1.0, sg_rgb_weight=1.0, eikonal_weight=0.1, mask_weight=100.0,
                 alpha=50.0, r_patch=1, normalsmooth_weight=1.0, loss_type="L1",
                 env_loss_type="L2", idr_ssim_weight=0.5, sg_ssim_weight=0.5,
                 roughnesssmooth_weight=1.0, background_rgb_weight=1.0)
MODEL_CONF = SMALL_CONF.replace(
    "render_type = pt_render_indirect_mlp",
    "render_type = pt_render_indirect_mlp\n    use_fused_sdf = True\n"
    "    fused_sdf_dtype = float32\n    use_fused_trace = True")
TRAIN_CONF = """
train {
    expname = port_train
    dataset_class = datasets.scene_dataset.SceneDataset
    model_class = model.implicit_differentiable_renderer.IDRNetwork
    loss_class = model.loss.IDRLoss
    plot_freq = 1
    val_freq = -1
    ckpt_freq = 100
    num_pixels = 64
    num_rays = 2
    alpha_milestones = [1]
    alpha_factor = 2
    idr_learning_rate = 5e-4
    idr_sched_milestones = [1]
    idr_sched_factor = 0.5
    sg_learning_rate = 5e-4
    sg_sched_milestones = [1]
    sg_sched_factor = 0.5
}
loss {
""" + "\n".join(f"    {k} = {v}" for k, v in LOSS_CONF.items()) + "\n}\n" + MODEL_CONF.replace(
    "n_rootfind_steps = 8\n    }",
    "n_rootfind_steps = 8\n    }\n    secondary_ray_tracer {\n        sphere_tracing_iters = 3\n"
    "        line_step_iters = 0\n        n_steps = 16\n    }")
B, S, R, W = 1, 16, 2, 64
CAM_Z = -2.0


# ---------------------------------------------------------------------------
# shared fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    conf = parse_string(MODEL_CONF).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    model = params_from_jax(IDRNetwork.from_conf(conf), flatten_tree(params))
    return jmodel, params, model


def _patch_uv(rs):
    """S pixels as S/4 2x2 patches (pixels of a patch consecutive, as
    change_sampling_idx_patch orders them) around centers on and off the
    sphere, each pixel with R jittered rays."""
    centers = np.array([[32, 32], [41, 27], [20, 44], [60, 4]], np.float64)
    du, dv = np.meshgrid(np.arange(-1, 1), np.arange(-1, 1))
    off = np.stack([du.reshape(-1), dv.reshape(-1)], -1)
    px = (centers[:, None, :] + off[None] + rs.uniform(-0.3, 0.3, (4, 1, 2))).reshape(S, 2)
    return (px[:, None, :] + rs.uniform(-0.5, 0.5, (S, R, 2)))[None].astype(np.float32)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2] = K[1, 2] = W / 2
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, CAM_Z]
    obj = np.ones((B, S), bool)
    obj[0, [2, 5, 13]] = False  # conflicts with the surface, and two unmasked misses
    obj[0, 12] = True
    batch = {"intrinsics": K[None], "uv": _patch_uv(rs), "pose": pose[None], "object_mask": obj}
    gt = {"rgb": rs.uniform(0.0, 1.0, (B, S, 3)).astype(np.float32)}
    return batch, gt


def _dir_tables():
    rs = np.random.RandomState(7)
    return [(rs.randn(3, 3) * 2.0).astype(np.float32) for _ in range(3)], \
        [rs.randn(3).astype(np.float32) for _ in range(3)]


def _patch_samplers(mp, mod, xp, side=1.0):
    """Replace the three samplers of `mod` (jax.numpy or torch as `xp`) by the
    deterministic directions of the module docstring; `side=-3` turns them
    into the surface: wi = normalize(-3 n + 0.9 t(n))."""
    A, c = _dir_tables()

    def wi_for(k, normal):
        if xp is jnp:
            t = jnp.sin(normal @ jnp.asarray(A[k]) + jnp.asarray(c[k]))
            w = side * normal + 0.9 * t / jnp.linalg.norm(t, axis=-1, keepdims=True)
            return w / jnp.linalg.norm(w, axis=-1, keepdims=True)
        t = torch.sin(normal @ torch.from_numpy(A[k]) + torch.from_numpy(c[k]))
        w = side * normal + 0.9 * t / torch.linalg.norm(t, dim=-1, keepdim=True)
        return w / torch.linalg.norm(w, dim=-1, keepdim=True)

    mp.setattr(mod, "cos_sampling", lambda key, n: (
        wi_for(0, n), mod.pdf_fn_cos(wi_for(0, n), n, None, None, None)))
    mp.setattr(mod, "brdf_sampling", lambda key, n, r, v: (
        wi_for(1, n), mod.pdf_fn_brdf_ggx(wi_for(1, n), n, v, r, None)))
    mp.setattr(mod, "mix_sg_sampling_shared", lambda key, n, lgt: (
        wi_for(2, n), mod.pdf_fn_mix_sg_shared(wi_for(2, n), n, None, None, lgt)))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _group_grads_jax(grads, group):
    flat = flatten_tree(grads)
    return {k.replace("/", "."): np.asarray(v) for k, v in flat.items()
            if k.startswith(group + "/")}


def _group_grads_torch(model, group):
    return {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
            for n, p in model.named_parameters() if n.startswith(group + ".")}


def _assert_group_grads(jgrads, model, group):
    jg = _group_grads_jax(jgrads, group)
    tg = _group_grads_torch(model, group)
    assert set(jg) == set(tg)
    a = np.concatenate([tg[k].reshape(-1) for k in sorted(jg)])
    b = np.concatenate([jg[k].reshape(-1) for k in sorted(jg)])
    assert np.linalg.norm(b) > 0, group
    err = _rel_l2(a, b)
    assert err <= GRAD_REL_L2, f"{group}: relative L2 {err:.3e}"


# ---------------------------------------------------------------------------
# tracer training extras
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_trace", [False, True], ids=["gathered", "k3_plain"])
def test_tracer_training_extras_match_jax(models, fused_trace):
    """The min-SDF and projected points of the rays that miss (mask loss)."""
    jmodel, params, model = models
    rs = np.random.RandomState(11)
    n = 96
    cam_loc = np.array([[0.0, 0.0, CAM_Z]], np.float32)
    tgt = rs.uniform(-0.9, 0.9, (1, n, 3)).astype(np.float32)
    tgt[0, :8] += np.array([0.0, 1.6, 0.0], np.float32)  # rays that miss the bounding sphere
    dirs = tgt - cam_loc[:, None, :]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    obj = rs.rand(n) < 0.6
    kw = dict(sdf_threshold=5e-5, line_search_step=0.5, line_step_iters=1,
              sphere_tracing_iters=5, n_steps=32, n_rootfind_steps=8)
    jt = JRayTracer(**kw)
    key = jax.random.PRNGKey(3)
    jres = jt(lambda x: jmodel.implicit_network.sdf(params["implicit_network"], x),
              jnp.asarray(cam_loc), jnp.asarray(obj), jnp.asarray(dirs), key=key, training=True)
    tracer = RayTracer(**kw)
    net = model.implicit_network
    with torch.no_grad():
        res = tracer(fm.build_fused_sdf(net, torch.float32), torch.from_numpy(cam_loc),
                     torch.from_numpy(obj), torch.from_numpy(dirs), training=True,
                     steps01=torch.from_numpy(np.array(jax.random.uniform(key, (32,)))),
                     sphere_trace_fn=ft.build_fused_sphere_trace(net, tracer) if fused_trace
                     else None)
    jm = np.asarray(jres.object_mask)
    assert 0 < jm.sum() < n and (~jm & ~obj).any() and (~jm & obj).any()
    np.testing.assert_array_equal(res.object_mask.numpy(), jm)
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists), atol=DIST_ATOL)


# ---------------------------------------------------------------------------
# IDRLoss, term by term
# ---------------------------------------------------------------------------

TERMS = ("loss", "idr_rgb_loss", "sg_rgb_loss", "eikonal_loss", "mask_loss",
         "normalsmooth_loss", "roughnesssmooth_loss", "idr_ssim_loss", "sg_ssim_loss",
         "background_rgb_loss")


@pytest.fixture(scope="module", params=[1, 3], ids=["r_patch1", "r_patch3"])
def loss_pair(request):
    r = request.param
    p = 4 * r * r
    n = 6 * p
    rs = np.random.RandomState(r)
    normal = rs.randn(n, 3).astype(np.float32)
    outputs = {
        "idr_rgb_values": rs.rand(n, 3).astype(np.float32),
        "sg_rgb_values": rs.rand(n, 3).astype(np.float32),
        "normal_values": normal / np.linalg.norm(normal, axis=-1, keepdims=True),
        "sdf_output": (rs.randn(n, 1) * 0.05).astype(np.float32),
        "network_object_mask": rs.rand(n) < 0.8,
        "object_mask": rs.rand(n) < 0.75,
        "grad_theta": rs.randn(2 * n, 3).astype(np.float32),
        "sg_roughness_values": rs.rand(n, 1).astype(np.float32),
        "sg_specular_rgb_values": rs.rand(n, 3).astype(np.float32),
    }
    outputs["network_object_mask"][:p] = outputs["object_mask"][:p] = True  # one whole patch
    gt = {"rgb": rs.rand(1, n, 3).astype(np.float32)}
    conf = dict(LOSS_CONF, r_patch=r, eikonal_weight=0.1)
    jout = JLoss(**conf)({k: jnp.asarray(v) for k, v in outputs.items()},
                         {k: jnp.asarray(v) for k, v in gt.items()}, alpha=jnp.float32(100.0))
    tout = IDRLoss(**conf)({k: torch.from_numpy(v) for k, v in outputs.items()},
                           {k: torch.from_numpy(v) for k, v in gt.items()}, alpha=100.0)
    return jout, tout


@pytest.mark.parametrize("term", TERMS)
def test_loss_term_matches_jax(loss_pair, term):
    jout, tout = loss_pair
    ref = float(jout[term])
    assert ref != 0.0, term
    assert _rel(tout[term], ref) <= LOSS_REL, (term, float(tout[term]), ref)


def test_loss_all_reduce_sums_the_pairs():
    """A two-shard all-reduce over halves of a batch gives the whole batch's
    loss (what a multi-GPU run relies on)."""
    rs = np.random.RandomState(5)
    n = 32
    out = {"idr_rgb_values": rs.rand(n, 3), "sg_rgb_values": rs.rand(n, 3),
           "normal_values": rs.randn(n, 3), "sdf_output": rs.randn(n, 1) * 0.05,
           "network_object_mask": rs.rand(n) < 0.7, "object_mask": rs.rand(n) < 0.7,
           "grad_theta": None, "sg_roughness_values": rs.rand(n, 1)}
    out = {k: (torch.as_tensor(v, dtype=torch.float32) if v is not None and v.dtype != bool
               else (torch.as_tensor(v) if v is not None else None)) for k, v in out.items()}
    gt = {"rgb": torch.as_tensor(rs.rand(1, n, 3), dtype=torch.float32)}
    loss = IDRLoss(**LOSS_CONF)
    whole = loss(out, gt)

    def half(i):
        sl = slice(i * n // 2, (i + 1) * n // 2)
        return ({k: (v[sl] if v is not None else None) for k, v in out.items()},
                {"rgb": gt["rgb"][:, sl]})

    # each shard's pairs, recorded, then summed as an all-reduce would
    pairs = [[], []]
    for i in range(2):
        loss(*half(i), all_reduce=lambda t, i=i: pairs[i].append(t) or t)
    it = iter(range(len(pairs[0])))
    reduced = [a + b for a, b in zip(*pairs)]
    shard = loss(*half(0), all_reduce=lambda t: reduced[next(it)])
    for term in TERMS:
        assert _rel(shard[term], whole[term]) <= LOSS_REL or float(whole[term]) == 0.0, term


# ---------------------------------------------------------------------------
# one frozen-geometry training step
# ---------------------------------------------------------------------------

def _whole_pool(batch):
    """A `secondary_limit` that keeps every strategy's secondary hits: the
    three strategies times the batch's rays."""
    return 3 * batch["uv"][..., 0].size


@pytest.fixture(scope="module")
def step_pair(models):
    jmodel, params, model = models
    batch, gt = _batch()
    key = jax.random.PRNGKey(1)
    k_trace = jax.random.split(key, 3)[0]
    steps01 = np.array(jax.random.uniform(k_trace, (jmodel.ray_tracer.n_steps,)))
    jloss, tloss = JLoss(**LOSS_CONF), IDRLoss(**LOSS_CONF)
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)

        def loss_fn(p):
            out = jmodel.forward(p, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                 training=True, freeze_geo=True)
            ld = jloss(out, {k: jnp.asarray(v) for k, v in gt.items()})
            return ld["loss"], (ld, out)

        (_, (jld, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        model.zero_grad(set_to_none=True)
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0), training=True,
                                     freeze_geo=True, steps01=torch.from_numpy(steps01),
                                     secondary_limit=_whole_pool(batch))
        tld = tloss(tout, {k: torch.from_numpy(v) for k, v in gt.items()})
        tld["loss"].backward()
    return jld, jout, jgrads, tld, tout


def test_training_step_outputs_match_jax(step_pair):
    jld, jout, _, tld, tout = step_pair
    jm = np.asarray(jout["network_object_mask"])
    assert 0 < jm.sum() < jm.size
    np.testing.assert_array_equal(tout["network_object_mask"].numpy(), jm)
    np.testing.assert_allclose(tout["sdf_output"].detach().numpy(),
                               np.asarray(jout["sdf_output"]), atol=DIST_ATOL)
    for k in ("mask_loss", "idr_rgb_loss", "sg_rgb_loss", "background_rgb_loss"):
        assert float(jld[k]) != 0.0, k
    assert _rel(tld["loss"].detach(), jld["loss"]) <= LOSS_REL
    # CPU tensors: the plain versions ran, no kernel launch
    assert all(v == 0 for v in {**fm.LAUNCHES, **ft.LAUNCHES}.values())


@pytest.mark.parametrize("group", ["rendering_network", "envmap_material_network"])
def test_training_step_gradients_match_jax(step_pair, models, group):
    _, _, jgrads, _, _ = step_pair
    _assert_group_grads(jgrads, models[2], group)


def test_training_step_leaves_the_geometry_without_gradient(step_pair, models):
    model = models[2]
    for n, p in model.implicit_network.named_parameters():
        assert p.grad is None or not p.grad.any(), n


def test_training_step_secondary_hits(step_pair):
    """The secondary-hit pool, per strategy, for the distillation: the JAX
    pipeline's, the hits traced from the points of the rays that missed
    included."""
    jld, jout, _, _, tout = step_pair
    jm = np.asarray(jout["secondary_mask"])
    tm = tout["secondary_mask"].numpy()
    assert tm.shape == jm.shape and tm.any()
    np.testing.assert_array_equal(tm, jm)
    sel = tm[..., 0]
    np.testing.assert_allclose(tout["secondary_points"].numpy()[sel],
                               np.asarray(jout["secondary_points"])[sel], atol=1e-4)
    np.testing.assert_allclose(tout["secondary_dir"].numpy(), np.asarray(jout["secondary_dir"]),
                               atol=1e-4)


@pytest.fixture(scope="module")
def inward_pool(models):
    """One training forward of both packages with the injected directions
    turned into the surface, so that the points of rays that missed send
    secondary rays that hit. The port runs twice: for the whole pool (the
    shaded rays recorded), and asked for the pool as far as the first K hits,
    K one past the first strategy's hits in the JAX pool (so the second
    strategy is needed and the third is not)."""
    jmodel, params, model = models
    batch, _ = _batch()
    key = jax.random.PRNGKey(1)
    steps01 = np.array(jax.random.uniform(jax.random.split(key, 3)[0],
                                          (jmodel.ray_tracer.n_steps,)))
    shaded = {}
    pool = IDRNetwork._secondary_pool

    def recording_pool(self, ret, sel, *args, **kwargs):
        shaded["sel"] = sel.clone()
        return pool(self, ret, sel, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        _patch_samplers(mp, js, jnp, side=-3.0)
        _patch_samplers(mp, ts, torch, side=-3.0)
        jout = jax.jit(lambda p: jmodel.forward(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, key, training=True,
            freeze_geo=True))(params)
        jout = {k: np.asarray(jout[k]) for k in ("secondary_points", "secondary_mask",
                                                  "secondary_dir")}
        k_max = int(jout["secondary_mask"][0].sum()) + 1

        def port(limit):
            return model.forward_with_uv(
                {k: torch.from_numpy(v) for k, v in batch.items()},
                torch.Generator().manual_seed(0), training=True, freeze_geo=True,
                steps01=torch.from_numpy(steps01), secondary_limit=limit)

        mp.setattr(IDRNetwork, "_secondary_pool", recording_pool)
        full = port(_whole_pool(batch))
        limited = port(k_max)
    ray_shaded = np.zeros(full["secondary_mask"].shape[1], bool)
    ray_shaded[shaded["sel"].numpy()] = True
    return jout, full, ray_shaded, k_max, limited


def test_secondary_pool_of_missed_rays_matches_jax(inward_pool):
    """Where the points of rays that missed send secondary rays that hit,
    the port's pool holds those hits, as the JAX pipeline's does."""
    jout, tout, shaded, _, _ = inward_pool
    jm = jout["secondary_mask"]
    tm = tout["secondary_mask"].numpy()
    assert jm[:, ~shaded].any() and jm[:, shaded].any()
    np.testing.assert_array_equal(tm, jm)
    sel = tm[..., 0]
    np.testing.assert_allclose(tout["secondary_points"].numpy()[sel],
                               jout["secondary_points"][sel], atol=1e-4)
    np.testing.assert_allclose(tout["secondary_dir"].numpy(), jout["secondary_dir"], atol=1e-4)


def test_distilled_batch_matches_jax(inward_pool):
    """The batch the secondary step distils -- points, directions and its
    count K -- is the JAX trainer's selection from the JAX pool (the first K
    hits in [strategy, ray] order, the padding dropped), from a forward that
    traced only the strategies those hits need."""
    jout, _, _, k, tout = inward_pool
    jm = jout["secondary_mask"]
    assert jm[1].any() and tout["secondary_mask"].shape[0] == 2 < jm.shape[0]
    mask = jm.reshape(-1)
    order = np.argsort(~mask, kind="stable")[:k]  # the JAX trainer's selection
    order = order[mask[order]]
    picked = secondary_batch(tout, k, R)
    assert picked is not None
    batch, K, n_hit = picked
    assert K == order.shape[0] == k and n_hit >= k
    for key, name in (("points", "secondary_points"), ("ray_dirs", "secondary_dir")):
        ref = jout[name].reshape(-1, 3)[order]
        assert batch[key].shape == (K, R, 3)
        np.testing.assert_allclose(batch[key].numpy(), np.broadcast_to(ref[:, None], (K, R, 3)),
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the masked Adam update
# ---------------------------------------------------------------------------

def test_masked_adam_matches_optax(models):
    """Two updates (the second past the lr milestone) of both Adam groups
    with the geometry and the light frozen, against optax."""
    jmodel, params, _ = models
    model = params_from_jax(IDRNetwork.from_conf(parse_string(MODEL_CONF).get_config("model")),
                            flatten_tree(params))
    flags = dict(freeze_geometry=True, freeze_light=True)
    names = trainable_names(model, **flags)
    trained = set(names["idr"]) | set(names["sg"])
    assert "envmap_material_network.lgtSGs" not in trained
    assert not [n for n in trained if n.startswith("implicit_network.")]
    sched = multistep_lr(5e-3, [1], 0.5)
    pdict = dict(model.named_parameters())
    groups = {g: AdamGroup([pdict[n] for n in names[g]], sched) for g in ("idr", "sg")}

    def label(path_names):
        return "train" if path_names in trained else "zero"

    labels = jax.tree_util.tree_map_with_path(
        lambda kp, _: label(jck._path_str(kp).replace("/", ".")), params)
    tx = optax.multi_transform(
        {"train": optax.adam(optax.piecewise_constant_schedule(5e-3, {1: 0.5})),
         "zero": optax.set_to_zero()}, labels)
    jp, state = params, tx.init(params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rs = np.random.RandomState(9)
    for it in range(2):
        flat = {k: rs.randn(*np.shape(v)).astype(np.float32)
                for k, v in flatten_tree(params).items()}
        jg = jck.unflatten_like(params, flat)
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(flat[n.replace(".", "/")].copy())
        for g in groups.values():
            g.step()
    jflat = flatten_tree(jp)
    for n, p in model.named_parameters():
        ref = jflat[n.replace(".", "/")]
        if n in trained:
            np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-6, err_msg=n)
            assert not torch.equal(p.detach(), before[n]), n
        else:
            assert torch.equal(p.detach(), before[n]), n
            np.testing.assert_array_equal(p.detach().numpy(), ref, err_msg=n)


# ---------------------------------------------------------------------------
# secondary self-distillation
# ---------------------------------------------------------------------------

def test_distillation_loss_and_gradients_match_jax(models):
    jmodel, params, model = models
    rs = np.random.RandomState(4)
    K, Rd = 24, 2
    pts = rs.randn(K, 3)
    pts = (0.6 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)
    dirs = rs.randn(K, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = {"points": np.ascontiguousarray(np.broadcast_to(pts[:, None], (K, Rd, 3))),
             "ray_dirs": np.ascontiguousarray(np.broadcast_to(dirs[:, None], (K, Rd, 3)))}
    valid = np.ones(K, np.float32)  # the port distils no padding
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)
        fn = jax.jit(spmd.make_point_grad_fn(jmodel, make_mesh(1), freeze_geo=True)())
        jld, jgrads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(valid), jax.random.PRNGKey(0))
        model.zero_grad(set_to_none=True)
        loss = distillation_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 torch.Generator().manual_seed(0))
        loss.backward()
    assert float(jld["loss"]) > 0
    assert _rel(loss.detach(), jld["loss"]) <= LOSS_REL
    for group in ("rendering_network", "envmap_material_network"):
        _assert_group_grads(jgrads, model, group)


# ---------------------------------------------------------------------------
# exp_runner.main on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory, models):
    """Two iterations (batches of 2 and 1 of the 3 views) from a geometry
    checkpoint in the JAX layout, then the exit at max_niter."""
    jmodel, params, _ = models
    d = tmp_path_factory.mktemp("port_train")
    conf_path = d / "train.conf"
    conf_path.write_text(TRAIN_CONF)
    scene = write_sphere_scene(str(d / "scene"), n_views=3, res=16)
    geo = d / "geometry" / "checkpoints"
    jck.save_collection(str(geo), jck.MODEL, "latest", params, {"epoch": 0})
    runner = exp_runner.main([
        "--conf", str(conf_path), "--data_split_dir", scene, "--freeze_geometry",
        "--geometry", str(geo), "--exps_folder_name", str(d / "exps"), "--batch_size", "2",
        "--max_niter", "1", "--roughness_warmup", "1", "--secondary_train_interval", "1",
        "--secondary_batch_size", "32", "--memory_capacity_level", "8", "--device", "cpu"])
    return runner, params, d


def test_exp_runner_trains_and_checkpoints(trained):
    runner, params, _ = trained
    assert [s["iter"] for s in runner.step_stats] == [0, 1]
    assert [s["rays"] for s in runner.step_stats] == [2 * 64 * 2, 64 * 2]
    assert all(np.isfinite(s["loss"]) and 0 < s["secondary_points"] <= 32
               for s in runner.step_stats)
    assert {g.count for g in runner.optimizers.values()} == {4}  # 2 steps + 2 secondary steps
    plots = os.listdir(runner.plots_dir)
    assert {"train_0.png", "train_0_sg_rgb.exr", "train_0_envmap.exr"} <= set(plots)

    # the JAX package reads the checkpoint: geometry unchanged, the rest trained
    jparams, extra = jck.load_collection(runner.checkpoints_path, jck.MODEL, "latest", params)
    assert int(extra["epoch"]) == 1
    before, after = flatten_tree(params), flatten_tree(jparams)
    port = ckpt.params_to_jax(runner.model)
    for k in before:
        np.testing.assert_array_equal(after[k], port[k], err_msg=k)
        if k.startswith("implicit_network/") or k.endswith("specular_reflectance"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for net in ("rendering_network", "envmap_material_network"):
        assert any(not np.array_equal(after[k], before[k]) for k in before
                   if k.startswith(net + "/")), net
    _, sched = jck.load_collection(runner.checkpoints_path, jck.IDR_SCHED, "latest")
    assert int(sched["cur_iter"]) == 2


def test_exp_runner_resumes_from_its_checkpoint(trained, tmp_path):
    runner, _, d = trained
    resumed = exp_runner.main([
        "--conf", str(d / "train.conf"), "--data_split_dir", str(d / "scene"),
        "--freeze_geometry", "--exps_folder_name", str(d / "exps"), "--is_continue",
        "--timestamp", runner.timestamp, "--max_niter", "0", "--device", "cpu"])
    assert resumed.step_stats == [] and resumed.cur_iter == 2
    for (n, p), q in zip(runner.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p.detach(), q.detach()), n
    for g in ("idr", "sg"):
        assert resumed.optimizers[g].count == runner.optimizers[g].count


def test_render_cli_reads_a_port_trained_checkpoint(trained, tmp_path):
    runner, _, d = trained
    out = render.main(["--conf", str(d / "train.conf"), "--data_split_dir", str(d / "scene"),
                       "--old_expdir", runner.expdir, "--timestamp", runner.timestamp,
                       "--num_rays", "1", "--max_views", "1", "--out_dir", str(tmp_path),
                       "--memory_capacity_level", "8", "--device", "cpu"])
    assert out.stats[0]["hit_fraction"] > 0
    np.testing.assert_array_equal(
        out.model.envmap_material_network.lgtSGs.detach().numpy(),
        runner.model.envmap_material_network.lgtSGs.detach().numpy())


def test_exp_runner_trains_unfrozen_geometry(trained, tmp_path):
    """Without --freeze_geometry every network trains, the implicit net through
    the surface points, the eikonal and mask terms and the distillation's
    features, here under train.remat and model.remat_strategies."""
    _, params, d = trained
    conf = tmp_path / "unfrozen.conf"
    conf.write_text(TRAIN_CONF.replace("plot_freq = 1\n", "plot_freq = 100\n    remat = True\n")
                    .replace("use_fused_trace = True", "use_fused_trace = True\n"
                             "    remat_strategies = True"))
    live = exp_runner.main([
        "--conf", str(conf), "--data_split_dir", str(d / "scene"), "--exps_folder_name",
        str(tmp_path / "exps"), "--geometry",
        str(d / "geometry" / "checkpoints"),
        "--batch_size", "3", "--max_niter", "0", "--secondary_train_interval", "1",
        "--secondary_batch_size", "32", "--device", "cpu"])
    assert live.remat and live.model.remat_strategies and not live.freeze_geo
    assert len(live.step_stats) == 1 and np.isfinite(live.step_stats[0]["loss"])
    assert 0 < live.step_stats[0]["secondary_points"] <= 32
    before, after = flatten_tree(params), ckpt.params_to_jax(live.model)
    for net in ("implicit_network", "rendering_network", "envmap_material_network"):
        assert any(not np.array_equal(after[k], before[k]) for k in before
                   if k.startswith(net + "/")), net


@pytest.mark.parametrize("flag,error,match", [
    # camera training is ported; with the view-diff loss it is refused, as in JAX
    pytest.param(["--freeze_geometry", "--train_cameras"], ValueError, "mutually exclusive",
                 id="flag1-train_cameras"),
])
def test_exp_runner_refuses_what_is_not_ported(trained, flag, error, match):
    _, _, d = trained
    conf = d / "view_diff.conf"
    conf.write_text(TRAIN_CONF.replace("    loss_type = L1",
                                       "    loss_type = L1\n    view_diff_weight = 0.1"))
    with pytest.raises(error, match=match):
        exp_runner.main(["--conf", str(conf), "--data_split_dir", str(d / "scene"),
                         "--exps_folder_name", str(d / "refused"), "--device", "cpu", *flag])


def test_profile_script_profiles_three_steps(tmp_path):
    """scripts/profile_train.py on a small conf: K3 switched on by the script,
    steps 1-3 under the profiler, its summary written."""
    conf = tmp_path / "small.conf"
    conf.write_text(TRAIN_CONF.replace("plot_freq = 1\n", "plot_freq = 1000\n")
                    .replace("val_freq = -1", "val_freq = 1000")
                    .replace("\n    use_fused_trace = True", ""))
    ft.reset_launch_counts()
    summary = profile_train.main(["--conf", str(conf), "--out", str(tmp_path / "prof"),
                                  "--device", "cpu"])
    assert summary["use_fused_trace"] and len(summary["s_per_step"]) == 3
    assert summary["rays_per_step"] == 64 * 2
    assert (tmp_path / "prof" / "summary.txt").read_text().startswith("3 steps:")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert all(n == 0 for n in ft.LAUNCHES.values())  # the CPU runs the plain versions
