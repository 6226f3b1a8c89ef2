"""The port's RayTracer (eval path) against the JAX RayTracer on a small
geometric-init SDF net with the same weights and rays.

Gates: object masks equal; distances within 1e-4. Both trace the same SDF
in fp32; the port gathers the rays it evaluates where the JAX tracer masks,
which changes no ray's arithmetic, only the evaluation count. The seeded
ray fan keeps every ray clear of the sdf_threshold boundary."""

import jax
import numpy as np
import pytest
import torch

from nefii_tpu.models.implicit import ImplicitNetwork as JImplicit
from nefii_tpu.ops.ray_tracing import RayTracer as JRayTracer
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.utils.checkpoints import params_from_jax

DIST_TOL = 1e-4
IMPLICIT = dict(feature_vector_size=64, d_in=3, d_out=1, dims=(64,) * 4, geometric_init=True,
                bias=0.6, skip_in=(2,), weight_norm=True, multires=4, use_last_as_f=True)
TRACERS = {
    # the small test conf's tracer, and the shipped conf's reduced secondary tracer
    "primary": dict(object_bounding_sphere=1.0, sdf_threshold=5.0e-5, line_search_step=0.5,
                    line_step_iters=1, sphere_tracing_iters=5, n_steps=32, n_rootfind_steps=8),
    "secondary": dict(object_bounding_sphere=1.0, sdf_threshold=5.0e-5, line_search_step=0.5,
                      line_step_iters=0, sphere_tracing_iters=5, n_steps=50,
                      n_rootfind_steps=16),
}


@pytest.fixture(scope="module")
def scene():
    jnet = JImplicit(**IMPLICIT)
    params = jnet.init_params(jax.random.PRNGKey(0))
    net = params_from_jax(ImplicitNetwork(**IMPLICIT), flatten_tree(params))
    rs = np.random.RandomState(4)
    cam = np.array([[0.0, 0.1, -2.0]], np.float32)
    # a fan of directions from the camera: hits, grazing rays, misses of the
    # object and misses of the bounding sphere
    offs = rs.uniform(-0.62, 0.62, (1, 160, 2)).astype(np.float32)
    dirs = np.concatenate([offs, np.ones((1, 160, 1), np.float32)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jnet, params, net, cam, dirs.astype(np.float32)


@pytest.mark.parametrize("which", ["primary", "secondary"])
def test_tracer_matches_jax(scene, which):
    jnet, params, net, cam, dirs = scene
    mask = np.ones((dirs.shape[1],), bool)
    jres = JRayTracer(**TRACERS[which])(lambda x: jnet.sdf(params, x), cam, mask, dirs,
                                        training=False)
    with torch.no_grad():
        tres = RayTracer(**TRACERS[which])(net.sdf, torch.from_numpy(cam),
                                           torch.from_numpy(mask), torch.from_numpy(dirs))
    j_mask = np.asarray(jres.object_mask)
    assert 0 < j_mask.sum() < j_mask.size  # the fan has hits and misses
    np.testing.assert_array_equal(tres.object_mask.numpy(), j_mask)
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), atol=DIST_TOL)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), atol=DIST_TOL)
    # the port evaluates only the rays that need it
    assert 0 < tres.n_evals <= int(jres.n_evals)


def test_tracer_through_fused_sdf_plain_path(scene):
    """The tracer driven by the K1 closure (plain path on CPU tensors) gives
    the same trace as with the network's own sdf."""
    _, _, net, cam, dirs = scene
    mask = torch.ones(dirs.shape[1], dtype=torch.bool)
    tracer = RayTracer(**TRACERS["primary"])
    with torch.no_grad():
        a = tracer(net.sdf, torch.from_numpy(cam), mask, torch.from_numpy(dirs))
        b = tracer(fm.build_fused_sdf(net), torch.from_numpy(cam), mask, torch.from_numpy(dirs))
    assert torch.equal(a.object_mask, b.object_mask)
    np.testing.assert_allclose(a.dists.numpy(), b.dists.numpy(), atol=DIST_TOL)


def test_tracer_handles_no_rays_and_all_misses(scene):
    _, _, net, _, _ = scene
    tracer = RayTracer(**TRACERS["primary"])
    with torch.no_grad():
        empty = tracer(net.sdf, torch.zeros(0, 3), torch.zeros(0, dtype=torch.bool),
                       torch.zeros(0, 1, 3))
        far = tracer(net.sdf, torch.tensor([[0.0, 0.0, -3.0]]), torch.ones(4, dtype=torch.bool),
                     torch.tensor([[[1.0, 0.0, 0.0]] * 4]))
    assert empty.points.shape == (0, 3) and empty.n_evals == 0
    assert not bool(far.object_mask.any()) and far.n_evals == 0


def test_from_conf_drops_static_budgets():
    """A conf written for the JAX tracer, with its static compaction budgets
    (confs/conf.conf sets two), builds the port's dense tracers; an option the
    port does not implement raises instead of being ignored."""
    import dataclasses

    from nefii_tpu.config import parse_string
    from nefii_tpu_torch.models.idr import IDRNetwork
    from test_idr_forward import SMALL_CONF

    conf = SMALL_CONF.replace(
        "n_rootfind_steps = 8\n",
        "n_rootfind_steps = 8\n sampler_budget = 16\n minsdf_budget = 16\n rootfind_budget = 4\n"
        " compact_after = 2\n compact_budget = 8\n",
    ).replace("    ray_tracer\n",
              "    secondary_ray_tracer { n_steps = 12\n sampler_budget = 8 }\n    ray_tracer\n")
    model = IDRNetwork.from_conf(parse_string(conf).get_config("model"))
    assert model.ray_tracer == RayTracer(**TRACERS["primary"])
    assert model.secondary_ray_tracer == dataclasses.replace(model.ray_tracer, n_steps=12)
    with pytest.raises(TypeError, match="measure_demand"):
        IDRNetwork.from_conf(parse_string(conf.replace(
            "n_rootfind_steps = 8\n", "n_rootfind_steps = 8\n measure_demand = true\n",
        )).get_config("model"))


def test_camera_rays_sphere_intersection_and_rot_to_quat():
    from nefii_tpu.utils import camera as jcam
    from nefii_tpu_torch.utils import camera as tcam

    rs = np.random.RandomState(5)
    K = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 1] = 50.0, 55.0, 0.3
    K[:, 0, 2], K[:, 1, 2] = 32.0, 30.0
    ang = rs.uniform(0, np.pi, 2)
    pose = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    for b, a in enumerate(ang):
        c, s = np.cos(a), np.sin(a)
        pose[b, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        pose[b, :3, 3] = [-2.0 * s, 0.2, -2.0 * c]
    uv = rs.uniform(0, 64, (2, 50, 2)).astype(np.float32)
    d_j, c_j = jcam.get_camera_params(uv, pose, K)
    d_t, c_t = tcam.get_camera_params(*(torch.from_numpy(a) for a in (uv, pose, K)))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    si_j, m_j = jcam.get_sphere_intersection(np.asarray(c_j), np.asarray(d_j), r=1.0)
    si_t, m_t = tcam.get_sphere_intersection(c_t, d_t, r=1.0)
    assert 0 < int(m_t.sum()) < m_t.numel()
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(si_t.numpy(), np.asarray(si_j), atol=1e-5)
    np.testing.assert_allclose(tcam.rot_to_quat(pose[:, :3, :3]),
                               np.asarray(jcam.rot_to_quat(pose[:, :3, :3])), atol=1e-6)
