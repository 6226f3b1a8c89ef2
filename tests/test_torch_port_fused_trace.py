"""K3, the whole-trace kernel: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and the JAX dense tracer, and the
port's RayTracer with and without the K3 hook, on a small geometric-init
SDF net with the same weights and rays.

Gates, those of tests/test_fused_trace.py: distances within 1e-5, unfinished
masks equal, min/max distances exact, and the same executed-evaluation count
as the Pallas kernel at the same tile size. The dense tracer sums the MLP in
another order than the fused chain (unpadded weights, one skip matmul); a
ray whose step lands within rounding of the stop threshold can then differ
by a few 1e-5, so the seeded rays keep clear of that boundary, as
tests/test_torch_port_tracer.py's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.models.implicit import ImplicitNetwork as JImplicit
from nefii_tpu.ops.pallas.fused_trace import build_fused_sphere_trace as jbuild
from nefii_tpu.ops.ray_tracing import RayTracer as JRayTracer
from nefii_tpu.utils.camera import get_sphere_intersection
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.ops.kernels import fused_trace as ft
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.utils.checkpoints import params_from_jax

ATOL = 1e-5
IMPLICIT = dict(feature_vector_size=8, d_in=3, d_out=1, dims=(32,) * 4, geometric_init=True,
                bias=0.6, skip_in=(2,), weight_norm=True, multires=2)
TRACER = dict(sdf_threshold=5e-5, line_search_step=0.5, line_step_iters=3,
              sphere_tracing_iters=10)


@pytest.fixture(scope="module")
def nets():
    jnet = JImplicit(**IMPLICIT)
    params = jnet.init_params(jax.random.PRNGKey(0))
    return jnet, params, params_from_jax(ImplicitNetwork(**IMPLICIT), flatten_tree(params))


def _rays(n=200, seed=1):
    rs = np.random.RandomState(seed)
    cam_loc = np.array([[0.0, 0.0, 2.5]], np.float32)
    targets = (rs.randn(1, n, 3) * 0.6).astype(np.float32)
    dirs = targets - cam_loc[:, None, :]
    return cam_loc, (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def _flat(cam_loc, dirs, r=1.0):
    N = dirs.shape[1]
    si, mi = get_sphere_intersection(jnp.asarray(cam_loc), jnp.asarray(dirs), r=r)
    cam = np.broadcast_to(cam_loc[:, None, :], dirs.shape).reshape(N, 3).copy()
    return (cam, dirs.reshape(N, 3), np.asarray(mi).reshape(N),
            np.asarray(si[..., 0]).reshape(N), np.asarray(si[..., 1]).reshape(N))


def _plain(net, args, tile):
    fw = fm.prepare_weights(net)
    with torch.no_grad():
        return ft.fused_sphere_trace_plain(*(torch.from_numpy(np.array(a)) for a in args), fw,
                                           RayTracer(**TRACER), tile=tile)


@pytest.mark.parametrize("tile", [16, 64])
def test_plain_matches_the_pallas_kernel(nets, tile):
    jnet, params, net = nets
    args = _flat(*_rays())
    assert 0 < args[2].sum() < args[2].size  # hits and misses of the bounding sphere
    ref = jbuild(jnet, params, JRayTracer(**TRACER), tile=tile, interpret=True)(
        *(jnp.asarray(a) for a in args))
    acc_s, acc_e, unf, n_evals = _plain(net, args, tile)
    np.testing.assert_allclose(acc_s.numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(acc_e.numpy(), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(unf.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(acc_s.numpy() < acc_e.numpy(),
                                  np.asarray(ref[0]) < np.asarray(ref[1]))
    assert n_evals == int(ref[5]) > 0


def test_plain_matches_the_dense_tracer_and_k3_closure(nets):
    """The JAX dense trace, and build_fused_sphere_trace's six outputs."""
    jnet, params, net = nets
    args = _flat(*_rays())
    jt = JRayTracer(**TRACER)
    ref = jt._sphere_trace(lambda x: jnet.sdf(params, x), *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        out = ft.build_fused_sphere_trace(net, RayTracer(**TRACER))(
            *(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    # counted per tile of RAYS_PER_BLOCK rays, the padded rays of the last one included
    assert out[5] > 0 and out[5] % (2 * ft.RAYS_PER_BLOCK) == 0
    assert ft.LAUNCHES["fused_sphere_trace"] == 0  # CPU tensors: the plain version ran


def test_results_do_not_depend_on_the_tile(nets):
    _, _, net = nets
    args = _flat(*_rays(n=150, seed=3))
    a = _plain(net, args, 16)
    b = _plain(net, args, 150)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    # every executed evaluation of a tile counts its 2 * tile points
    assert a[3] % 32 == 0 and b[3] % 300 == 0 and a[3] > 0


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_ray_tracer_with_and_without_the_k3_hook(nets, training):
    """RayTracer(sphere_trace_fn=K3) against RayTracer alone and against the
    JAX tracer with its own K3 hook, the min-SDF vector injected (steps01 is
    what the JAX tracer draws from its key)."""
    jnet, params, net = nets
    cam_loc, dirs = _rays(n=120, seed=4)
    n = dirs.shape[1]
    obj = np.random.RandomState(5).rand(n) < 0.7  # object-mask conflicts on purpose
    jt = JRayTracer(**TRACER, n_steps=32)
    key = jax.random.PRNGKey(7)
    steps01 = torch.from_numpy(np.asarray(jax.random.uniform(key, (jt.n_steps,))))
    jsdf = lambda x: jnet.sdf(params, x)
    jref = jt(jsdf, jnp.asarray(cam_loc), jnp.asarray(obj), jnp.asarray(dirs), key=key,
              training=training,
              sphere_trace_fn=jbuild(jnet, params, jt, tile=64, interpret=True))
    tracer = RayTracer(**TRACER, n_steps=32)
    inputs = (torch.from_numpy(cam_loc), torch.from_numpy(obj), torch.from_numpy(dirs))
    with torch.no_grad():
        plain = tracer(net.sdf, *inputs, training=training, steps01=steps01)
        hooked = tracer(net.sdf, *inputs, training=training, steps01=steps01,
                        sphere_trace_fn=ft.build_fused_sphere_trace(net, tracer))
    j_mask = np.asarray(jref.object_mask)
    assert 0 < j_mask.sum() < j_mask.size
    for res in (plain, hooked):
        np.testing.assert_array_equal(res.object_mask.numpy(), j_mask)
        np.testing.assert_allclose(res.dists.numpy(), np.asarray(jref.dists), atol=ATOL)
        np.testing.assert_allclose(res.points.numpy(), np.asarray(jref.points), atol=ATOL)
    assert hooked.n_evals > 0 and plain.n_evals > 0
