"""Parity of the PyTorch port's networks with the JAX package on the same
weights (JAX init -> flatten_tree -> params_from_jax) and the same inputs.

Tolerances: network outputs within 2e-5 and SDF gradients within 1e-4 — the
fp32 gates of the torch-parity suite; both sides compute in fp32 and differ
only in summation order."""

import jax
import numpy as np
import pytest
import torch

from nefii_tpu.models.implicit import ImplicitNetwork as JImplicit
from nefii_tpu.models.material import EnvmapMaterialNetwork as JMaterial
from nefii_tpu.models.rendering import RenderingNetwork as JRendering
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.models.material import EnvmapMaterialNetwork
from nefii_tpu_torch.models.rendering import RenderingNetwork
from nefii_tpu_torch.utils import checkpoints as ck

NET_TOL = 2e-5
GRAD_TOL = 1e-4

IMPLICIT = dict(feature_vector_size=64, d_in=3, d_out=1, dims=(64,) * 4, geometric_init=True,
                bias=0.6, skip_in=(2,), weight_norm=True, multires=4, use_last_as_f=True)
RENDERING = dict(feature_vector_size=64, mode="idr", d_in=9, d_out=3, dims=(64, 64),
                 weight_norm=True, multires_view=2, multires_xyz=4, normalize_output=False,
                 clip_output=True, clip_method="pow2", weight_init=True)
MATERIAL = dict(multires=4, dims=(64, 64), white_specular=True, white_light=False,
                num_lgt_sgs=8, num_base_materials=1, fix_specular_albedo=True,
                specular_albedo=(0.5, 0.5, 0.5), roughness_mlp=True, specular_mlp=True,
                same_mlp=True, feature_vector_size=64)


def _port(jnet, cls, cfg, seed):
    params = jnet.init_params(jax.random.PRNGKey(seed))
    return params, ck.params_from_jax(cls(**cfg), flatten_tree(params))


def _pts(n, seed=0):
    return (np.random.RandomState(seed).randn(n, 3) * 0.5).astype(np.float32)


@pytest.mark.parametrize("cfg", [
    IMPLICIT,
    dict(IMPLICIT, use_last_as_f=False, multires=0, skip_in=(1,)),
    dict(IMPLICIT, geometric_init=False, weight_norm=False),
], ids=["pe-lastf", "no-pe-feature-head", "default-init-plain"])
def test_implicit_forward_and_gradient(cfg):
    jnet = JImplicit(**cfg)
    params, net = _port(jnet, ImplicitNetwork, cfg, 0)
    pts = _pts(200)
    out_j = np.asarray(jnet(params, pts))
    grad_j = np.asarray(jnet.gradient(params, pts))
    with torch.no_grad():
        out_t = net(torch.from_numpy(pts)).numpy()
    sdf_t, feat_t, grad_t = net.sdf_feature_grad(torch.from_numpy(pts))
    np.testing.assert_allclose(out_t, out_j, atol=NET_TOL)
    np.testing.assert_allclose(sdf_t.numpy(), out_j[:, 0], atol=NET_TOL)
    np.testing.assert_allclose(feat_t.numpy(), out_j[:, 1:], atol=NET_TOL)
    np.testing.assert_allclose(grad_t.numpy(), grad_j, atol=GRAD_TOL)
    np.testing.assert_allclose(net.gradient(torch.from_numpy(pts)).numpy(), grad_j, atol=GRAD_TOL)


def test_rendering_network():
    jnet = JRendering(**RENDERING)
    params, net = _port(jnet, RenderingNetwork, RENDERING, 1)
    rs = np.random.RandomState(1)
    pts, n, v = (rs.randn(3, 150, 3) * 0.5).astype(np.float32)
    feat = rs.randn(150, 64).astype(np.float32)
    ref = np.asarray(jnet(params, pts, n, v, feat))
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in (pts, n, v, feat))).numpy()
    np.testing.assert_allclose(out, ref, atol=NET_TOL)


@pytest.mark.parametrize("cfg", [
    MATERIAL,
    dict(MATERIAL, roughness_mlp=False, specular_mlp=False, fix_specular_albedo=False,
         same_mlp=False, white_specular=False, init_specular_reflectance=0.1),
], ids=["mlp-materials", "global-materials"])
def test_material_network(cfg):
    jnet = JMaterial(**cfg)
    params, net = _port(jnet, EnvmapMaterialNetwork, cfg, 2)
    rs = np.random.RandomState(2)
    pts = (rs.randn(120, 3) * 0.5).astype(np.float32)
    feat = rs.randn(120, 64).astype(np.float32)
    ref = jnet(params, pts, feat)
    with torch.no_grad():
        out = net(torch.from_numpy(pts), torch.from_numpy(feat))
    for k in ("sg_lgtSGs", "sg_specular_reflectance", "sg_roughness", "sg_diffuse_albedo"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), atol=NET_TOL,
                                   err_msg=k)
    assert out["sg_blending_weights"] is None and ref["sg_blending_weights"] is None


def test_material_correct_normal():
    # without a geometry feature: with one, the JAX delta-normal MLP's input
    # width counts the feature but apply_correct_normal feeds it only the
    # encoded point (material.py:249-251), and both packages raise
    cfg = dict(MATERIAL, correct_normal=True, feature_vector_size=0)
    jnet = JMaterial(**cfg)
    params, net = _port(jnet, EnvmapMaterialNetwork, cfg, 4)
    rs = np.random.RandomState(4)
    pts = (rs.randn(100, 3) * 0.5).astype(np.float32)
    n = rs.randn(100, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ref = np.asarray(jnet.apply_correct_normal(params, n, pts))
    with torch.no_grad():
        out = net.apply_correct_normal(torch.from_numpy(n), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out, ref, atol=NET_TOL)


def test_weight_bridge_round_trip(tmp_path):
    """params_to_jax inverts params_from_jax, and the .npz files a JAX
    checkpoint writes load into a port model key for key."""
    from nefii_tpu.utils import checkpoints as jck

    jnet = JImplicit(**IMPLICIT)
    params, net = _port(jnet, ImplicitNetwork, IMPLICIT, 3)
    flat = flatten_tree(params)
    back = ck.params_to_jax(net)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])

    jck.save_collection(str(tmp_path), jck.MODEL, "latest", params, {"epoch": 7})
    loaded, extra = ck.load_collection(str(tmp_path), ck.MODEL, "latest")
    assert int(extra["epoch"]) == 7
    net2 = ck.params_from_jax(ImplicitNetwork(**IMPLICIT), loaded)
    for a, b in zip(net.state_dict().values(), net2.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(KeyError):
        ck.params_from_jax(ImplicitNetwork(**IMPLICIT), {"layers/0/v": flat["layers/0/v"]})


def test_port_init_geometric_sphere():
    """The port's seeded geometric init is roughly a sphere of radius `bias`:
    negative inside, positive outside on average, small on the sphere (at width 64 the
    init is noisy, for the JAX init as well)."""
    net = ImplicitNetwork(**IMPLICIT)
    net.reset_parameters(torch.Generator().manual_seed(0))
    dirs = torch.nn.functional.normalize(torch.randn(256, 3), dim=-1)
    with torch.no_grad():
        on = net.sdf(dirs * 0.6)
        assert net.sdf(torch.zeros(1, 3)).item() < 0.0
        assert net.sdf(dirs * 1.2).mean().item() > 0.2
    assert on.abs().mean().item() < 0.15
