"""Camera-pose training, the view-diff loss and fast_multi_ray: the port
against the JAX package on the same numpy-seeded inputs and JAX-initialised
weights (params_from_jax).

Cases and gates:
  * the pose math (`quat_to_rot`, `rot_to_quat`, `pose_to_matrix`,
    `points2uv`, `get_camera_params` on [B,7] poses): values at atol 1e-6,
    the gradient of `get_camera_params` with respect to the pose at a
    relative L2 of 1e-5; `get_pose_init` equal;
  * `bilinear_fetch` at atol 1e-6; `find_paired_pixel` on the small net's
    sphere: `pixel_visible` and the fetched mask equal, uv and rgb at atol
    1e-5;
  * the view-diff term at rel 1e-5, with the full and the specular rgb;
  * a `--train_cameras` step, frozen and live (eikonal points injected):
    every loss term at rel 1e-5, every parameter group's gradient and the
    pose's at a relative L2 of 2e-3; then the camera Adam update: the
    batch's pose row at atol 1e-6, the other rows and their moments bit
    for bit;
  * the camera Adam alone, 5 steps with some rows' gradients zero, against
    optax.adam and the JAX trainer's `_mask_adam_rows`: atol 1e-7;
  * a frozen view-diff step: the paired batch of `_append_paired_view`
    (masks and `pixel_visible` equal, uv and rgb at atol 1e-5), the loss
    terms at rel 1e-5 and the gradients at a relative L2 of 2e-3;
  * `forward_with_uv` with `fast_multi_ray`, eval (the render slice's PSNR
    gates) and a frozen training step (the training gates, the
    secondary-hit pool equal);
  * `exp_runner --train_cameras --device cpu`, then `--is_continue`: the JAX
    package's `load_collection` reads the port's CamParameters, and the run
    resumes with the same poses and camera Adam state; a view-diff run;
    `--train_cameras` with the view-diff loss raises ValueError.

The Monte-Carlo directions are injected as in test_torch_port_training.py.
The port runs the plain versions of its kernels (CPU tensors)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nefii_tpu.config import parse_string
from nefii_tpu.datasets.scene_dataset import SceneDataset as JSceneDataset
from nefii_tpu.models import pixel_pair_generator as jpair
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.models.loss import IDRLoss as JLoss
from nefii_tpu.ops import sampling as js
from nefii_tpu.training.trainer import IDRTrainRunner as JRunner
from nefii_tpu.training.trainer import _mask_adam_rows
from nefii_tpu.utils import camera as jcam
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.config import parse_string as port_parse_string
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models import pixel_pair_generator as tpair
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.training import exp_runner
from nefii_tpu_torch.training.trainer import IDRTrainRunner, RowAdam
from nefii_tpu_torch.utils import camera as tcam
from nefii_tpu_torch.utils.checkpoints import params_from_jax

from test_torch_port_physg import _assert_term
from test_torch_port_slice import ESTIMATOR_DB, FORWARD_DB, _psnr
from test_torch_port_training import (
    GRAD_REL_L2, LOSS_CONF, LOSS_REL, MODEL_CONF, TERMS, TRAIN_CONF, _assert_group_grads,
    _batch, _patch_samplers, _rel, _rel_l2, _whole_pool,
)

GROUPS = ("rendering_network", "envmap_material_network")
LIVE_GROUPS = ("implicit_network",) + GROUPS
N_IMG, ROW = 3, 1   # the pose table's rows, and the row of _batch()'s image
CAM_LR = 1e-3
VIEW_DIFF = dict(LOSS_CONF, view_diff_weight=0.1)


def _models(text):
    conf = parse_string(text).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, params_from_jax(IDRNetwork.from_conf(conf), flatten_tree(params))


@pytest.fixture(scope="module")
def models():
    return _models(MODEL_CONF)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 4-view 16x16 sphere: image i's view-diff partner (i + 3) % 4 is
    another view."""
    return write_sphere_scene(str(tmp_path_factory.mktemp("cam_scene")), n_views=4, res=16)


def _quat(angle, axis, scale=1.0):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return scale * np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _pose_vecs():
    """[N_IMG,7] quaternion + translation rows; row ROW is _batch()'s camera
    (at z = -2, looking along +z) turned by 2 degrees, its quaternion scaled
    off unit length (pose_to_matrix normalises it)."""
    rs = np.random.RandomState(2)
    pv = np.concatenate([rs.randn(N_IMG, 4), rs.randn(N_IMG, 3)], 1)
    pv[ROW] = np.concatenate([_quat(np.radians(2.0), [0.3, 1.0, 0.2], 1.02), [0.01, -0.02, -2.0]])
    return pv.astype(np.float32)


# ---------------------------------------------------------------------------
# the pose math
# ---------------------------------------------------------------------------

def _pose_inputs():
    rs = np.random.RandomState(0)
    q = rs.randn(4, 4).astype(np.float32)
    pose7 = np.concatenate([q, rs.randn(4, 3)], 1).astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 0, 1] = 60.0, 55.0, 32.0, 30.0, 0.5
    uv = rs.uniform(0, 64, (4, 9, 2)).astype(np.float32)
    # points 1.5-2.5 in front of each camera, in its view
    R = np.asarray(jcam.quat_to_rot(jnp.asarray(q)), np.float64)
    local = np.concatenate([rs.uniform(-0.4, 0.4, (4, 9, 2)), rs.uniform(1.5, 2.5, (4, 9, 1))], -1)
    pts = (np.einsum("bij,bsj->bsi", R, local) + pose7[:, None, 4:]).astype(np.float32)
    return q, pose7, K, uv, pts


POSE_FNS = {
    "quat_to_rot": lambda m, q, p7, K, uv, pts: m.quat_to_rot(q),
    "rot_to_quat": lambda m, q, p7, K, uv, pts: m.rot_to_quat(
        jcam.quat_to_rot(jnp.asarray(q)) if m is jcam else tcam.quat_to_rot(q)),
    "pose_to_matrix": lambda m, q, p7, K, uv, pts: m.pose_to_matrix(p7),
    "points2uv": lambda m, q, p7, K, uv, pts: m.points2uv(pts, p7, K),
    "get_camera_params": lambda m, q, p7, K, uv, pts: m.get_camera_params(uv, p7, K),
}


@pytest.mark.parametrize("name", sorted(POSE_FNS))
def test_pose_math_matches_jax(name):
    """atol 1e-6; pixel coordinates (points2uv, up to ~64) at 1e-6 of their
    largest value, as float32's spacing there is 7.6e-6."""
    args = _pose_inputs()
    ref = POSE_FNS[name](jcam, *(jnp.asarray(a) for a in args))
    got = POSE_FNS[name](tcam, *(torch.from_numpy(a) for a in args))
    ref, got = (ref, got) if isinstance(got, tuple) else ((ref,), (got,))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        atol = 1e-6 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, atol=atol, err_msg=name)


def test_get_camera_params_pose_gradient_matches_jax():
    _, pose7, K, uv, _ = _pose_inputs()
    rs = np.random.RandomState(1)
    wd, wc = rs.randn(4, 9, 3).astype(np.float32), rs.randn(4, 3).astype(np.float32)

    def jfn(p):
        d, c = jcam.get_camera_params(jnp.asarray(uv), p, jnp.asarray(K))
        return (d * wd).sum() + (c * wc).sum()

    ref = np.asarray(jax.grad(jfn)(jnp.asarray(pose7)))
    p = torch.from_numpy(pose7).requires_grad_(True)
    d, c = tcam.get_camera_params(torch.from_numpy(uv), p, torch.from_numpy(K))
    ((d * torch.from_numpy(wd)).sum() + (c * torch.from_numpy(wc)).sum()).backward()
    assert np.abs(ref).max() > 0
    assert _rel_l2(p.grad.numpy(), ref) <= 1e-5


def test_get_pose_init_matches_jax(scene):
    got = SceneDataset(1.0, scene, True).get_pose_init()
    ref = JSceneDataset(1.0, scene, True).get_pose_init()
    assert got.shape == (4, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_scene_dataset_leaves_out_the_pose_when_training_cameras(scene):
    _, sample, _ = SceneDataset(1.0, scene, True)[0]
    assert "pose" not in sample
    _, sample, _ = SceneDataset(1.0, scene, False)[0]
    assert sample["pose"].shape == (4, 4)


# ---------------------------------------------------------------------------
# pixel pairing
# ---------------------------------------------------------------------------

def test_bilinear_fetch_matches_jax():
    rs = np.random.RandomState(3)
    H, W = 6, 8
    img = rs.rand(2, H * W, 3).astype(np.float32)
    uv = np.concatenate([rs.uniform(-1.5, W + 0.5, (2, 20, 1)),
                         rs.uniform(-1.5, H + 0.5, (2, 20, 1))], -1).astype(np.float32)
    uv[0, :3] = [[0.0, 0.0], [W - 1, H - 1], [3.0, 2.5]]  # on the grid and the border
    ref = np.asarray(jpair.bilinear_fetch(jnp.asarray(uv), jnp.asarray(img), (H, W)))
    got = tpair.bilinear_fetch(torch.from_numpy(uv), torch.from_numpy(img), (H, W))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def _jit_pairing(real=jpair.find_paired_pixel):
    """The JAX find_paired_pixel, jitted (same signature; eager tracing on the
    CPU takes several times as long)."""
    cache = {}

    def fn(model, params, query, K, pose, rgb, mask, img_res, key):
        if model not in cache:
            cache[model] = jax.jit(lambda p, q, *a: real(model, p, q, *a[:4], img_res, a[4]))
        return cache[model](params, query, K, pose, rgb, mask, key)
    return fn


def _query(ds, idx, uv_idx):
    _, sample, _ = ds.collate([ds[idx]])
    return {"intrinsics": sample["intrinsics"], "pose": sample["pose"],
            "uv": sample["uv"][:, uv_idx], "object_mask": sample["object_mask"][:, uv_idx]}


def test_find_paired_pixel_matches_jax(models, scene):
    """The pixels of view 0's object mask paired into view 1. The small net's
    sphere (radius ~0.6) holds the scene's (0.5), so their traces meet it
    head on and converge; a ray that grazes it stops where its sdf falls
    below the threshold, which an ulp of the sdf can move by a step
    (5.6e-5 along one such ray of this view)."""
    jmodel, params, model = models
    ds = SceneDataset(1.0, scene, False)
    query = _query(ds, 0, np.nonzero(ds.object_masks[0])[0])
    src = [np.stack([a[1]]) for a in (ds.intrinsics_all, ds.pose_all, ds.rgb_images,
                                      ds.object_masks)]
    ref = _jit_pairing()(jmodel, params, {k: jnp.asarray(v) for k, v in query.items()},
                         *(jnp.asarray(a) for a in src), tuple(ds.img_res),
                         jax.random.PRNGKey(0))
    got = tpair.PixelPairGenerator(ds, model).find_paired_pixel(
        {k: torch.from_numpy(v) for k, v in query.items()}, [1])
    vis = np.asarray(ref["pixel_visible"])
    assert 0 < vis.sum() < vis.size
    np.testing.assert_array_equal(got["pixel_visible"].numpy(), vis)
    np.testing.assert_array_equal(got["object_mask"].numpy(), np.asarray(ref["object_mask"]))
    for k in ("uv", "gt_rgb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the view-diff term
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full_rgb", [True, False], ids=["sg_rgb", "sg_specular_rgb"])
def test_view_diff_loss_term_matches_jax(full_rgb):
    rs = np.random.RandomState(6)
    B, S = 2, 12
    n = 2 * B * S
    out = {"idr_rgb_values": rs.rand(n, 3), "sg_rgb_values": rs.rand(n, 3),
           "sg_specular_rgb_values": rs.rand(n, 3), "normal_values": rs.randn(n, 3),
           "sdf_output": rs.randn(n, 1) * 0.05, "network_object_mask": rs.rand(n) < 0.8,
           "object_mask": rs.rand(n) < 0.8, "grad_theta": None,
           "sg_roughness_values": rs.rand(n, 1)}
    out = {k: (v.astype(np.float32) if v is not None and v.dtype != bool else v)
           for k, v in out.items()}
    gt = {"rgb": rs.rand(2 * B, S, 3).astype(np.float32), "pixel_visible": rs.rand(B, S) < 0.7}
    conf = dict(VIEW_DIFF, view_diff_full_rgb=full_rgb)
    ref = JLoss(**conf)({k: (jnp.asarray(v) if v is not None else None) for k, v in out.items()},
                        {k: jnp.asarray(v) for k, v in gt.items()})
    got = IDRLoss(**conf)({k: (torch.from_numpy(v) if v is not None else None)
                           for k, v in out.items()},
                          {k: torch.from_numpy(v) for k, v in gt.items()})
    assert float(ref["view_diff_loss"]) > 0
    for term in ("view_diff_loss", "loss"):
        assert _rel(got[term], ref[term]) <= LOSS_REL, term


# ---------------------------------------------------------------------------
# one --train_cameras step, frozen and live
# ---------------------------------------------------------------------------

def _steps01(jmodel, key):
    return np.array(jax.random.uniform(jax.random.split(key, 3)[0], (jmodel.ray_tracer.n_steps,)))


def _camera_step(models, live):
    """Forward, IDRLoss and backward of both packages with the pose of
    _batch()'s image gathered from the pose table (row ROW)."""
    jmodel, params, model = models
    batch, gt = _batch()
    del batch["pose"]
    if live:
        batch["eik_override"] = np.random.RandomState(11).uniform(
            -1.0, 1.0, (batch["uv"][..., 0].size // 2, 3)).astype(np.float32)
    pv = _pose_vecs()
    key = jax.random.PRNGKey(1)
    jloss, tloss = JLoss(**LOSS_CONF), IDRLoss(**LOSS_CONF)
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)

        def loss_fn(p, pose_vecs):
            b = {k: jnp.asarray(v) for k, v in batch.items()}
            b["pose"] = pose_vecs[jnp.array([ROW])]
            out = jmodel.forward(p, b, key, training=True, freeze_geo=not live)
            ld = jloss(out, {k: jnp.asarray(v) for k, v in gt.items()})
            return ld["loss"], (ld, out)

        (_, (jld, jout)), (jgrads, jpose) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(pv))
        model.zero_grad(set_to_none=True)
        pose_vecs = torch.from_numpy(pv.copy()).requires_grad_(True)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        b["pose"] = pose_vecs[torch.tensor([ROW])]
        tout = model.forward_with_uv(b, torch.Generator().manual_seed(0), training=True,
                                     freeze_geo=not live,
                                     steps01=torch.from_numpy(_steps01(jmodel, key)))
        tld = tloss(tout, {k: torch.from_numpy(v) for k, v in gt.items()})
        tld["loss"].backward()
    return dict(step=(jld, jout, jgrads, tld, tout), jpose=np.asarray(jpose), pv=pv,
                pose_vecs=pose_vecs)


@pytest.fixture(scope="module", params=[False, True], ids=["frozen", "live"])
def camera_step(request, models):
    return request.param, _camera_step(models, request.param)


@pytest.mark.parametrize("term", TERMS)
def test_camera_step_loss_terms_match_jax(camera_step, term):
    _, res = camera_step
    assert float(res["step"][0]["sg_rgb_loss"]) > 0
    _assert_term(res["step"], term)


def test_camera_step_gradients_match_jax(camera_step, models):
    live, res = camera_step
    for group in (LIVE_GROUPS if live else GROUPS):
        _assert_group_grads(res["step"][2], models[2], group)
    if not live:
        for n, p in models[2].implicit_network.named_parameters():
            assert p.grad is None or not p.grad.any(), n


def test_camera_step_pose_gradient_matches_jax(camera_step):
    """Only the batch's row of the pose table gets a gradient, JAX's within
    a relative L2 of 2e-3. With frozen geometry the pose reaches the loss
    through the view directions alone, which the translation does not move:
    its gradient is 0 up to rounding; with live geometry the surface points
    of IDR eq. 3 move with the camera."""
    live, res = camera_step
    got, ref = res["pose_vecs"].grad.numpy(), res["jpose"]
    others = [i for i in range(N_IMG) if i != ROW]
    assert not got[others].any() and not ref[others].any()
    assert np.abs(ref[ROW, :4]).min() > 0
    assert np.abs(ref[ROW, 4:]).max() > (1e-3 if live else 0) * np.abs(ref[ROW, :4]).max() \
        or not live
    err = _rel_l2(got[ROW], ref[ROW])
    assert err <= GRAD_REL_L2, f"pose gradient: relative L2 {err:.3e}"


def _cam_state(pv):
    """A camera Adam state three steps in: seeded moments, the second positive."""
    rs = np.random.RandomState(8)
    return 3, (rs.randn(*pv.shape) * 1e-3).astype(np.float32), \
        (rs.rand(*pv.shape) * 1e-5).astype(np.float32)


def _optax_cam_update(pv, grad, count, mu, nu):
    """The JAX trainer's camera update: optax.adam, the untouched rows kept."""
    tx = optax.adam(CAM_LR)
    state = tx.init(jnp.asarray(pv))
    state = (state[0]._replace(count=jnp.int32(count), mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
             ) + tuple(state[1:])
    g = jnp.asarray(grad)
    updates, new_state = tx.update(g, state, jnp.asarray(pv))
    touched = jnp.abs(g).sum(-1, keepdims=True) > 0
    new_pv = jnp.where(touched, optax.apply_updates(jnp.asarray(pv), updates), jnp.asarray(pv))
    new_state = _mask_adam_rows(new_state, state, touched)
    return np.asarray(new_pv), np.asarray(new_state[0].mu), np.asarray(new_state[0].nu)


def _row_adam(pose_vecs, count, mu, nu):
    opt = RowAdam([pose_vecs], lambda c: CAM_LR)
    opt.load_state_dict({"count": count, "mu": torch.from_numpy(mu.reshape(-1)),
                         "nu": torch.from_numpy(nu.reshape(-1))})
    return opt


def test_camera_step_update_matches_jax(camera_step):
    """The camera Adam update after the step: the batch's row as JAX moves it,
    the other rows and their moments as they were, bit for bit."""
    _, res = camera_step
    pv = res["pv"]
    count, mu, nu = _cam_state(pv)
    pose_vecs = res["pose_vecs"].detach().clone()
    pose_vecs.grad = res["pose_vecs"].grad.clone()
    opt = _row_adam(pose_vecs, count, mu, nu)
    opt.step()
    ref_pv, ref_mu, ref_nu = _optax_cam_update(pv, res["jpose"], count, mu, nu)
    got = pose_vecs.detach().numpy()
    others = [i for i in range(N_IMG) if i != ROW]
    assert opt.count == count + 1
    assert not np.array_equal(got[ROW], pv[ROW])
    np.testing.assert_allclose(got, ref_pv, atol=1e-6)
    np.testing.assert_array_equal(got[others], pv[others])
    for name, moment, ref in (("mu", opt.mu, ref_mu), ("nu", opt.nu, ref_nu)):
        moment = moment.reshape(pv.shape).numpy()
        np.testing.assert_array_equal(moment[others], (mu if name == "mu" else nu)[others])
        np.testing.assert_array_equal(moment[others], ref[others])


def test_camera_adam_matches_optax_with_masked_rows():
    """Five steps of fixed gradients, some rows zero on each step."""
    rs = np.random.RandomState(0)
    n = 6
    pv = rs.randn(n, 7).astype(np.float32)
    pose_vecs = torch.from_numpy(pv.copy())
    opt = RowAdam([pose_vecs], lambda c: CAM_LR)
    count, mu, nu = 0, np.zeros_like(pv), np.zeros_like(pv)
    ref = pv
    for rows in ([0, 2], [0, 3, 4], [2], [0, 2, 3], [1, 3]):
        g = np.zeros_like(pv)
        g[rows] = rs.randn(len(rows), 7).astype(np.float32)
        ref, mu, nu = _optax_cam_update(ref, g, count, mu, nu)
        count += 1
        pose_vecs.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(pose_vecs.numpy(), ref, atol=1e-7)
        np.testing.assert_allclose(opt.mu.reshape(n, 7).numpy(), mu, atol=1e-7)
        np.testing.assert_allclose(opt.nu.reshape(n, 7).numpy(), nu, atol=1e-7)
    np.testing.assert_array_equal(pose_vecs.numpy()[5], pv[5])  # never touched


# ---------------------------------------------------------------------------
# one frozen view-diff step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def view_diff_step(models, tmp_path_factory):
    """Image 1 (64 px x 2 rays) of a 4-view scene of the small net's own
    sphere (radius 0.6, so that the masks agree with its silhouette), paired
    with image 0 (69 degrees round the ring) by both trainers'
    _append_paired_view, then one frozen step of each package."""
    jmodel, params, model = models
    ds = SceneDataset(1.0, write_sphere_scene(str(tmp_path_factory.mktemp("vd_scene")),
                                              n_views=4, res=16, radius=0.6), False)
    rng = np.random.default_rng(5)
    ds.change_sampling_idx(64, rng)
    ds.change_sampling_rays(2, rng)
    indices, inp, gt = ds.collate([ds[1]])
    key = jax.random.PRNGKey(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpair, "find_paired_pixel", _jit_pairing())
        jbatch, jgt = JRunner._append_paired_view(
            types.SimpleNamespace(train_dataset=ds, train_cameras=False, model=jmodel,
                                  params=params),
            {k: jnp.asarray(v) for k, v in inp.items()}, {"rgb": jnp.asarray(gt["rgb"])},
            indices, jax.random.PRNGKey(2))
    tbatch, tgt = IDRTrainRunner._append_paired_view(
        types.SimpleNamespace(train_dataset=ds, model=model),
        {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()},
        {"rgb": torch.from_numpy(gt["rgb"])}, indices)
    jloss, tloss = JLoss(**VIEW_DIFF), IDRLoss(**VIEW_DIFF)
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)

        def loss_fn(p):
            out = jmodel.forward(p, jbatch, key, training=True, freeze_geo=True)
            ld = jloss(out, jgt)
            return ld["loss"], (ld, out)

        (_, (jld, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        model.zero_grad(set_to_none=True)
        tout = model.forward_with_uv(tbatch, torch.Generator().manual_seed(0), training=True,
                                     freeze_geo=True,
                                     steps01=torch.from_numpy(_steps01(jmodel, key)))
        tld = tloss(tout, tgt)
        tld["loss"].backward()
    return (jbatch, jgt, tbatch, tgt), (jld, jout, jgrads, tld, tout)


def test_view_diff_paired_batch_matches_jax(view_diff_step):
    (jbatch, jgt, tbatch, tgt), _ = view_diff_step
    assert tbatch["uv"].shape == (2, 64, 2, 2) and tgt["rgb"].shape == (2, 64, 3)
    vis = np.asarray(jgt["pixel_visible"])
    assert vis.shape == (1, 64) and 0 < vis.sum() < vis.size
    np.testing.assert_array_equal(tgt["pixel_visible"].numpy(), vis)
    for k in ("object_mask", "intrinsics", "pose"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    np.testing.assert_allclose(tbatch["uv"].numpy(), np.asarray(jbatch["uv"]), atol=1e-5)
    np.testing.assert_allclose(tgt["rgb"].numpy(), np.asarray(jgt["rgb"]), atol=1e-5)


@pytest.mark.parametrize("term", TERMS + ("view_diff_loss",))
def test_view_diff_step_loss_terms_match_jax(view_diff_step, term):
    _, (jld, _, _, tld, _) = view_diff_step
    assert float(jld["view_diff_loss"]) > 0
    ref = float(jld[term])
    assert _rel(tld[term].detach(), ref) <= LOSS_REL or ref == float(tld[term]) == 0.0, term


@pytest.mark.parametrize("group", GROUPS)
def test_view_diff_step_gradients_match_jax(view_diff_step, models, group):
    _assert_group_grads(view_diff_step[1][2], models[2], group)


# ---------------------------------------------------------------------------
# fast_multi_ray
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fast_models():
    return _models(MODEL_CONF.replace("fast_multi_ray = False", "fast_multi_ray = True"))


@pytest.fixture(scope="module")
def fast_eval(fast_models):
    jmodel, params, model = fast_models
    batch, _ = _batch()
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        _patch_samplers(mp, ts, torch)
        jout = jax.jit(lambda p: jmodel.forward(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1),
            training=False))(params)
        tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(1))
    return {k: np.asarray(v) for k, v in jout.items() if v is not None}, \
        {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in tout.items()}


@pytest.mark.parametrize("key,gate", [
    ("sg_rgb_values", ESTIMATOR_DB), ("sg_diffuse_rgb_values", ESTIMATOR_DB),
    ("sg_specular_rgb_values", ESTIMATOR_DB), ("sg_diffuse_albedo_values", FORWARD_DB),
    ("sg_roughness_values", FORWARD_DB), ("sg_specular_reflection_values", FORWARD_DB),
    ("normal_values", FORWARD_DB), ("idr_rgb_values", FORWARD_DB), ("points", FORWARD_DB),
])
def test_fast_multi_ray_render_matches_jax(fast_eval, fast_models, key, gate):
    """One pixel-mean ray a pixel: S rays traced, not S*R."""
    jout, tout = fast_eval
    jm = jout["network_object_mask"]
    assert jm.shape == (16,) and 0 < jm.sum() < jm.size and fast_models[2].fast_multi_ray
    np.testing.assert_array_equal(tout["network_object_mask"], jm)
    assert tout[key].shape == jout[key].shape and np.isfinite(tout[key]).all()
    p = _psnr(tout[key], jout[key])
    assert p >= gate, f"{key}: PSNR {p:.1f} dB < {gate} dB"


@pytest.fixture(scope="module")
def fast_step(fast_models):
    jmodel, params, model = fast_models
    batch, gt = _batch()
    key = jax.random.PRNGKey(1)
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
        tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0), training=True,
                                     freeze_geo=True,
                                     steps01=torch.from_numpy(_steps01(jmodel, key)),
                                     secondary_limit=_whole_pool(batch))
        tld = tloss(tout, {k: torch.from_numpy(v) for k, v in gt.items()})
        tld["loss"].backward()
    return jld, jout, jgrads, tld, tout


@pytest.mark.parametrize("term", TERMS)
def test_fast_multi_ray_step_loss_terms_match_jax(fast_step, term):
    _assert_term(fast_step, term)


@pytest.mark.parametrize("group", GROUPS)
def test_fast_multi_ray_step_gradients_match_jax(fast_step, fast_models, group):
    _assert_group_grads(fast_step[2], fast_models[2], group)


def test_fast_multi_ray_step_secondary_pool_matches_jax(fast_step):
    """The pool holds the path tracer's S*R rays, each pixel's point R times."""
    _, jout, _, _, tout = fast_step
    jm = np.asarray(jout["secondary_mask"])
    assert jm.shape[1] == 16 * 2 and jm.any()
    np.testing.assert_array_equal(tout["secondary_mask"].numpy(), jm)
    sel = jm[..., 0]
    np.testing.assert_allclose(tout["secondary_points"].numpy()[sel],
                               np.asarray(jout["secondary_points"])[sel], atol=1e-4)


# ---------------------------------------------------------------------------
# exp_runner
# ---------------------------------------------------------------------------

CAM_TRAIN_CONF = TRAIN_CONF.replace("plot_freq = 1\n", "plot_freq = 100\n    learning_rate_cam = "
                                    f"{CAM_LR}\n")


@pytest.fixture(scope="module")
def cameras_trained(tmp_path_factory, scene):
    """One epoch of frozen --train_cameras steps over the scene's 4 views in
    batches of 3 and 1, from the seeded geometry: every pose row trains."""
    d = tmp_path_factory.mktemp("cam_train")
    conf = d / "train.conf"
    conf.write_text(CAM_TRAIN_CONF)
    runner = exp_runner.main([
        "--conf", str(conf), "--data_split_dir", scene, "--freeze_geometry", "--train_cameras",
        "--exps_folder_name", str(d / "exps"), "--batch_size", "3", "--max_niter", "0",
        "--memory_capacity_level", "8", "--device", "cpu"])
    return runner, d


def test_exp_runner_trains_cameras(cameras_trained, scene):
    runner, _ = cameras_trained
    assert runner.train_cameras and len(runner.step_stats) == 2
    assert all(np.isfinite(s["loss"]) for s in runner.step_stats)
    init = SceneDataset(1.0, scene, True).get_pose_init()
    after = runner.pose_vecs.detach().numpy()
    assert all(not np.array_equal(after[i], init[i]) for i in range(4))
    np.testing.assert_allclose(np.linalg.norm(after[:, :4], axis=1), 1.0, atol=0.05)
    assert runner.cam_optimizer.count == 2
    # the JAX package reads the learned poses
    jposes, extra = jck.load_collection(runner.checkpoints_path, jck.CAM, "latest",
                                        {"pose_vecs": np.zeros((4, 7), np.float32)})
    np.testing.assert_array_equal(np.asarray(jposes["pose_vecs"]), after)
    assert int(extra["epoch"]) == 1


def test_exp_runner_resumes_the_cameras(cameras_trained, scene):
    runner, d = cameras_trained
    resumed = exp_runner.main([
        "--conf", str(d / "train.conf"), "--data_split_dir", scene, "--freeze_geometry",
        "--train_cameras", "--exps_folder_name", str(d / "exps"), "--is_continue",
        "--timestamp", runner.timestamp, "--max_niter", "0", "--device", "cpu"])
    assert resumed.step_stats == [] and resumed.cur_iter == 2
    assert torch.equal(resumed.pose_vecs.detach(), runner.pose_vecs.detach())
    a, b = resumed.cam_optimizer, runner.cam_optimizer
    assert a.count == b.count and torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)


def test_exp_runner_trains_with_the_view_diff_loss(tmp_path, scene):
    conf = tmp_path / "vd.conf"
    conf.write_text(TRAIN_CONF.replace("plot_freq = 1\n", "plot_freq = 100\n")
                    .replace("    loss_type = L1",
                             "    loss_type = L1\n    view_diff_weight = 0.1"))
    runner = exp_runner.main([
        "--conf", str(conf), "--data_split_dir", scene, "--freeze_geometry",
        "--exps_folder_name", str(tmp_path / "exps"), "--batch_size", "4", "--max_niter", "0",
        "--device", "cpu"])
    (s,) = runner.step_stats
    assert runner.loss.view_diff_weight == 0.1
    assert s["rays"] == 2 * 4 * 64 * 2  # the partner rows double the batch
    assert np.isfinite(s["loss"]) and s["view_diff_loss"] > 0 and s["pairing_seconds"] > 0


def test_train_cameras_with_the_view_diff_loss_raises(tmp_path, scene):
    conf = port_parse_string(TRAIN_CONF)
    conf.put("loss.view_diff_weight", 0.1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        IDRTrainRunner(conf=conf, data_split_dir=scene, exps_folder_name=str(tmp_path),
                       train_cameras=True, device="cpu")
