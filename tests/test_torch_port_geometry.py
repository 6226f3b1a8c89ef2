"""Step 1 (the SDF fit to a mesh) and the mesh tools of the port against the
JAX package, on the CPU at small width. Inputs come from numpy seeds; JAX's
initial parameters are carried across with params_from_jax.

Cases and gates:
  * the native runtime: the port's two .cpp files byte-identical to the JAX
    package's; signed distance, surface samples, total area and marching
    tetrahedra equal on an icosphere; four builds at once all load;
  * mesh IO: OBJ (quads, negative indices) and PLY (ascii with a quad,
    binary) give the JAX package's arrays exactly;
  * SDFSampler.sample(seed): JAX's points and SDF values bit for bit, with
    and without scale_to_unit;
  * plots: depth_map within 1e-6; get_surface_trace and
    get_surface_high_res_mesh of one analytic SDF give JAX's vertices within
    1e-6 and JAX's faces exactly;
  * Step 1: three GeometryTrainRunner steps on fixed batches, the lr
    milestone crossed on the third: loss at rel 1e-5 each step, parameters
    after Adam at atol 1e-6;
  * checkpoints both ways: a port Step-1 checkpoint is read by JAX's
    restore_subtree and by the port's Step-2 --geometry; a JAX Step-1
    checkpoint is read by the port;
  * the CLI: geometry_runner.main(... --device cpu) writes the run directory,
    a vis PNG and checkpoints, and --is_continue restores them;
  * the render's --export_mesh_resolution: JAX's write_mesh of the port's
    SDF gives the port's mesh exactly; JAX's write_mesh of its own net on
    the same weights gives counts within 0.1% and a surface within 5e-3 (a
    tenth of the fine grid's spacing; welding is discontinuous, see the
    test); the Step-2 vis surface dump likewise, with its vertices within
    1e-5 of JAX's;
  * the model repair: confs/sdf.conf builds; rendering it raises.
"""

import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu import native as jnative
from nefii_tpu.config import parse_string as jparse
from nefii_tpu.datasets.sdf_dataset import SDFSampler as JSDFSampler
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.scripts.render import RenderRunner as JRenderRunner
from nefii_tpu.training.geometry_trainer import GeometryTrainRunner as JGeometryTrainRunner
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils import mesh_io as jmesh_io
from nefii_tpu.utils import plots as jplots
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch import native
from nefii_tpu_torch.config import get_class, parse_string
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.datasets.sdf_dataset import SDFDataset, SDFSampler
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.scripts import render
from nefii_tpu_torch.training import geometry_runner
from nefii_tpu_torch.training.geometry_trainer import GeometryTrainRunner
from nefii_tpu_torch.training.trainer import IDRTrainRunner
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils import mesh_io, plots
from nefii_tpu_torch.utils.checkpoints import params_from_jax
from nefii_tpu_torch.utils.png import read_png

from test_geometry_train import GEOM_CONF
from test_idr_forward import SMALL_CONF
from test_native import _icosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL = 1e-5
PARAM_ATOL = 1e-6
VERT_ATOL = 1e-6
EXPORT_ATOL = 1e-5
# Step 1 on SMALL_CONF's model (the implicit net of the port's Step-2 tests,
# so Step 2 can take the checkpoint with --geometry); lr milestone at 2
TRAIN = """train {
    expname = port_geo
    dataset_class = datasets.scene_dataset.SceneDataset
    model_class = model.implicit_differentiable_renderer.IDRNetwork
    loss_class = model.loss.IDRLoss
    plot_freq = 2
    val_freq = -1
    ckpt_freq = 2
    num_pixels = 16
    num_rays = 1
    idr_learning_rate = 1e-3
    idr_sched_milestones = [2]
    idr_sched_factor = 0.5
    sg_learning_rate = 5e-4
}
plot {
    surface_resolution = 24
}
loss {
    idr_rgb_weight = 1.0
    sg_rgb_weight = 1.0
    eikonal_weight = 0.1
    mask_weight = 100.0
    alpha = 50.0
    r_patch = 1
    loss_type = L1
}
"""
CONF = TRAIN + SMALL_CONF
STEP_CONF = GEOM_CONF.replace("idr_sched_milestones = [400]", "idr_sched_milestones = [2]")


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    v, f = _icosphere(2, r=0.5)
    path = str(tmp_path_factory.mktemp("mesh") / "sphere.ply")
    mesh_io.save_mesh(path, v, f)
    return path


@pytest.fixture(scope="module")
def jax_model():
    jmodel = JIDR.from_conf(jparse(SMALL_CONF).get_config("model"))
    return jmodel, jmodel.init_params(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the native runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mesh_sdf.cpp", "marching.cpp"])
def test_native_sources_are_the_jax_packages(name):
    with open(os.path.join(ROOT, "nefii_tpu_torch", "native", name), "rb") as a, \
            open(os.path.join(ROOT, "nefii_tpu", "native", name), "rb") as b:
        assert a.read() == b.read()


def test_native_runtime_matches_jax():
    v, f = _icosphere(3, r=0.7)
    port, ref = native.MeshSDF(v, f), jnative.MeshSDF(v, f)
    pts = np.random.RandomState(0).uniform(-1, 1, (4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(port.signed_distance(pts), ref.signed_distance(pts))
    for a, b in zip(port.sample_surface(3000, seed=11), ref.sample_surface(3000, seed=11)):
        np.testing.assert_array_equal(a, b)
    assert port.total_area == ref.total_area
    xs = np.linspace(-1, 1, 24, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    grid = np.sqrt(X * X + 2 * Y * Y + Z * Z) - 0.6
    tris = native.marching_tetrahedra(grid)
    assert len(tris) > 100
    np.testing.assert_array_equal(tris, jnative.marching_tetrahedra(grid))
    # the library is built into build/, never next to the sources
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


def test_native_concurrent_builds_all_load(tmp_path, monkeypatch):
    """Four builds of the same library at once, as xdist workers may start
    them: each writes its own temporary file and renames it into place, so
    every load finds a whole library."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    so = native.library_path()
    errors = []

    def build_and_load():
        try:
            native._build(so)
            import ctypes

            ctypes.CDLL(so).mesh_total_area
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build_and_load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert os.listdir(tmp_path) == [os.path.basename(so)]


# ---------------------------------------------------------------------------
# mesh IO and the sampler
# ---------------------------------------------------------------------------

def _write_ascii_ply(path, v, f):
    with open(path, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\nproperty float x\n"
                 "property float y\nproperty float z\nproperty float nx\n"
                 f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
        for p in v:
            fh.write(f"{p[0]} {p[1]} {p[2]} 0.5\n")
        for face in f:
            fh.write(f"{len(face)} " + " ".join(map(str, face)) + "\n")


def _write_obj_with_quad(path, v):
    with open(path, "w") as fh:
        for p in v:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        fh.write("f 1/1 2/2 3/3 4/4\nf -1 -2 -3\n")


@pytest.mark.parametrize("kind", ["obj", "ply_binary", "obj_quad", "ply_ascii_quad"])
def test_mesh_io_matches_jax(tmp_path, kind):
    v, f = _icosphere(1, r=0.4)
    path = str(tmp_path / ("m.obj" if kind.startswith("obj") else "m.ply"))
    if kind in ("obj", "ply_binary"):
        mesh_io.save_mesh(path, v, f)
        with open(path, "rb") as a:
            port_bytes = a.read()
        jmesh_io.save_mesh(path, v, f)
        with open(path, "rb") as b:
            assert port_bytes == b.read()
    elif kind == "obj_quad":
        _write_obj_with_quad(path, v)
    else:
        _write_ascii_ply(path, v, [list(f[0]) + [int(f[1][2])], *f[1:].tolist()])
    pv, pf = mesh_io.load_mesh(path)
    jv, jf = jmesh_io.load_mesh(path)
    assert pv.dtype == jv.dtype and pf.dtype == jf.dtype
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    assert len(pf) > 1


@pytest.mark.parametrize("scale_to_unit", [True, False])
def test_sdf_sampler_is_bit_exact(mesh_file, scale_to_unit):
    port = SDFSampler(mesh_file, number_of_points=5000, scale_to_unit=scale_to_unit, seed=3)
    ref = JSDFSampler(mesh_file, number_of_points=5000, scale_to_unit=scale_to_unit, seed=3)
    for seed in (0, 17, None):
        (p_pts, p_sdf), (j_pts, j_sdf) = port.sample(seed), ref.sample(seed)
        assert p_pts.dtype == np.float32 and p_sdf.shape == (5000, 1)
        np.testing.assert_array_equal(p_pts, j_pts)
        np.testing.assert_array_equal(p_sdf, j_sdf)
    assert get_class("datasets.sdf_dataset.SDFDataset") is SDFDataset


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------

def test_depth_map_matches_jax():
    rs = np.random.RandomState(5)
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.3, -0.2, -2.5]
    pts = rs.uniform(-1, 1, (12 * 10, 3))
    mask = rs.rand(12 * 10) > 0.3
    np.testing.assert_allclose(plots.depth_map(pts, pose, mask, (12, 10)),
                               jplots.depth_map(pts, pose, mask, (12, 10)), atol=1e-6)


def _two_spheres(x: np.ndarray) -> np.ndarray:
    """An analytic numpy SDF: the union of two spheres (two components of
    different area)."""
    x = np.asarray(x, np.float64)
    return np.minimum(np.linalg.norm(x - [0.25, 0.05, 0.0], axis=1) - 0.45,
                      np.linalg.norm(x - [-0.45, 0.0, 0.1], axis=1) - 0.2).astype(np.float32)


def test_surface_extraction_matches_jax():
    """The same numpy SDF behind a torch closure and a jax closure."""
    port_sdf = lambda x: torch.from_numpy(_two_spheres(x.cpu().numpy()))  # noqa: E731
    jax_sdf = lambda x: jnp.asarray(_two_spheres(np.asarray(x)))  # noqa: E731
    pv, pf = plots.get_surface_trace(port_sdf, 32, device="cpu")
    jv, jf = jplots.get_surface_trace(jax_sdf, 32)
    assert len(pf) > 500
    np.testing.assert_allclose(pv, jv, atol=VERT_ATOL)
    np.testing.assert_array_equal(pf, jf)
    pv, pf = plots.get_surface_high_res_mesh(port_sdf, 40, coarse_resolution=48, device="cpu")
    jv, jf = jplots.get_surface_high_res_mesh(jax_sdf, 40, coarse_resolution=48)
    assert len(pf) > 500
    # every vertex within a fine cell of the union's surface
    assert np.abs(_two_spheres(pv)).max() < 0.03
    np.testing.assert_allclose(pv, jv, atol=VERT_ATOL)
    np.testing.assert_array_equal(pf, jf)


# ---------------------------------------------------------------------------
# Step 1
# ---------------------------------------------------------------------------

def _runners(mesh_file, tmp_path, conf=CONF, batch=512):
    jr = JGeometryTrainRunner(conf=jparse(conf), mesh_path=mesh_file, batch_points=batch,
                              max_niters=10, exps_folder_name=str(tmp_path / "jax"),
                              n_devices=1, seed=7)
    pr = GeometryTrainRunner(conf=parse_string(conf), mesh_path=mesh_file, batch_points=batch,
                             max_niters=10, exps_folder_name=str(tmp_path / "port"), seed=7,
                             device="cpu")
    params_from_jax(pr.model, flatten_tree(jr.params))
    return jr, pr


def test_geometry_steps_match_jax(mesh_file, tmp_path):
    """Three steps on the sampler's batches 0-2 of the JAX package's own
    Step-1 test conf, the third after the lr milestone (moved to 2). Both
    packages run Adam in the same float32 arithmetic, so the parameters
    differ by the gradients' summation order only; a parameter whose
    gradient is near Adam's eps (1e-8) would amplify that, which this conf's
    gradients stay clear of."""
    jr, pr = _runners(mesh_file, tmp_path, STEP_CONF)
    for i in range(3):
        pts, sdf = jr.dataset[i]
        jr.params, jr.opt_state, jloss = jr._step(jr.params, jr.opt_state, jnp.asarray(pts),
                                                  jnp.asarray(sdf))
        loss = pr.train_step(torch.as_tensor(pts), torch.as_tensor(sdf))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_REL, err_msg=f"step {i}")
    assert pr.optimizer.count == 3
    jflat = flatten_tree(jr.params)
    port = ckpt.params_to_jax(pr.model)
    assert set(jflat) == set(port)
    for k in jflat:
        np.testing.assert_allclose(port[k], jflat[k], atol=PARAM_ATOL, err_msg=k)
    # the implicit net trained; the material net is in no optimizer
    start = flatten_tree(JGeometryTrainRunner(
        conf=jparse(STEP_CONF), mesh_path=mesh_file, batch_points=8, max_niters=1,
        exps_folder_name=str(tmp_path / "start"), n_devices=1, seed=7).params)
    assert all(not np.array_equal(port[k], start[k]) for k in port
               if k.startswith("implicit_network/") and k.endswith("/v"))
    assert all(np.array_equal(port[k], start[k]) for k in port
               if k.startswith("envmap_material_network/"))


def test_checkpoints_cross_between_packages(mesh_file, tmp_path):
    jr, pr = _runners(mesh_file, tmp_path)
    pts, sdf = pr.dataset[0]
    pr.train_step(torch.as_tensor(pts), torch.as_tensor(sdf))
    pr.save_checkpoints(1)
    port = ckpt.params_to_jax(pr.model)

    # the JAX package reads the port's Step-1 checkpoint
    restored = jck.restore_subtree(jr.params, pr.checkpoints_path, "latest", "implicit_network")
    for k, v in flatten_tree(restored["implicit_network"]).items():
        np.testing.assert_array_equal(v, port["implicit_network/" + k], err_msg=k)

    # the port's Step 2 takes it with --geometry
    scene = write_sphere_scene(str(tmp_path / "scene"), 2, 8)
    step2 = IDRTrainRunner(conf=parse_string(CONF), data_split_dir=scene, freeze_geometry=True,
                           geometry=pr.checkpoints_path, exps_folder_name=str(tmp_path / "s2"),
                           device="cpu")
    got = ckpt.params_to_jax(step2.model)
    for k in port:
        if k.startswith("implicit_network/"):
            np.testing.assert_array_equal(got[k], port[k], err_msg=k)

    # the port reads a JAX Step-1 checkpoint
    jr.save_checkpoints(0)
    fresh = IDRNetwork.from_conf(parse_string(CONF).get_config("model"), seed=5)
    flat, extra = ckpt.load_collection(jr.checkpoints_path, ckpt.MODEL, "latest")
    params_from_jax(fresh, flat)
    assert int(extra["epoch"]) == 0
    for k, v in flatten_tree(jr.params).items():
        np.testing.assert_array_equal(ckpt.params_to_jax(fresh)[k], v, err_msg=k)


def test_geometry_runner_cli(mesh_file, tmp_path):
    """Step 1 through the CLI on the CPU: 4 steps of 256 points with a vis
    of one view at iteration 2; then --is_continue restores its parameters
    and restarts the iteration count at 0."""
    conf = tmp_path / "geo.conf"
    conf.write_text(CONF)
    scene = write_sphere_scene(str(tmp_path / "scene"), 2, 16)
    common = ["--conf", str(conf), "--mesh_path", mesh_file, "--batch_size", "256",
              "--exps_folder_name", str(tmp_path / "exps"), "--expname", "s1",
              "--not_scale_to_unit", "--device", "cpu"]
    runner = geometry_runner.main(common + ["--max_niter", "4", "--data_split_dir", scene,
                                            "--num_workers", "2", "--sample_num", "8"])
    assert [s["iter"] for s in runner.step_stats] == [0, 1, 2, 3]
    assert all(np.isfinite(s["loss"]) and s["sample_seconds"] > 0 for s in runner.step_stats)
    for f in ("runconf.conf", "runcmd.txt", "plots/geo_2.png",
              "checkpoints/ModelParameters/0.npz", "checkpoints/ModelParameters/2.npz",
              "checkpoints/ModelParameters/4.npz", "checkpoints/ModelParameters/latest.npz"):
        assert os.path.getsize(os.path.join(runner.rundir, f)) > 0, f
    img = read_png(os.path.join(runner.plots_dir, "geo_2.png"))
    assert img.shape == (16, 32, 3)
    flat, extra = ckpt.load_collection(runner.checkpoints_path, ckpt.MODEL, "latest")
    assert int(extra["epoch"]) == 4

    resumed = geometry_runner.main(common + ["--max_niter", "0", "--is_continue",
                                             "--timestamp", "ignored"])
    assert resumed.step_stats == []
    again, extra = ckpt.load_collection(resumed.checkpoints_path, ckpt.MODEL, "latest")
    assert int(extra["epoch"]) == 0
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k], err_msg=k)


def test_geometry_sampler_failure_ends_the_run(mesh_file, tmp_path):
    """An exception in the sampler thread reaches the main loop, which raises
    it after the batches before it, and the thread ends."""
    pr = GeometryTrainRunner(conf=parse_string(CONF), mesh_path=mesh_file, batch_points=64,
                             max_niters=6, exps_folder_name=str(tmp_path), device="cpu")
    real = pr.dataset.sdf_sampler.sample

    def sample(seed=None):
        if seed == 2:
            raise ValueError("bad batch")
        return real(seed)

    pr.dataset.sdf_sampler.sample = sample
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="SDF sampler failed") as info:
        pr.run(6)
    assert isinstance(info.value.__cause__, ValueError)
    assert [s["iter"] for s in pr.step_stats] == [0, 1]
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# mesh export of the render and of the Step-2 vis
# ---------------------------------------------------------------------------

def _jax_sdf_of(net):
    """A jax closure over the port's implicit net: JAX's mesh code on the
    port's SDF values."""
    def sdf(params, x):
        with torch.no_grad():
            return jnp.asarray(net.sdf(torch.from_numpy(np.array(x))).numpy())
    return types.SimpleNamespace(sdf=sdf)


def _close_counts(a, b):
    """Vertex or face counts within 0.1%: welding merges vertices closer than
    1e-4 of a cell, a rounding that a 1e-7 difference in the SDF can flip."""
    return abs(len(a) - len(b)) <= max(2, 1e-3 * len(b))


def test_render_export_mesh_matches_jax_write_mesh(jax_model, tmp_path):
    """--export_mesh_resolution 32 on JAX's initial weights. JAX's write_mesh
    on the port's SDF gives the port's mesh exactly. JAX's write_mesh on its
    own net gives a mesh whose counts are within 0.1% and whose surface lies
    within a tenth of the fine grid's spacing (0.05) of the port's: both
    packages' float32 SDFs differ by ~1e-7, which can flip a weld of the
    coarse mesh and so move the area sampler's points, the PCA frame and the
    fine grid."""
    jmodel, params = jax_model
    conf_path = tmp_path / "render.conf"
    conf_path.write_text(CONF)
    exp = tmp_path / "exps" / "port_geo"
    jck.save_collection(str(exp / "2026_01_01" / "checkpoints"), jck.MODEL, "latest", params,
                        {"epoch": 1})
    scene = SceneDataset.write_camera_only_split(str(tmp_path / "scene"), 1, 4, focal=5.0)
    out_dir = tmp_path / "renders"
    runner = render.main(["--conf", str(conf_path), "--data_split_dir", scene, "--old_expdir",
                          str(exp), "--num_rays", "1", "--device", "cpu", "--out_dir",
                          str(out_dir), "--export_mesh_resolution", "32", "--max_views", "1"])
    pv, pf = mesh_io.load_mesh(str(out_dir / "surface_high_res.ply"))
    assert len(pf) > 500

    meshes = {}
    for name, model in (("port_sdf", types.SimpleNamespace(
            implicit_network=_jax_sdf_of(runner.model.implicit_network),
            ray_tracer=jmodel.ray_tracer)), ("jax", jmodel)):
        d = tmp_path / name
        d.mkdir()
        JRenderRunner.write_mesh(types.SimpleNamespace(
            params=params, model=model, export_mesh_resolution=32, is_main=True, out_dir=str(d)))
        meshes[name] = jmesh_io.load_mesh(str(d / "surface_high_res.ply"))
    xv, xf = meshes["port_sdf"]
    np.testing.assert_array_equal(pv, xv)
    np.testing.assert_array_equal(pf, xf)
    jv, jf = meshes["jax"]
    assert _close_counts(pv, jv) and _close_counts(pf, jf), (pv.shape, jv.shape, pf.shape,
                                                              jf.shape)
    assert np.abs(native.MeshSDF(jv, jf).signed_distance(pv)).max() < 5e-3
    assert np.abs(native.MeshSDF(pv, pf).signed_distance(jv)).max() < 5e-3


def test_step2_vis_writes_the_surface(jax_model, tmp_path):
    """IDRTrainRunner.vis on the train split writes surface_<it>.obj at
    plot.surface_resolution: exactly JAX's export_surface of the port's SDF,
    and within 1e-5 (counts within 0.1%, as above) of JAX's export_surface
    of its own net on the same weights."""
    from scipy.spatial import cKDTree

    jmodel, params = jax_model
    scene = write_sphere_scene(str(tmp_path / "scene"), 2, 8)
    runner = IDRTrainRunner(conf=parse_string(CONF), data_split_dir=scene, freeze_geometry=True,
                            exps_folder_name=str(tmp_path / "exps"), device="cpu")
    params_from_jax(runner.model, flatten_tree(params))
    runner.vis("train", 3)
    assert os.path.getsize(os.path.join(runner.plots_dir, "train_3.png")) > 0
    pv, pf = mesh_io.load_mesh(os.path.join(runner.plots_dir, "surface_3.obj"))
    assert len(pf) > 100
    port_sdf = _jax_sdf_of(runner.model.implicit_network).sdf
    for sdf, name in ((lambda x: port_sdf(None, x), "port_sdf.obj"),
                      (lambda x: jmodel.implicit_network.sdf(params["implicit_network"], x),
                       "jax.obj")):
        jplots.export_surface(sdf, str(tmp_path / name), resolution=24)
    xv, xf = jmesh_io.load_mesh(str(tmp_path / "port_sdf.obj"))
    np.testing.assert_array_equal(pv, xv)
    np.testing.assert_array_equal(pf, xf)
    jv, jf = jmesh_io.load_mesh(str(tmp_path / "jax.obj"))
    assert _close_counts(pv, jv) and _close_counts(pf, jf)
    gap = max(cKDTree(jv).query(pv)[0].max(), cKDTree(pv).query(jv)[0].max())
    assert gap < EXPORT_ATOL


# ---------------------------------------------------------------------------
# the model repair
# ---------------------------------------------------------------------------

def test_sdf_conf_builds_and_sg_rendering_raises(tmp_path):
    """confs/sdf.conf names no render_type ("sg"): its model builds for Step 1,
    and at full width it renders with the closed-form SG renderer as the JAX
    package's does on the same weights (hit mask equal; points and normals
    within 1e-5; the shaded colours within the fp32 noise of the SG formula,
    rtol 1e-4, see test_torch_port_physg.py); Step 2 trains it. The name
    stays from when the port raised there; a render type that neither
    package has raises."""
    with open(os.path.join(ROOT, "confs", "sdf.conf")) as f:
        text = f.read()
    conf = parse_string(text).get_config("model")
    jmodel = JIDR.from_conf(jparse(text).get_config("model"))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    model = params_from_jax(IDRNetwork.from_conf(conf, seed=0), flatten_tree(params))
    assert model.render_type == "sg"
    assert [l.d_out for l in model.implicit_network.layers] == [512, 512, 512, 473, 512, 512,
                                                                  512, 512, 1]
    rs = np.random.RandomState(2)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2] = K[1, 2] = 32.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -2.0]
    batch = {"uv": rs.uniform(4, 60, (1, 24, 2)).astype(np.float32), "pose": pose[None],
             "intrinsics": K[None], "object_mask": np.ones((1, 24), bool)}
    jout = jmodel.forward(params, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tout = model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()}, gen)
    hit = np.asarray(jout["network_object_mask"])
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(tout["network_object_mask"].numpy(), hit)
    for k in ("points", "normal_values", "sg_diffuse_albedo_values", "sg_roughness_values",
              "sg_specular_reflection_values", "idr_rgb_values"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)
    for k in ("sg_rgb_values", "sg_diffuse_rgb_values", "sg_specular_rgb_values"):
        assert np.abs(np.asarray(jout[k])[hit]).max() > 0, k
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    model.render_type = "no_such_type"
    with pytest.raises(ValueError, match="render_type 'no_such_type'"):
        model.forward_with_uv({k: torch.from_numpy(v) for k, v in batch.items()}, gen)
    scene = write_sphere_scene(str(tmp_path / "scene"), 1, 8)
    runner = IDRTrainRunner(conf=parse_string(text), data_split_dir=scene, freeze_geometry=True,
                            exps_folder_name=str(tmp_path / "exps"), device="cpu")
    step = {k: torch.from_numpy(v) for k, v in batch.items()}
    ld, _, finite = runner.train_step(step, {"rgb": torch.zeros(1, 24, 3)}, False, False, 50.0)
    assert finite and float(ld["idr_rgb_loss"].detach()) > 0
