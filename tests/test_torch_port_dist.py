"""Multi-process port (nefii_tpu_torch/parallel/) on the CPU: two gloo ranks
against the single-process port and against the JAX package's 2-device
mesh (spmd.make_grad_fn, make_eval_forward, the sharded Step-1 step), on
the same seeded numpy inputs and JAX-initialised weights.

How they run: the port's ranks are `spawn`ed processes (the pytest process
has JAX's 8 virtual CPU devices), which join a gloo group at a file store in
the test's tmp directory, run tests/test_torch_port_dist_ranks.py's cases on
their slices and save what they computed; every group is joined within a
time limit that fails the test. The Monte-Carlo samplers are injected in
every process (test_torch_port_training's directions). The JAX side runs
here on make_mesh(2); each rank's min-SDF vector comes from the key JAX
folds with that rank.

Gates: against one process, the loss at rel 1e-6 and every gradient at a
relative L2 of 1e-6 (the same sums in another order), the secondary-hit pool
and the distilled batch equal; against JAX, the training gates of
test_torch_port_training (loss terms rel 1e-5, gradients rel L2 2e-3, the
pool's hit mask equal), the render slice's PSNR gates, Step 1's loss rel
1e-5 and parameters atol 1e-6."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.config import parse_string as jparse
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.models.loss import IDRLoss as JLoss
from nefii_tpu.ops import sampling as js
from nefii_tpu.parallel import spmd as jspmd
from nefii_tpu.parallel.mesh import make_mesh
from nefii_tpu.training.geometry_trainer import GeometryTrainRunner as JGeometryTrainRunner
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils.camera import rot_to_quat
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.parallel import dist, spmd
from nefii_tpu_torch.scripts.dryrun_multichip import dryrun_multichip
from nefii_tpu_torch.scripts.render import OUTPUT_KEYS
from nefii_tpu_torch.utils.checkpoints import params_from_jax

import test_torch_port_dist_ranks as ranks
from test_idr_forward import SMALL_CONF
from test_torch_port_geometry import STEP_CONF, mesh_file  # noqa: F401  (a fixture)
from test_torch_port_slice import ESTIMATOR_DB, FORWARD_DB, _psnr
from test_torch_port_training import LOSS_CONF, TRAIN_CONF, _patch_samplers, _rel, _rel_l2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PORT_REL = 1e-6
LOSS_REL = 1e-5
GRAD_REL_L2 = 2e-3
STEP1_REL, STEP1_ATOL = 1e-5, 1e-6
MODEL_CONF = SMALL_CONF.replace(
    "n_rootfind_steps = 8\n    }",
    "n_rootfind_steps = 8\n    }\n    secondary_ray_tracer {\n        sphere_tracing_iters = 3\n"
    "        line_step_iters = 0\n        n_steps = 16\n    }")
KEY = jax.random.PRNGKey(1)
K_MAX = 7  # distilled hits: not a multiple of WORLD
JAX_GROUPS = ("rendering_network", "envmap_material_network")


def _steps01(jmodel, key):
    return np.array(jax.random.uniform(jax.random.split(key, 3)[0], (jmodel.ray_tracer.n_steps,)))


@pytest.fixture(scope="module")
def job(mesh_file, tmp_path_factory):  # noqa: F811
    conf = jparse(MODEL_CONF).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    model = params_from_jax(IDRNetwork.from_conf(conf), flatten_tree(params))
    batch, gt = ranks.training_batch()
    n_rays = batch["uv"][..., 0].size
    shared = _steps01(jmodel, KEY)
    folded = np.stack([_steps01(jmodel, jax.random.fold_in(KEY, r)) for r in range(WORLD)])
    rs = np.random.RandomState(12)
    eik = rs.uniform(-1.0, 1.0, (n_rays // 2, 3)).astype(np.float32)
    pts = rs.randn(5, 3)
    pts = (0.6 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)
    dirs = rs.randn(5, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pose_vec = np.concatenate([np.asarray(rot_to_quat(jnp.asarray(batch["pose"][:, :3, :3]))),
                               batch["pose"][:, :3, 3]], -1).astype(np.float32)
    cam_batch = {k: v for k, v in batch.items() if k != "pose"}
    step = dict(kind="step", batch=batch, gt=gt, freeze_geo=True, steps01=shared,
                secondary_limit=3 * n_rays, k_max=K_MAX, num_rays=batch["uv"].shape[2])
    jr = JGeometryTrainRunner(conf=jparse(STEP_CONF), mesh_path=mesh_file, batch_points=512,
                              max_niters=10, n_devices=WORLD, seed=7,
                              exps_folder_name=str(tmp_path_factory.mktemp("jax_geo")))
    cases = {
        "frozen": step,
        "frozen_folded": dict(step, steps01=folded),
        "live": dict(step, freeze_geo=False, eik=eik),
        "cameras": dict(step, batch=cam_batch, cameras=True, pose_vec=pose_vec),
        "distill": dict(kind="distill", batch={
            "points": np.ascontiguousarray(np.broadcast_to(pts[:, None], (5, 2, 3))),
            "ray_dirs": np.ascontiguousarray(np.broadcast_to(dirs[:, None], (5, 2, 3)))}),
        "eval": dict(kind="eval", batch={k: v for k, v in batch.items()}, keys=OUTPUT_KEYS),
        "step1": dict(kind="step1", conf=STEP_CONF, mesh=mesh_file, batch_points=512, steps=3,
                      params=flatten_tree(jr.params),
                      exps=str(tmp_path_factory.mktemp("port_geo"))),
    }
    return dict(model_conf=MODEL_CONF, loss_conf=LOSS_CONF, state=model.state_dict(),
                tables=ranks.dir_tables(), device="cpu", cases=cases,
                jax=dict(model=jmodel, params=params, geometry=jr))


@pytest.fixture(scope="module")
def started(job, tmp_path_factory):
    port_job = {k: v for k, v in job.items() if k != "jax"}
    started = ranks.start_job(port_job, WORLD, str(tmp_path_factory.mktemp("ranks")))
    yield started
    ranks.join(started[1], 0.0)  # a test that failed early leaves no rank behind


@pytest.fixture(scope="module")
def two_ranks(started, jax_side, one_process):
    """The ranks' results, collected after this process computed the JAX and
    the single-process side while they ran."""
    return ranks.finish_job(started)


@pytest.fixture(scope="module")
def one_process(job):
    port_job = {k: v for k, v in job.items() if k != "jax"}
    port_job["cases"] = {k: v for k, v in port_job["cases"].items() if k != "step1"}
    return ranks.run_cases(port_job)


@pytest.fixture(scope="module")
def jax_side(job):
    jmodel, params = job["jax"]["model"], job["jax"]["params"]
    c = job["cases"]["frozen"]
    mesh = make_mesh(WORLD)
    jb = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    jg = {k: jnp.asarray(v) for k, v in c["gt"].items()}
    with pytest.MonkeyPatch.context() as mp:
        _patch_samplers(mp, js, jnp)
        fn = jspmd.make_grad_fn(jmodel, JLoss(**LOSS_CONF), mesh, freeze_geo=True)(jb, jg)
        ld, grads, secondary = jax.jit(fn)(params, jb, jg, KEY,
                                           jnp.float32(LOSS_CONF["alpha"]))
        ev = jax.jit(jspmd.make_eval_forward(jmodel, mesh)(jb))(params, jb, KEY)
    return (ld, grads, {k: np.asarray(v) for k, v in secondary.items()},
            {k: np.asarray(ev[k]) for k in OUTPUT_KEYS})


def _by_group(grads, group):
    return np.concatenate([np.asarray(v).reshape(-1) for k, v in sorted(grads.items())
                           if k.startswith(group + ".")])


# ---------------------------------------------------------------------------

def test_shard_batch_cuts_the_keys_jax_shards():
    """shard_batch cuts exactly the keys JAX's batch_pspec shards, on their
    axes, each rank a contiguous slice, and refuses a size that does not
    divide."""
    rs = np.random.RandomState(0)
    batch = {"uv": rs.rand(2, 8, 3, 2), "object_mask": rs.rand(2, 8) < 0.5,
             "rgb": rs.rand(2, 8, 3), "pixel_visible": rs.rand(2, 8) < 0.5,
             "points": rs.rand(8, 4, 3), "ray_dirs": rs.rand(8, 4, 3),
             "intrinsics": rs.rand(2, 4, 4), "pose": rs.rand(2, 4, 4), "pose_indices": np.arange(2)}
    specs = jspmd.batch_pspec(batch)
    for r in range(WORLD):
        got = spmd.shard_batch(batch, r, WORLD)
        for k, v in batch.items():
            axis = [i for i, a in enumerate(specs[k]) if a is not None]
            if not axis:
                assert got[k] is v, k
                continue
            n = v.shape[axis[0]] // WORLD
            want = np.take(v, np.arange(r * n, (r + 1) * n), axis=axis[0])
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert spmd.shard_batch(batch, 0, 1) is batch
    with pytest.raises(ValueError, match="'uv' has 8 on axis 1"):
        spmd.shard_batch(batch, 0, 3)


@pytest.mark.parametrize("case", ["frozen", "live", "cameras"])
def test_two_rank_step_equals_one_process(two_ranks, one_process, case):
    """A 2-rank step's loss and gradients (the pose's too) are the
    single-process step's on the whole batch; the gathered pool and the
    distilled batch are the single process's."""
    one = one_process[case]
    for r, res in enumerate(two_ranks):
        got = res[case]
        for term, v in one["terms"].items():
            assert _rel(got["terms"][term], v) <= PORT_REL or v == got["terms"][term] == 0, \
                (r, term)
        groups = {n.split(".", 1)[0] for n, g in one["grads"].items() if np.any(g)}
        assert groups >= set(JAX_GROUPS) | ({"implicit_network"} if case == "live" else set())
        for g in groups:
            err = _rel_l2(_by_group(got["grads"], g), _by_group(one["grads"], g))
            assert err <= PORT_REL, (r, g, err)
        if case == "cameras":
            assert np.any(one["pose_grad"])
            assert _rel_l2(got["pose_grad"], one["pose_grad"]) <= PORT_REL
    for r, res in enumerate(two_ranks):
        for k, v in one["pool"].items():
            np.testing.assert_array_equal(res[case]["pool"][k], v, err_msg=f"rank {r} {k}")
        d, od = res[case]["distilled"], one["distilled"]
        assert d["K"] == od["K"] == K_MAX and d["rows"] == K_MAX + 1 and od["rows"] == K_MAX
        for k in ("points", "ray_dirs"):
            np.testing.assert_array_equal(d[k], od[k])
    for r in range(1, WORLD):  # every rank holds the same sums
        assert two_ranks[r][case]["terms"] == two_ranks[0][case]["terms"]


def test_two_rank_step_matches_jax_two_device_mesh(two_ranks, jax_side):
    """The 2-rank frozen step, each rank's min-SDF vector from JAX's folded
    key, against spmd.make_grad_fn on a 2-device mesh."""
    ld, grads, secondary, _ = jax_side
    got = two_ranks[0]["frozen_folded"]
    terms = [t for t in got["terms"] if t in ld and float(ld[t]) != 0.0]
    assert "loss" in terms and "mask_loss" in terms
    for term in terms:
        assert _rel(got["terms"][term], float(ld[term])) <= LOSS_REL, term
    jflat = {k.replace("/", "."): np.asarray(v) for k, v in flatten_tree(grads).items()}
    for g in JAX_GROUPS:
        err = _rel_l2(_by_group(got["grads"], g), _by_group(jflat, g))
        assert err <= GRAD_REL_L2, (g, err)
    jm = secondary["secondary_mask"]
    tm = got["pool"]["secondary_mask"]
    assert tm.shape == jm.shape and tm.any()
    np.testing.assert_array_equal(tm, jm)
    sel = tm[..., 0]
    np.testing.assert_allclose(got["pool"]["secondary_points"][sel],
                               secondary["secondary_points"][sel], atol=1e-4)


def test_sharded_distillation_equals_one_process(two_ranks, one_process):
    """5 hits on 2 ranks: padded to 6 rows, 3 a rank, the padding masked out
    of the (num, den) L1."""
    one = one_process["distill"]
    for res in two_ranks:
        got = res["distill"]
        assert got["rows"] == 3 and one["rows"] == 5
        assert _rel(got["loss"], one["loss"]) <= PORT_REL
        for g in JAX_GROUPS:
            assert _rel_l2(_by_group(got["grads"], g), _by_group(one["grads"], g)) <= PORT_REL


@pytest.mark.parametrize("key,gate", [("sg_rgb_values", ESTIMATOR_DB),
                                      ("sg_diffuse_albedo_values", FORWARD_DB),
                                      ("normal_values", FORWARD_DB),
                                      ("idr_rgb_values", FORWARD_DB), ("points", FORWARD_DB)])
def test_sharded_eval_forward_matches_jax(two_ranks, one_process, jax_side, key, gate):
    """Each rank renders half the chunk and gets all of it: the JAX
    make_eval_forward's on 2 devices within the render slice's gates, and the
    single process's."""
    ref = jax_side[3]
    for res in two_ranks:
        got = res["eval"]
        assert got[key].shape == ref[key].shape
        assert _psnr(got[key], ref[key]) >= gate, key
        np.testing.assert_allclose(got[key], one_process["eval"][key], atol=1e-6)
    assert two_ranks[0]["eval"]["n_sdf_evals"] == two_ranks[1]["eval"]["n_sdf_evals"] > 0


def test_step1_two_ranks_match_jax_sharded_step(two_ranks, job):
    """Three Step-1 steps of 512 points, 256 a rank, against the JAX runner's
    step on a 2-device mesh."""
    jr = job["jax"]["geometry"]
    assert jr.mesh.devices.size == WORLD
    params, state = jr.params, jr.opt_state
    for i in range(3):
        pts, sdf = jr.dataset[i]
        params, state, loss = jr._step(params, state, jnp.asarray(pts), jnp.asarray(sdf))
        for res in two_ranks:
            assert _rel(res["step1"]["losses"][i], float(loss)) <= STEP1_REL, i
    jflat = flatten_tree(params)
    for res in two_ranks:
        for k, v in jflat.items():
            np.testing.assert_allclose(res["step1"]["params"][k], v, atol=STEP1_ATOL, err_msg=k)


def test_world_of_one_is_the_plain_port(job):
    """dist.initialize with one process initialises nothing, and every spmd
    function is then the identity: a step through them is bit for bit the
    step without them."""
    dist.initialize(num_processes=1, process_id=0, device="cpu")
    assert not torch.distributed.is_initialized() and dist.process_count() == 1
    assert spmd.loss_all_reduce() is None
    batch = {"uv": np.zeros((1, 3, 2))}
    assert spmd.shard_batch(batch) is batch
    t = torch.arange(3.0)
    assert dist.gather_along(t, 0) is t and dist.all_reduce_sum(t) is t
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = g = torch.full((2,), 0.5)
    spmd.all_reduce_grads([p])
    assert p.grad is g
    port_job = {k: v for k, v in job.items() if k != "jax"}
    port_job["cases"] = {"frozen": job["cases"]["frozen"]}
    a, b = ranks.run_cases(port_job)["frozen"], ranks.run_cases(port_job)["frozen"]
    assert a["terms"] == b["terms"]
    for k in a["grads"]:
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _exp_rank(rank, argv, out):
    """One process of the 2-process CLI run: exp_runner.main, then its
    parameters and step records saved to `out`."""
    from nefii_tpu_torch.training import exp_runner
    from nefii_tpu_torch.utils import checkpoints as ckpt

    torch.set_num_threads(1)
    runner = exp_runner.main(argv + ["--process_id", str(rank), "--exps_folder_name",
                                     os.path.join(out, f"exps{rank}")])
    torch.save({"params": ckpt.params_to_jax(runner.model), "stats": runner.step_stats,
                "checkpoints": runner.checkpoints_path}, os.path.join(out, f"cli{rank}.pt"))
    dist.shutdown()


def test_exp_runner_two_processes_from_the_jax_flags(job, tmp_path):
    """exp_runner with --multihost --coordinator_address --num_processes 2
    --process_id r: two steps with vis and distillation; both ranks end with
    the same parameters, rank 1 (given its own --exps_folder_name) writes
    nothing, and the JAX package reads rank 0's checkpoint."""
    params = job["jax"]["params"]
    conf = tmp_path / "train.conf"
    conf.write_text(TRAIN_CONF.replace("plot_freq = 1\n", "plot_freq = 2\n")
                    + "plot {\n    surface_resolution = 16\n}\n")
    scene = write_sphere_scene(str(tmp_path / "scene"), n_views=3, res=16)
    geo = tmp_path / "geometry" / "checkpoints"
    jck.save_collection(str(geo), jck.MODEL, "latest", params, {"epoch": 0})
    argv = ["--conf", str(conf), "--data_split_dir", scene, "--freeze_geometry", "--geometry",
            str(geo), "--batch_size", "2", "--max_niter", "1", "--roughness_warmup", "1",
            "--secondary_train_interval", "1", "--secondary_batch_size", "31",
            "--memory_capacity_level", "8", "--device", "cpu", "--multihost",
            "--coordinator_address", f"localhost:{_free_port()}", "--num_processes", "2"]
    ranks.spawn(_exp_rank, lambda r: (r, argv, str(tmp_path)), WORLD, 240.0)
    out = [torch.load(tmp_path / f"cli{r}.pt", weights_only=False) for r in range(WORLD)]
    for k, v in out[0]["params"].items():
        np.testing.assert_array_equal(out[1]["params"][k], v, err_msg=k)
    assert [s["iter"] for s in out[0]["stats"]] == [0, 1] == [s["iter"] for s in out[1]["stats"]]
    assert [s["rays"] for s in out[0]["stats"]] == [2 * 64 * 2, 64 * 2]
    assert all(0 < s["secondary_points"] <= 31 for s in out[0]["stats"])
    assert not (tmp_path / "exps1").exists()
    plots = os.listdir(os.path.join(os.path.dirname(out[0]["checkpoints"]), "plots"))
    assert {"train_0.png", "train_0_sg_rgb.exr", "train_0_envmap.exr"} <= set(plots)
    jparams, extra = jck.load_collection(out[0]["checkpoints"], jck.MODEL, "latest", params)
    assert int(extra["epoch"]) == 1
    for k, v in flatten_tree(jparams).items():
        np.testing.assert_array_equal(v, out[0]["params"][k], err_msg=k)


def test_render_and_geometry_runner_under_torchrun(mesh_file, job, tmp_path):  # noqa: F811
    """torchrun --nproc_per_node=2 (its environment: RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT) runs the render CLI, which writes each view
    once from rank 0, and geometry_runner, whose ranks end with the same
    checkpoint."""
    conf = tmp_path / "render.conf"
    conf.write_text(TRAIN_CONF)
    scene = write_sphere_scene(str(tmp_path / "scene"), n_views=2, res=8)
    run = tmp_path / "exps" / "port_train" / "stamp" / "checkpoints"
    jck.save_collection(str(run), jck.MODEL, "latest", job["jax"]["params"], {"epoch": 0})
    geo_conf = tmp_path / "sdf.conf"
    geo_conf.write_text(STEP_CONF)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node=2", "-m"]
    res = subprocess.run(torchrun + [
        "nefii_tpu_torch.scripts.render", "--conf", str(conf), "--data_split_dir", scene,
        "--old_expdir", str(tmp_path / "exps" / "port_train"), "--num_rays", "1",
        "--out_dir", str(tmp_path / "renders"), "--memory_capacity_level", "6",
        "--device", "cpu"], capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("rendered view 1/2") == 1
    names = os.listdir(tmp_path / "renders")
    assert {"rerender_rgb_000.exr", "rerender_rgb_001.exr", "envmap.exr"} <= set(names)
    res = subprocess.run(torchrun + [
        "nefii_tpu_torch.training.geometry_runner", "--conf", str(geo_conf), "--mesh_path",
        mesh_file, "--batch_size", "256", "--max_niter", "3", "--not_scale_to_unit",
        "--exps_folder_name", str(tmp_path / "geo"), "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = os.listdir(tmp_path / "geo" / "geo_test_geometry")
    assert len(runs) == 1
    ck = tmp_path / "geo" / "geo_test_geometry" / runs[0] / "checkpoints"
    flat, extra = jck.load_collection(str(ck), jck.MODEL, "latest")
    assert int(extra["epoch"]) == 3 and all(np.isfinite(v).all() for v in flat.values())


def test_dryrun_multichip_script_two_ranks(capfd):
    dryrun_multichip(2)
    assert "dryrun_multichip(2): OK" in capfd.readouterr().out
