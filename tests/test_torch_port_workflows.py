"""The port's workflow scripts (nefii_tpu_torch/workflows/*.sh).

  * every script parses (`bash -n`), and every `python -m` module a script
    names exists in nefii_tpu_torch;
  * neus2nefii.sh converts a NeuS scene; run_s2_wmask.sh trains a small conf
    (--device cpu --max_niter 1 after its positional arguments: the last
    occurrence of a flag wins) and render.sh renders one view of that run,
    each exiting 0 in a temporary working directory, with DATA_PATH and
    SAVE_PATH pointing into it;
  * a script whose python run fails exits non-zero (set -o pipefail), where
    the JAX package's workflows/render.sh, which pipes the run into tee
    without pipefail, exits 0: the difference is kept on purpose.
"""

import glob
import importlib.util
import os
import re
import subprocess
import sys

import pytest

from nefii_tpu_torch.datasets.synthetic import write_neus_scene, write_sphere_scene
from nefii_tpu_torch.config import parse_string
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils import exr

from test_torch_port_training import TRAIN_CONF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = os.path.join(ROOT, "nefii_tpu_torch", "workflows")
SCRIPTS = sorted(os.path.relpath(p, WORKFLOWS)
                 for p in glob.glob(os.path.join(WORKFLOWS, "**", "*.sh"), recursive=True))
SMALL = ["--device", "cpu", "--memory_capacity_level", "8"]


def _run(script, args, cwd, env=None, root=WORKFLOWS):
    full = {**os.environ, "PYTHON": sys.executable, **(env or {})}
    return subprocess.run(["bash", os.path.join(root, script), *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def test_every_script_is_shipped():
    assert len(SCRIPTS) == 10 + 4 * 4  # the JAX set, run_sweep.sh, 4 scenes x 4 wrappers
    for scene in ("robot", "hotdog", "coffee", "fruit"):
        for w in ("eval.sh", "render.sh", "run_s1.sh", "run_s2.sh"):
            assert os.path.join(scene, w) in SCRIPTS
            assert os.access(os.path.join(WORKFLOWS, scene, w), os.X_OK)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_parses(script):
    r = subprocess.run(["bash", "-n", os.path.join(WORKFLOWS, script)], capture_output=True,
                       text=True, timeout=10)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_modules_exist(script):
    with open(os.path.join(WORKFLOWS, script)) as f:
        text = f.read()
    modules = re.findall(r"-m (\S+)", text)
    assert all(m.startswith("nefii_tpu_torch.") for m in modules), modules
    for m in modules:
        assert importlib.util.find_spec(m) is not None, m
    if "/" not in script and script not in ("common.sh", "run_sweep.sh"):
        assert modules, script
        assert "set -eo pipefail" in text and '"${@:' in text, script


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """DATA_PATH with scene `ball` (train and test splits), a Step-1
    geometry checkpoint of the small conf, and the conf."""
    d = tmp_path_factory.mktemp("wf")
    write_sphere_scene(str(d / "data" / "ball" / "train"), n_views=2, res=16)
    write_sphere_scene(str(d / "data" / "ball" / "test"), n_views=1, res=16)
    conf = d / "small.conf"
    conf.write_text(TRAIN_CONF.replace("plot_freq = 1\n", "plot_freq = 0\n"))
    model = IDRNetwork.from_conf(parse_string(TRAIN_CONF).get_config("model"), seed=0)
    geo = d / "geometry" / "checkpoints"
    ckpt.save_collection(str(geo), ckpt.MODEL, "latest", ckpt.params_to_jax(model),
                         {"epoch": 0})
    return d, {"DATA_PATH": str(d / "data"), "SAVE_PATH": str(d / "exps")}, str(conf), str(geo)


def test_neus2nefii_converts_a_scene(tmp_path):
    src = write_neus_scene(str(tmp_path / "neus"))
    r = _run("neus2nefii.sh", [src, str(tmp_path / "out")], str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    for split in ("train", "test"):
        assert (tmp_path / "out" / split / "cam_dict_norm.json").exists()
        assert sorted(os.listdir(tmp_path / "out" / split / "image")) == ["000.png", "001.png"]


def test_run_s2_wmask_then_render(data, tmp_path):
    d, env, conf, geo = data
    r = _run("run_s2_wmask.sh", ["ball", geo, *SMALL, "--conf", conf, "--max_niter", "1",
                                 "--secondary_batch_size", "32"], str(tmp_path), env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "Training reached max iters 2" in r.stdout
    log = (tmp_path / "run_s2_ball.log").read_text()
    assert log == r.stdout and "loss" in log
    expdir = os.path.join(env["SAVE_PATH"], "00_s2_unknow_ball")
    (stamp,) = os.listdir(expdir)
    assert os.path.exists(os.path.join(expdir, stamp, "checkpoints"))

    out = tmp_path / "renders"
    r = _run("render.sh", ["ball", expdir, "latest", *SMALL, "--conf", conf, "--num_rays", "1",
                           "--max_views", "1", "--out_dir", str(out)], str(tmp_path), env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert exr.read(str(out / "rerender_rgb_000.exr")).shape == (16, 16, 3)
    assert (tmp_path / "render_ball.log").exists()


def test_a_failed_run_fails_the_script_unlike_jax(data, tmp_path):
    """render.sh on a scene that DATA_PATH does not hold: python raises at
    the dataset; the port's script exits non-zero, the JAX package's 0."""
    _, env, conf, _ = data
    exp = str(tmp_path / "exp")
    r = _run("render.sh", ["no_such_scene", exp, "latest", *SMALL, "--conf", conf],
             str(tmp_path), env)
    assert r.returncode != 0 and "Data directory is empty" in r.stdout
    j = _run("render.sh", ["no_such_scene", exp], str(tmp_path), {**env, "REPO": ROOT},
             root=os.path.join(ROOT, "workflows"))
    assert j.returncode == 0 and "Data directory is empty" in j.stdout
