"""The port's two tools that render through RenderRunner, against the JAX
package's on a checkpoint it wrote (CPU): vis_rotate_envlight (2 angles) and
idr_color_analyze (2 pixels, 4x8 directions). The Monte-Carlo directions are
injected as test_torch_port_render_types injects them.

Gates: render.exr at >= 60 dB of JAX's (that file's path-traced gate), the
PNGs within 1 level, the hit flags equal, the two angles' renders differ.
The port runs the plain versions of K1 fp32 and K2 (CPU tensors, the conf's
use_fused_sdf); the JAX package its plain networks (use_fused_sdf off, the
Pallas kernels' reference). Most of this file's time is the JAX package's
compilation of its render.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.ops import sampling as js
from nefii_tpu.scripts import idr_color_analyze as jidr_color
from nefii_tpu.scripts import vis_rotate_envlight as jvis_rotate
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.scripts import idr_color_analyze, vis_rotate_envlight
from nefii_tpu_torch.utils import exr

from test_torch_port_render_types import build, patch_samplers, psnr, type_conf
from test_torch_port_tools import _png_close

ESTIMATOR_DB = 60.0
HEADER = ("train {\n    expname = port_tools\n"
          "    dataset_class = datasets.scene_dataset.SceneDataset\n"
          "    model_class = model.implicit_differentiable_renderer.IDRNetwork\n}\n")
MODEL = type_conf("pt_render_indirect_mlp")


@pytest.fixture(scope="module")
def jax_experiment(tmp_path_factory):
    """-> (the port's argv, JAX's argv, d): a JAX-initialised checkpoint,
    the conf with use_fused_sdf for the port and without it for JAX, and a
    camera-only 8x8 view."""
    d = tmp_path_factory.mktemp("tools_exp")
    (d / "port.conf").write_text(HEADER + MODEL)
    (d / "jax.conf").write_text(HEADER + MODEL.replace("use_fused_sdf = True",
                                                       "use_fused_sdf = False"))
    _, params, _ = build(MODEL)
    exp = d / "exps" / "port_tools"
    jck.save_collection(str(exp / "2026_01_01" / "checkpoints"), jck.MODEL, "latest", params,
                        {"epoch": 1})
    scene = SceneDataset.write_camera_only_split(str(d / "scene"), 1, 8, focal=10.0)
    common = ["--data_split_dir", scene, "--old_expdir", str(exp), "--memory_capacity_level",
              "6"]
    return (["--conf", str(d / "port.conf"), *common, "--device", "cpu"],
            ["--conf", str(d / "jax.conf"), *common, "--no_auto_budget"], d)


def test_vis_rotate_envlight_matches_jax(jax_experiment, monkeypatch):
    argv, jargv, d = jax_experiment
    flags = ["--step_deg", "180", "--num_rays", "2"]
    patch_samplers(monkeypatch, js, jnp)
    patch_samplers(monkeypatch, ts, torch)
    fm.reset_launch_counts()
    runner = vis_rotate_envlight.main(argv + flags + ["--out_dir", str(d / "rot_port")])
    assert all(n == 0 for n in fm.LAUNCHES.values())  # CPU tensors: the plain versions
    jvis_rotate.main(jargv + flags + ["--out_dir", str(d / "rot_jax")])
    assert len(runner.stats) == 2
    renders = []
    for ang in ("000", "180"):
        t = exr.read(str(d / "rot_port" / f"rot_{ang}" / "render.exr"))
        j = exr.read(str(d / "rot_jax" / f"rot_{ang}" / "render.exr"))
        assert t.shape == j.shape == (8, 8, 3) and np.isfinite(t).all()
        assert psnr(t, j) >= ESTIMATOR_DB, (ang, psnr(t, j))
        renders.append(t)
        for png in ("render.png", "envmap.png"):
            _png_close(str(d / "rot_port" / f"rot_{ang}" / png),
                       str(d / "rot_jax" / f"rot_{ang}" / png))
    assert not np.array_equal(renders[0], renders[1])


def test_idr_color_analyze_matches_jax(jax_experiment, capsys):
    argv, jargv, d = jax_experiment
    flags = ["--pixels", "4,4", "0,0", "--n_theta", "4", "--n_phi", "8"]
    got = idr_color_analyze.main(argv + flags + ["--out_dir", str(d / "idr_port")])
    capsys.readouterr()
    jidr_color.main(jargv + flags + ["--out_dir", str(d / "idr_jax")])
    jhit = re.search(r"hit: \[([^\]]*)\]", capsys.readouterr().out).group(1).split()
    np.testing.assert_array_equal(got["hit"], [h == "True" for h in jhit])
    assert got["hit"].any() and not got["hit"].all()
    for i in range(2):
        assert got["colors"][i].shape == (4, 8, 3) and np.isfinite(got["colors"][i]).all()
        _png_close(str(d / "idr_port" / f"idr_colors_px{i}.png"),
                   str(d / "idr_jax" / f"idr_colors_px{i}.png"))
