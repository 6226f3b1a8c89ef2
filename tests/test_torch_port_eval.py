"""Evaluation of the port (utils/metrics.py, utils/lpips.py,
scripts/evaluate.py) against the JAX package on the CPU, on numpy-seeded
images.

Gates: PSNR, SSIM and MS-SSIM equal to JAX's within 1e-10 (the same float64
numpy/scipy arithmetic); LPIPS-alex with seeded random weights in a
temporary .npz at rel 1e-5 of lpips_jax (float32 convolutions); the weight
layouts (full LPIPS state dict, torchvision alexnet + lin heads directory,
.npz) load to the same arrays; without weights LPIPS is "unavailable";
evaluate.main on a written prediction/ground-truth folder gives JAX's
results.txt numbers; evaluate, geometry_runner, fit_envmap_with_sg,
vis_rotate_envlight and idr_color_analyze refuse to run without CUDA unless
--device cpu is given, and write nothing.
"""

import os

import numpy as np
import pytest
import torch

from nefii_tpu.scripts import evaluate as jevaluate
from nefii_tpu.utils import exr as jexr
from nefii_tpu.utils import lpips_jax
from nefii_tpu.utils import metrics as jmetrics
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.scripts import evaluate, fit_envmap_with_sg, idr_color_analyze
from nefii_tpu_torch.scripts import vis_rotate_envlight
from nefii_tpu_torch.training import geometry_runner
from nefii_tpu_torch.utils import lpips, metrics
from nefii_tpu_torch.utils.png import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL = 1e-10
LPIPS_REL = 1e-5
H, W = 64, 72


def _images(seed=0):
    rs = np.random.RandomState(seed)
    gt = rs.uniform(0, 1, (H, W, 3)).astype(np.float32)
    pred = np.clip(gt + rs.normal(0, 0.05, (H, W, 3)), 0, 1).astype(np.float32)
    mask = rs.uniform(0, 1, (H, W)) > 0.3
    return pred, gt, mask


def _lpips_weights(seed=3):
    """Random LPIPS-alex weights in the canonical layout (He-scaled convs,
    positive lin heads as the trained ones are)."""
    rs = np.random.RandomState(seed)
    w, c_in = {}, 3
    for i, (c_out, k, _, _) in enumerate(lpips._CONVS):
        w[f"conv{i}_w"] = (rs.randn(c_out, c_in, k, k) * np.sqrt(2.0 / (c_in * k * k))).astype(
            np.float32)
        w[f"conv{i}_b"] = (rs.randn(c_out) * 0.01).astype(np.float32)
        w[f"lin{i}"] = rs.uniform(0, 0.1, c_out).astype(np.float32)
        c_in = c_out
    return w


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "alex.npz")
    lpips.save_npz(_lpips_weights(), path)
    return path


@pytest.mark.parametrize("metric", ["psnr", "psnr_masked", "ssim", "ms_ssim"])
def test_metrics_match_jax(metric):
    pred, gt, mask = _images()
    if metric == "psnr_masked":
        got, ref = metrics.psnr(pred, gt, mask), jmetrics.psnr(pred, gt, mask)
    else:
        got, ref = getattr(metrics, metric)(pred, gt), getattr(jmetrics, metric)(pred, gt)
    assert np.isfinite(got) and abs(got - ref) <= METRIC_ATOL, (got, ref)


def test_lpips_matches_jax(weights_npz):
    pred, gt, _ = _images(1)
    got = metrics.lpips(pred, gt, weights_npz, device="cpu")
    ref = lpips_jax.lpips_from_path(pred, gt, weights_npz)
    assert got > 0
    np.testing.assert_allclose(got, ref, rtol=LPIPS_REL)
    assert metrics.lpips(gt, gt, weights_npz, device="cpu") == 0.0


def test_lpips_weight_layouts_load_alike(weights_npz, tmp_path):
    """A full lpips.LPIPS state dict (.pth), and a directory with a
    torchvision alexnet state dict and the lin-head file, give the .npz's
    arrays in both packages."""
    canon = lpips.load_weights(weights_npz)
    full = {}
    for i, tv in enumerate(lpips._TV_IDX):
        full[f"net.slice{i + 1}.{tv}.weight"] = torch.from_numpy(canon[f"conv{i}_w"])
        full[f"net.slice{i + 1}.{tv}.bias"] = torch.from_numpy(canon[f"conv{i}_b"])
        full[f"lin{i}.model.1.weight"] = torch.from_numpy(canon[f"lin{i}"].reshape(1, -1, 1, 1))
    torch.save(full, str(tmp_path / "lpips_full.pth"))
    split = tmp_path / "split"
    split.mkdir()
    torch.save({f"features.{tv}.{a}": torch.from_numpy(canon[f"conv{i}_{a[0]}"])
                for i, tv in enumerate(lpips._TV_IDX) for a in ("weight", "bias")},
               str(split / "alexnet.pth"))
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(canon[f"lin{i}"].reshape(1, -1, 1, 1))
                for i in range(5)}, str(split / "alex.pth"))
    for path in (str(tmp_path / "lpips_full.pth"), str(split)):
        got, ref = lpips.load_weights(path), lpips_jax.load_weights(path)
        assert set(got) == set(canon) == set(ref)
        for k in canon:
            np.testing.assert_array_equal(got[k], canon[k])
            np.testing.assert_array_equal(ref[k], canon[k])
    del full["lin4.model.1.weight"]
    torch.save(full, str(tmp_path / "incomplete.pth"))
    with pytest.raises(ValueError, match="incomplete"):
        lpips.load_weights(str(tmp_path / "incomplete.pth"))


def test_lpips_is_unavailable_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("NEFII_LPIPS_WEIGHTS", raising=False)
    pred, gt, _ = _images()
    with pytest.raises(RuntimeError, match="NEFII_LPIPS_WEIGHTS"):
        metrics.lpips(pred, gt, device="cpu")
    with pytest.raises(RuntimeError, match="path not found"):
        metrics.lpips(pred, gt, str(tmp_path / "missing.npz"), device="cpu")


def _write_eval_folders(root):
    """A ground-truth folder (image/, mask/, diffuse/, roughness/, sp_rgb/)
    and a prediction folder in the render's EXR names, 2 views."""
    rs = np.random.RandomState(4)
    gt, pred = os.path.join(root, "gt"), os.path.join(root, "pred")
    for d in ("image", "mask", "diffuse", "roughness", "sp_rgb"):
        os.makedirs(os.path.join(gt, d))
    os.makedirs(pred)
    for i in range(2):
        mask = rs.uniform(0, 1, (H, W)) > 0.25
        write_png(os.path.join(gt, "mask", f"{i:03d}.png"), (mask * 255).astype(np.uint8))
        for gt_dir, pred_name, scale in (("image", "rerender_rgb", 2.0),
                                         ("diffuse", "diffuse_albedo", 1.0),
                                         ("roughness", "roughness", 1.0),
                                         ("sp_rgb", "specular_rgb", 0.5)):
            ref = rs.uniform(0.05, 1, (H, W, 3)).astype(np.float32) * scale
            noisy = np.clip(ref * rs.uniform(0.8, 1.25, 3) + rs.normal(0, 0.03, ref.shape), 0,
                            None).astype(np.float32)
            jexr.write(os.path.join(gt, gt_dir, f"{i:03d}.exr"), ref)
            jexr.write(os.path.join(pred, f"{pred_name}_{i:03d}.exr"), noisy)
    return pred, gt


def _report(path):
    with open(path) as f:
        return dict(line.split(": ", 1) for line in f.read().splitlines())


def test_evaluate_main_matches_jax(weights_npz, tmp_path, monkeypatch):
    pred, gt = _write_eval_folders(str(tmp_path))
    monkeypatch.setenv("NEFII_LPIPS_WEIGHTS", weights_npz)
    got = evaluate.cli([pred, gt, "--device", "cpu"])
    port = _report(os.path.join(pred, "results.txt"))
    ref = jevaluate.main(pred, gt, str(tmp_path / "jax_results.txt"))
    jax_report = _report(str(tmp_path / "jax_results.txt"))
    assert set(got) == set(ref) == {"rgb", "diffuse", "diffuse_align", "roughness", "sp_rgb"}
    assert set(port) == set(jax_report) and len(port) == 15
    for item in ref:
        assert set(got[item]) == set(ref[item])
        for metric, vals in ref[item].items():
            tol = dict(rtol=LPIPS_REL) if metric == "lpips" else dict(atol=METRIC_ATOL, rtol=0)
            np.testing.assert_allclose(got[item][metric], vals, err_msg=f"{item}.{metric}",
                                       **tol)
    for key, line in jax_report.items():
        if key != "rgb.lpips":
            assert port[key] == line, key
    np.testing.assert_allclose(float(port["rgb.lpips"]), float(jax_report["rgb.lpips"]),
                               rtol=LPIPS_REL, atol=2e-6)

    # without weights the LPIPS row reads "unavailable", with its reason
    monkeypatch.delenv("NEFII_LPIPS_WEIGHTS")
    evaluate.main(pred, gt, str(tmp_path / "no_lpips.txt"), device="cpu")
    line = _report(str(tmp_path / "no_lpips.txt"))["rgb.lpips"]
    assert line.startswith("unavailable (") and "NEFII_LPIPS_WEIGHTS" in line


def test_entry_points_default_to_cuda(tmp_path):
    """Without --device the new CLIs ask for the card, and refuse where CUDA
    is absent rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    pred, gt = _write_eval_folders(str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        evaluate.cli([pred, gt])
    with pytest.raises(RuntimeError, match="is_available"):
        geometry_runner.main(["--conf", os.path.join(ROOT, "confs", "sdf.conf"), "--mesh_path",
                              "unused.ply", "--exps_folder_name", str(tmp_path / "exps")])
    assert not (tmp_path / "exps").exists()

    # the offline tools that compute on a device
    env = str(tmp_path / "env.exr")
    jexr.write(env, np.ones((8, 16, 3), np.float32))
    with pytest.raises(RuntimeError, match="is_available"):
        fit_envmap_with_sg.main(["--envmap", env, "--n_iter", "1", "--resize", "4", "8",
                                 "--out_dir", str(tmp_path / "fit")])
    scene = SceneDataset.write_camera_only_split(str(tmp_path / "scene"), 1, 8, focal=10.0)
    render_argv = ["--conf", os.path.join(ROOT, "confs", "conf.conf"), "--data_split_dir",
                   scene, "--old_expdir", str(tmp_path / "exp"), "--out_dir",
                   str(tmp_path / "tool_out")]
    for tool in (vis_rotate_envlight, idr_color_analyze):
        with pytest.raises(RuntimeError, match="is_available"):
            tool.main(render_argv)
    assert sorted(os.listdir(tmp_path)) == ["env.exr", "gt", "pred", "scene"]
