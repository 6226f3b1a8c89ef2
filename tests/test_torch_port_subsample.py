"""Dataset `subsample` in the port: utils/resize.py against cv2.resize, the
port's SceneDataset against the JAX package's, and the training and render
CLIs with --subsample against the JAX package.

Gates:
  * the resampler (area below scale 1, linear above, as the dataset picks)
    on a seeded non-square 40x56 float32 image within atol 1e-6 of
    cv2.resize; masks resampled as float32 and compared > 0.5 equal to
    cv2's, except pixels whose cv2 value lies within 2.4e-7 of 0.5 (two
    float32 sums of the same weights may round either way there): those are
    counted and printed, and at most 1% of them may flip;
  * SceneDataset(subsample=s) on a written sphere scene and on a
    camera-only split: resolution and intrinsics bit for bit, images as
    above, masks as above;
  * exp_runner.main(--subsample 0.5 --vis_subsample 0.5 --device cpu): the
    datasets it trains and plots on equal JAX's, and the gates of
    test_torch_port_training's CLI test (two finite steps with their
    distillation steps, a checkpoint the JAX package reads, the frozen
    geometry unchanged, the other nets trained); the per-step vis is off
    (it exports a mesh, which the subsample does not touch);
  * scripts/render.py --subsample 0.5 on the PhySG conf (the closed-form SG
    render, no Monte-Carlo draw) through both packages' CLIs: the same EXRs
    at the PhySG render CLI test's gates.
"""

import os

import cv2
import numpy as np
import pytest

from nefii_tpu.datasets.scene_dataset import SceneDataset as JSceneDataset
from nefii_tpu.scripts import render as jrender
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu_torch.config import parse_string
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.scripts import render
from nefii_tpu_torch.training import exp_runner
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils import exr
from nefii_tpu_torch.utils.resize import resize

from test_torch_port_physg import PHYSG_TRAIN
from test_torch_port_training import TRAIN_CONF

SCALES = (0.5, 0.25, 0.3, 1.5, 2)
RGB_ATOL = 1e-6
NEAR_HALF = 2.4e-7   # two float32 roundings of a value at 0.5
MAX_FLIP_SHARE = 0.01


def NO_PLOTS(text):
    """A training conf without its vis (a mesh export each time)."""
    assert "plot_freq = 1\n" in text
    return text.replace("plot_freq = 1\n", "plot_freq = 0\n")


def _mode(s):
    return "area" if s < 1 else "linear"


def _cv2(img, size, mode):
    interp = cv2.INTER_AREA if mode == "area" else cv2.INTER_LINEAR
    return cv2.resize(img, (size[1], size[0]), interpolation=interp)


def _assert_masks_match(port, ref_float, tag):
    """port: bool mask; ref_float: cv2's float32 resample of the same mask."""
    ref = ref_float > 0.5
    near = np.abs(ref_float - 0.5) <= NEAR_HALF
    np.testing.assert_array_equal(port[~near], ref[~near], err_msg=tag)
    flips = int((port[near] != ref[near]).sum())
    print(f"{tag}: {int(near.sum())} pixels within {NEAR_HALF} of 0.5, {flips} flip")
    assert flips <= MAX_FLIP_SHARE * near.sum(), tag


@pytest.mark.parametrize("s", SCALES)
def test_resize_matches_cv2(s):
    rs = np.random.RandomState(0)
    img = rs.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    size = (int(40 * s), int(56 * s))
    mode = _mode(s)
    got = resize(img, size, mode)
    want = _cv2(img, size, mode)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RGB_ATOL)

    mask = (rs.uniform(0, 1, (40, 56)) > 0.5).astype(np.float32)
    _assert_masks_match(resize(mask, size, mode) > 0.5, _cv2(mask, size, mode), f"s={s}")


def test_resize_area_where_an_axis_grows_matches_cv2():
    """cv2's INTER_AREA turns into a 2-tap filter when an axis grows (the
    envmap tools may ask for that)."""
    img = np.random.RandomState(1).uniform(0, 1, (40, 56, 3)).astype(np.float32)
    for size in ((52, 72), (20, 80), (100, 30)):
        np.testing.assert_allclose(resize(img, size, "area"), _cv2(img, size, "area"),
                                   rtol=0, atol=RGB_ATOL, err_msg=str(size))


@pytest.fixture(scope="module")
def sphere_scene(tmp_path_factory):
    return write_sphere_scene(str(tmp_path_factory.mktemp("sub_scene") / "scene"), n_views=2,
                              res=40)


def _assert_datasets_match(ds, jds, full, tag):
    """ds, jds: the port's and JAX's datasets at one subsample; full: JAX's
    at subsample 1, whose masks cv2 resamples as float32 for the mask gate."""
    assert ds.img_res == jds.img_res and ds.total_pixels == jds.total_pixels, tag
    for a, b in zip(ds.intrinsics_all, jds.intrinsics_all):
        np.testing.assert_array_equal(a, b, err_msg=tag)
    H, W = ds.img_res
    for a, b in zip(ds.rgb_images, jds.rgb_images):
        assert a.dtype == np.float32 and a.shape == (H * W, 3), tag
        np.testing.assert_allclose(a, b, rtol=0, atol=RGB_ATOL, err_msg=tag)
    mode = _mode(max(ds.img_res) / max(full.img_res))
    for i, (a, m) in enumerate(zip(ds.object_masks, full.object_masks)):
        assert a.dtype == bool and a.shape == (H * W,), tag
        ref = _cv2(m.reshape(full.img_res).astype(np.float32), ds.img_res, mode)
        np.testing.assert_array_equal(jds.object_masks[i], (ref > 0.5).reshape(-1))
        _assert_masks_match(a.reshape(ds.img_res), ref, f"{tag} view {i}")


def _jax_datasets(scene, *subsamples):
    return [JSceneDataset(1.0, scene, False, subsample=s) for s in subsamples]


@pytest.mark.parametrize("s", SCALES)
def test_scene_dataset_subsample_matches_jax(sphere_scene, s):
    ds = SceneDataset(1.0, sphere_scene, False, subsample=s)
    assert ds.img_res == [int(40 * s), int(40 * s)]
    _assert_datasets_match(ds, *_jax_datasets(sphere_scene, s, 1), f"s={s}")


@pytest.mark.parametrize("s", (0.5, 2))
def test_camera_only_split_subsample_matches_jax(tmp_path, s):
    scene = SceneDataset.write_camera_only_split(str(tmp_path / "cams"), 2, 16, focal=20.0)
    ds = SceneDataset(1.0, scene, False, subsample=s)
    assert not ds.has_groundtruth and ds.img_res == [int(16 * s)] * 2
    _assert_datasets_match(ds, *_jax_datasets(scene, s, 1), f"s={s}")


# ---------------------------------------------------------------------------
# the CLIs with --subsample
# ---------------------------------------------------------------------------

def test_exp_runner_trains_on_the_subsampled_scene(tmp_path):
    d = tmp_path
    (d / "train.conf").write_text(NO_PLOTS(TRAIN_CONF))
    scene = write_sphere_scene(str(d / "scene"), n_views=3, res=32)
    geo = d / "geometry" / "checkpoints"
    model = IDRNetwork.from_conf(parse_string(TRAIN_CONF).get_config("model"), seed=0)
    before = ckpt.params_to_jax(model)
    ckpt.save_collection(str(geo), ckpt.MODEL, "latest", before, {"epoch": 0})
    runner = exp_runner.main([
        "--conf", str(d / "train.conf"), "--data_split_dir", scene, "--freeze_geometry",
        "--geometry", str(geo), "--exps_folder_name", str(d / "exps"), "--batch_size", "2",
        "--max_niter", "1", "--roughness_warmup", "1", "--secondary_train_interval", "1",
        "--secondary_batch_size", "32", "--memory_capacity_level", "8", "--subsample", "0.5",
        "--vis_subsample", "0.5", "--device", "cpu"])

    # the datasets it trained and plotted on are JAX's
    assert runner.train_dataset.img_res == [16, 16]
    _assert_datasets_match(runner.train_dataset, *_jax_datasets(scene, 0.5, 1), "train")
    assert runner.plot_dataset.img_res == [8, 8]
    _assert_datasets_match(runner.plot_dataset, *_jax_datasets(scene, 0.25, 1), "plot")

    # the CLI test's gates
    assert [s["iter"] for s in runner.step_stats] == [0, 1]
    assert [s["rays"] for s in runner.step_stats] == [2 * 64 * 2, 64 * 2]
    assert all(np.isfinite(s["loss"]) and 0 < s["secondary_points"] <= 32
               for s in runner.step_stats)
    after, extra = jck.load_collection(runner.checkpoints_path, jck.MODEL, "latest")
    assert int(extra["epoch"]) == 1 and set(after) == set(before)
    port = ckpt.params_to_jax(runner.model)
    for k in before:
        np.testing.assert_array_equal(after[k], port[k], err_msg=k)
        if k.startswith("implicit_network/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for net in ("rendering_network", "envmap_material_network"):
        assert any(not np.array_equal(after[k], before[k]) for k in before
                   if k.startswith(net + "/")), net


def test_render_cli_subsample_matches_jax(tmp_path):
    """render.py --subsample 0.5 --num_rays -1 on a PhySG checkpoint that
    exp_runner --subsample 0.5 trained (the PhySG render CLI test's setting),
    through both packages' CLIs: the same EXRs at that test's gates (atol
    1e-5, rtol 1e-4 on the shaded images)."""
    (tmp_path / "physg.conf").write_text(NO_PLOTS(PHYSG_TRAIN))
    scene = write_sphere_scene(str(tmp_path / "scene"), n_views=2, res=32)
    runner = exp_runner.main([
        "--conf", str(tmp_path / "physg.conf"), "--data_split_dir", scene, "--exps_folder_name",
        str(tmp_path / "exps"), "--max_niter", "1", "--subsample", "0.5", "--device", "cpu"])
    assert runner.train_dataset.img_res == [16, 16] and len(runner.step_stats) == 2
    argv = ["--conf", str(tmp_path / "physg.conf"), "--data_split_dir", scene, "--old_expdir",
            runner.expdir, "--timestamp", runner.timestamp, "--num_rays", "-1", "--max_views",
            "1", "--memory_capacity_level", "8", "--subsample", "0.5"]
    out = render.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jrender.main(argv + ["--out_dir", str(tmp_path / "jax"), "--no_auto_budget"])
    assert 0 < out.stats[0]["hit_fraction"] < 1 and out.stats[0]["rays"] == 16 * 16
    for name in ("rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo", "roughness",
                 "specular_reflection", "gt"):
        t = exr.read(str(tmp_path / "port" / f"{name}_000.exr"))
        j = exr.read(str(tmp_path / "jax" / f"{name}_000.exr"))
        assert t.shape == j.shape == (16, 16, 3), name
        shaded = name.endswith("_rgb")
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-4 if shaded else 0, err_msg=name)
