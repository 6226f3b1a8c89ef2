"""The port's offline tools and small utilities against the JAX package's,
on the same seeded inputs (CPU). The two tools that render through
RenderRunner are in test_torch_port_tools_render.py.

Gates:
  * converters, on datasets/synthetic.write_neus_scene's cameras_sphere.npz
    (tests/test_tools.py's layout): neus2physg (neus and netease sources)
    and neus2neus emit the same tree, byte for byte, and the same
    cam_dict_norm.json;
  * compute_psnr within 1e-10, with and without mask and tonemap;
  * envmap_tools: `constant` within atol 1e-6, `rotate` within 1e-6, the
    --preview PNG within 1 level;
  * fit_envmap_sg from a shared init: lobes and image loss after each of
    the first 5 steps, and the final loss, within rel 1e-5; the CLI's
    sg_<N>.npy and log_im_<N>.png from a pretrained init in its out_dir
    likewise (PNG within 1 level); and the
    convergence of tests/test_tools.py (32x64, 8 SGs, 800 steps, loss below
    0.01 of the map's variance) from that test's init, JAX's seed-0 draw: the
    port's own seed-0 draw (a torch.Generator) is another start, from which
    800 steps do not get there, as they do not from JAX's seeds 1, 2 and 4;
  * the samplers' sequences equal; colormap("jet") within 1e-6 of
    matplotlib's on a ramp with both ends, with_colorbar equal; rename_suffix
    the same operations and files; debug_helper the same records for values
    and gradients (rel 1e-6) and none while off;
  * the LPIPS export: with a source, the .npz equal to the JAX package's
    export of the same random state dict; without one and without the
    `lpips` package, exit code 2 as in JAX.
"""

import json
import os
import subprocess
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from nefii_tpu.ops import sg as jsg
from nefii_tpu.scripts import compute_psnr as jcompute_psnr
from nefii_tpu.scripts import converters as jconverters
from nefii_tpu.scripts import envmap_tools as jenvmap_tools
from nefii_tpu.scripts import fit_envmap_with_sg as jfit
from nefii_tpu.utils import debug_helper as jdebug
from nefii_tpu.utils import lpips_jax
from nefii_tpu.utils import rename as jrename
from nefii_tpu.utils import sampler as jsampler
from nefii_tpu.utils import vis_util as jvis_util
from nefii_tpu_torch.datasets.synthetic import write_neus_scene
from nefii_tpu_torch.scripts import compute_psnr, converters, envmap_tools
from nefii_tpu_torch.scripts import fit_envmap_with_sg as fit
from nefii_tpu_torch.utils import debug_helper, exr, lpips, rename, sampler, vis_util
from nefii_tpu_torch.utils.png import read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(d):
    """{relative path: bytes} of every file under d."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _png_close(a_path, b_path):
    a = read_png(a_path).astype(int)
    b = np.asarray(imageio.imread(b_path)).astype(int)
    assert a.shape == b.shape, (a_path, a.shape, b.shape)
    assert np.abs(a - b).max() <= 1, (a_path, np.abs(a - b).max())


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd,src_type", [("neus2physg", "neus"), ("neus2physg", "netease"),
                                          ("neus2neus", None)])
def test_converters_match_jax(tmp_path, cmd, src_type):
    src = write_neus_scene(str(tmp_path / "undist"), netease=src_type == "netease")
    extra = [src_type] if src_type else []
    converters.main([cmd, src, str(tmp_path / "port")] + extra)
    jconverters.main([cmd, src, str(tmp_path / "jax")] + extra)
    port, ref = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert port.keys() == ref.keys() and port
    for k in ref:
        assert port[k] == ref[k], k
    if cmd == "neus2physg":
        cams = json.loads(port[os.path.join("train", "cam_dict_norm.json")])
        assert len(cams) == 2
        assert cams == json.loads(ref[os.path.join("test", "cam_dict_norm.json")])


# ---------------------------------------------------------------------------
# compute_psnr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("tonemap", [False, True])
def test_compute_psnr_matches_jax(tmp_path, with_mask, tonemap):
    rs = np.random.RandomState(1)
    gt = rs.uniform(0, 2, (24, 32, 3)).astype(np.float32)
    pred = (gt + rs.normal(0, 0.05, gt.shape)).astype(np.float32)
    exr.write(str(tmp_path / "pred.exr"), pred)
    exr.write(str(tmp_path / "gt.exr"), gt)
    mask = None
    if with_mask:
        mask = str(tmp_path / "mask.png")
        write_png(mask, ((rs.uniform(0, 1, (24, 32)) > 0.4) * 255).astype(np.uint8))
    args = (str(tmp_path / "pred.exr"), str(tmp_path / "gt.exr"), mask, tonemap)
    got, want = compute_psnr.compute_psnr(*args), jcompute_psnr.compute_psnr(*args)
    assert np.isfinite(got) and abs(got - want) <= 1e-10


# ---------------------------------------------------------------------------
# envmap tools
# ---------------------------------------------------------------------------

def test_envmap_constant_matches_jax(tmp_path):
    env = np.random.RandomState(2).uniform(0, 5, (40, 80, 3)).astype(np.float32)
    exr.write(str(tmp_path / "env.exr"), env)
    envmap_tools.main(["constant", "--envmap", str(tmp_path / "env.exr"), "--size", "16",
                       "--out", str(tmp_path / "port.npy")])
    jenvmap_tools.main(["constant", "--envmap", str(tmp_path / "env.exr"), "--size", "16",
                        "--out", str(tmp_path / "jax.npy")])
    got, want = np.load(str(tmp_path / "port.npy")), np.load(str(tmp_path / "jax.npy"))
    assert got.shape == want.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_envmap_rotate_and_preview_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    lgt = rs.randn(16, 7).astype(np.float32)
    lgt[:, 3] = np.abs(lgt[:, 3]) * 20
    np.save(str(tmp_path / "sg.npy"), lgt)
    argv = ["rotate", "--sg", str(tmp_path / "sg.npy"), "--euler", "yxz", "--degrees", "30",
            "-20", "10", "--preview"]
    envmap_tools.main(argv + ["--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    jenvmap_tools.main(argv + ["--out", str(tmp_path / "jax.npy")])
    np.testing.assert_allclose(np.load(str(tmp_path / "port.npy")),
                               np.load(str(tmp_path / "jax.npy")), rtol=0, atol=1e-6)
    _png_close(str(tmp_path / "port_envmap.png"), str(tmp_path / "jax_envmap.png"))


# ---------------------------------------------------------------------------
# fit_envmap_with_sg
# ---------------------------------------------------------------------------

GT_SGS = np.array([[0, 1, 0, 10, 2, 1, 0.5], [1, 0, 0, 6, 0.5, 1, 1],
                   [0, 0, 1, 8, 1, 0.2, 0.2], [0, -1, 0, 5, 0.3, 0.3, 0.9]], np.float32)


def _gt_env(H=32, W=64):
    return np.asarray(jsg.compute_envmap(jnp.asarray(GT_SGS), H, W))


def _jax_init(seed=0, n=8):
    init = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, 7)))
    init[:, 3:4] *= 100.0
    return init


def _fit_steps(mod, monkeypatch, gt, init, n):
    """fit_envmap_sg for n steps, logging every step: -> ([(lobes, image)]
    after each step, as _save_progress receives them), the final loss."""
    steps = []
    monkeypatch.setattr(mod, "_save_progress", lambda lgt, env, *a: steps.append((lgt, env)))
    kw = {"device": "cpu"} if mod is fit else {}
    _, loss = mod.fit_envmap_sg(gt, 8, "mitsuba", n, 5e-2, init=init, log_every=1,
                                out_dir="unused", **kw)
    return steps, loss


def test_fit_envmap_sg_steps_match_jax(monkeypatch):
    gt, init = _gt_env(), _jax_init()
    got, loss = _fit_steps(fit, monkeypatch, gt, init, 5)
    want, jloss = _fit_steps(jfit, monkeypatch, gt, init, 5)
    assert len(got) == len(want) == 5
    for k, ((lgt, env), (jlgt, jenv)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lgt, jlgt, rtol=1e-5, atol=1e-5 * np.abs(jlgt).max(),
                                   err_msg=f"step {k}")
        mse, jmse = np.mean((env - gt) ** 2), np.mean((jenv - gt) ** 2)
        assert abs(mse - jmse) <= 1e-5 * jmse, (k, mse, jmse)
    assert abs(loss - jloss) <= 1e-5 * jloss, (loss, jloss)


def test_fit_envmap_sg_converges_from_the_jax_test_init():
    gt = _gt_env()
    lgt, loss = fit.fit_envmap_sg(gt, num_sgs=8, n_iter=800, lr=5e-2, init=_jax_init(0),
                                  device="cpu")
    assert loss < 0.01 * gt.var(), loss


def test_fit_envmap_sg_own_init_is_seeded():
    gt = _gt_env(8, 16)
    a, la = fit.fit_envmap_sg(gt, num_sgs=4, n_iter=0, seed=5, device="cpu")
    b, _ = fit.fit_envmap_sg(gt, num_sgs=4, n_iter=0, seed=5, device="cpu")
    normal = torch.randn((4, 7), generator=torch.Generator().manual_seed(5)).numpy()
    normal[:, 3] *= 100.0
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, normal)
    _, l3 = fit.fit_envmap_sg(gt, num_sgs=4, n_iter=3, seed=5, device="cpu")
    assert l3 < la


def test_fit_envmap_cli_matches_jax(tmp_path):
    """Both CLIs from the same pretrained sg_8.npy in their out_dir, with
    --resize to 16x32 (area): the saved lobes and the preview PNG."""
    env = np.abs(np.random.RandomState(4).normal(0, 1, (40, 80, 3))).astype(np.float32)
    exr.write(str(tmp_path / "env.exr"), env)
    for tag in ("port", "jax"):
        os.makedirs(tmp_path / tag)
        np.save(str(tmp_path / tag / "sg_8.npy"), _jax_init(1))
    argv = ["--envmap", str(tmp_path / "env.exr"), "--num_sgs", "8", "--n_iter", "3",
            "--lr", "5e-2", "--resize", "16", "32"]
    fit.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jfit.main(argv + ["--out_dir", str(tmp_path / "jax")])
    want = np.load(str(tmp_path / "jax" / "sg_8.npy"))
    np.testing.assert_allclose(np.load(str(tmp_path / "port" / "sg_8.npy")), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _png_close(str(tmp_path / "port" / "log_im_8.png"), str(tmp_path / "jax" / "log_im_8.png"))


# ---------------------------------------------------------------------------
# samplers, vis_util, rename, debug_helper
# ---------------------------------------------------------------------------

def test_samplers_match_jax():
    assert list(sampler.SamplerGivenSeq([3, 1, 2])) == list(jsampler.SamplerGivenSeq([3, 1, 2]))
    ds = list(range(20))
    a, b = sampler.SamplerRandomChoice(ds, 5, seed=3), jsampler.SamplerRandomChoice(ds, 5, seed=3)
    for epoch in range(3):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b) and len(a) == len(b) == 5
    assert list(sampler.SamplerFixIndex(4, 2)) == list(jsampler.SamplerFixIndex(4, 2))


def test_colormap_matches_matplotlib_and_jax():
    ramp = np.concatenate([np.linspace(0, 1, 4097), [0.0, 1.0, 1 / 256, 255 / 256]])
    got = vis_util.colormap(ramp.astype(np.float32))
    want = np.asarray(matplotlib.colormaps["jet"](ramp.astype(np.float32)))[..., :3]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jvis_util.colormap(ramp), rtol=0, atol=1e-6)
    # another map goes through matplotlib, as in JAX
    np.testing.assert_allclose(vis_util.colormap(ramp, "viridis"),
                               jvis_util.colormap(ramp, "viridis"), rtol=0, atol=1e-6)
    img = np.random.RandomState(5).uniform(0, 1, (12, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(vis_util.with_colorbar(img, None),
                                  jvis_util.with_colorbar(img, None))


@pytest.mark.parametrize("apply", [False, True])
def test_rename_suffix_matches_jax(tmp_path, apply):
    names = ["000123_sp_rgb.01.exr", "000124_sp_rgb.00.exr", "a.b", "x.y.z.png", "plain"]
    for tag in ("port", "jax"):
        os.makedirs(tmp_path / tag)
        for n in names:
            (tmp_path / tag / n).write_text(n)
    ops = rename.rename_suffix(str(tmp_path / "port"), "00", apply)
    assert ops == jrename.rename_suffix(str(tmp_path / "jax"), "00", apply) and ops
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))


def test_debug_helper_records_match_jax():
    rs = np.random.RandomState(6)
    x = rs.normal(0, 1, (5, 3)).astype(np.float32)
    w = rs.normal(0, 1, (5, 3)).astype(np.float32)
    x_nan = x.copy()
    x_nan[1, 1] = np.nan

    def run(mod, to, watch_grad):
        mod.clear()
        mod.watch_value(to(x), "x")
        mod.watch_value(to(x_nan), "x_nan")
        watch_grad(mod)
        return mod.get_records()

    def port_grad(mod):
        t = torch.tensor(x, requires_grad=True)
        (mod.watch_gradient(t * 2.0, "y") ** 2 * torch.tensor(w)).sum().backward()

    def jax_grad(mod):
        jax.grad(lambda v: (mod.watch_gradient(v * 2.0, "y") ** 2 * w).sum())(jnp.asarray(x))
        jax.effects_barrier()

    for mod in (debug_helper, jdebug):
        mod.set_debug(False)
    assert run(debug_helper, torch.tensor, port_grad) == {}
    try:
        for mod in (debug_helper, jdebug):
            mod.set_debug(True)
        got = run(debug_helper, torch.tensor, port_grad)
        want = run(jdebug, jnp.asarray, jax_grad)
    finally:
        for mod in (debug_helper, jdebug):
            mod.set_debug(False)
            mod.clear()
    assert set(got) == set(want) == {"x/value", "x_nan/value", "y/grad"}
    for k in want:
        assert got[k]["has_nan"] == want[k]["has_nan"], k
        for stat in ("mean", "absmax"):
            np.testing.assert_allclose(got[k][stat], want[k][stat], rtol=1e-6, err_msg=k)
    assert debug_helper.watch_gradiant is debug_helper.watch_gradient


# ---------------------------------------------------------------------------
# the LPIPS export
# ---------------------------------------------------------------------------

def _random_lpips_torch_state(rs):
    """Random weights in the lpips.LPIPS(net='alex') state-dict layout."""
    tv_idx = (0, 3, 6, 8, 10)
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
              (256, 256, 3, 3)]
    state = {}
    for i, (tv, shp) in enumerate(zip(tv_idx, shapes)):
        state[f"net.slice{i + 1}.{tv}.weight"] = torch.tensor(
            rs.randn(*shp).astype(np.float32) * 0.05)
        state[f"net.slice{i + 1}.{tv}.bias"] = torch.tensor(rs.randn(shp[0]).astype(np.float32))
        state[f"lin{i}.model.1.weight"] = torch.tensor(
            np.abs(rs.randn(1, shp[0], 1, 1)).astype(np.float32))
    return state


def test_lpips_export_matches_jax(tmp_path):
    src = tmp_path / "lpips_full.pth"
    torch.save(_random_lpips_torch_state(np.random.RandomState(7)), str(src))
    r = subprocess.run([sys.executable, "-m", "nefii_tpu_torch.utils.lpips",
                        "--export-from-torch", str(tmp_path / "port.npz"), str(src)],
                       capture_output=True, text=True, cwd=ROOT, timeout=30)
    assert r.returncode == 0, r.stderr
    assert lpips_jax._export_main(["--export-from-torch", str(tmp_path / "jax.npz"),
                                   str(src)]) == 0
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 15
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lpips_export_without_the_package_exits_2(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "lpips", None)  # `import lpips` raises ImportError
    out = tmp_path / "w.npz"
    assert lpips._export_main(["--export-from-torch", str(out)]) == 2
    port = capsys.readouterr().out
    assert lpips_jax._export_main(["--export-from-torch", str(out)]) == 2
    assert port == capsys.readouterr().out and "pip install lpips" in port
    assert not out.exists()
