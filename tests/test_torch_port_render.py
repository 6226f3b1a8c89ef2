"""The port's render CLI on the CPU, and the port's independence from JAX.

render.main renders a 2-view 8x8 cam_dict_norm.json-only split from a
checkpoint that the JAX package wrote (checkpoints.save_collection), and must
write the seven EXRs per view, the stacked PNG and envmap.exr, all finite."""

import ast
import os
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np

from nefii_tpu.config import parse_string
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils import exr
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.scripts import profile_render, render

from test_idr_forward import SMALL_CONF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = """train {
    expname = port_render
    dataset_class = datasets.scene_dataset.SceneDataset
    model_class = model.implicit_differentiable_renderer.IDRNetwork
}
""" + SMALL_CONF.replace("render_type = pt_render_indirect_mlp",
                         "render_type = pt_render_indirect_mlp\n    use_fused_sdf = True")
EXRS = ("gt", "rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo", "roughness",
        "specular_reflection")


def _read_png(path):
    """Decode an 8-bit RGB PNG without filters (what utils/png.py writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, W, H = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            W, H = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(H, W, 3)


def test_render_cli_writes_finite_outputs(tmp_path):
    conf_path = tmp_path / "render.conf"
    conf_path.write_text(CONF)
    conf = parse_string(CONF)
    jmodel = JIDR.from_conf(conf.get_config("model"))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    exp = tmp_path / "exps" / "port_render"
    jck.save_collection(str(exp / "2026_01_01" / "checkpoints"), jck.MODEL, "latest", params,
                        {"epoch": 1})
    scene = SceneDataset.write_camera_only_split(str(tmp_path / "scene"), 2, 8, focal=10.0)
    out_dir = tmp_path / "renders"

    runner = render.main([
        "--conf", str(conf_path), "--data_split_dir", scene, "--old_expdir", str(exp),
        "--num_rays", "4", "--device", "cpu", "--out_dir", str(out_dir),
        "--memory_capacity_level", "6", "--no_auto_budget",
    ])
    assert runner.dataset.img_res == [8, 8] and len(runner.stats) == 2
    for i in range(2):
        for name in EXRS:
            img = exr.read(str(out_dir / f"{name}_{i:03d}.exr"))
            assert img.shape[:2] == (8, 8) and np.isfinite(img).all(), name
        png = _read_png(str(out_dir / f"render_{i:03d}.png"))
        assert png.shape == (8, 8 * 6, 3)
        s = runner.stats[i]
        assert 0 < s["hit_fraction"] < 1 and s["sdf_evals"] > 0 and s["rays"] == 8 * 8 * 4
    env = exr.read(str(out_dir / "envmap.exr"))
    assert env.shape[:2] == (256, 512) and np.isfinite(env).all() and env.max() > 0
    # the loaded weights are the JAX checkpoint's
    np.testing.assert_array_equal(
        runner.model.envmap_material_network.lgtSGs.detach().numpy(),
        np.asarray(params["envmap_material_network"]["lgtSGs"]))


def test_profile_render_script_profiles_three_views(tmp_path):
    """scripts/profile_render.py on a small conf: a warm-up view, then three
    views under the profiler, its summary and trace written."""
    conf_path = tmp_path / "render.conf"
    conf_path.write_text(CONF)
    summary = profile_render.main([
        "--conf", str(conf_path), "--out", str(tmp_path / "prof"), "--res", "8",
        "--num_rays", "2", "--memory_capacity_level", "6", "--device", "cpu"])
    assert summary["card"] == "" and len(summary["s_per_view"]) == 3
    assert all(n > 0 for n in summary["sdf_evals"])
    assert all(0 < h < 1 for h in summary["hit_fraction"])
    text = (tmp_path / "prof" / "summary.txt").read_text()
    assert text.startswith("3 steps:") and "span primary_trace" in text
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_port_imports_without_jax():
    """Every module of nefii_tpu_torch, and chip_smoke.py, imports with JAX
    and the JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nefii_tpu'] = None\n"
        "import nefii_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(nefii_tpu_torch.__path__,"
        " 'nefii_tpu_torch.')] + ['chip_smoke']\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert sys.modules['jax'] is None and sys.modules['nefii_tpu'] is None\n"
        "assert not [m for m in sys.modules if m.startswith(('jax.', 'nefii_tpu.'))"
        " or m == 'jaxlib']\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


def _imported_modules(path):
    """Every module an `import` or `from ... import` statement of the file names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_jax_or_the_jax_package():
    """An AST scan of the port's sources and chip_smoke.py, which also sees
    the imports inside functions that importing a module does not run."""
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "nefii_tpu_torch"))
        for f in fs if f.endswith(".py")]
    assert len(files) >= 25
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "nefii_tpu")]
    assert not bad, bad
