#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nefii_tpu_torch) on one GPU.

Phases, each of which raises on failure (exit code != 0):

1. device: require CUDA; print `nvidia-smi --query-gpu=name,power.limit`.
2. build: compile the fused SDF-MLP kernels from csrc/ with nvcc.
3. kernels: on the full-width confs/conf.conf SDF net (8x512, skip at 4,
   multires 6), run K1 (fp32 and bf16) and K2 (fp32) at 262,144 points and
   hold each against its plain PyTorch version on the same inputs, in the
   working type; time both with CUDA events.
4. reference: a 16x16-ray render of confs/conf.conf (trace switched to fp32)
   through the kernels on the card against the same render through the plain
   versions on the CPU, on what no Monte-Carlo sample touches (hit mask,
   points, normals, IDR radiance, albedo, roughness).
5. render: build confs/conf.conf unchanged with the port's seeded geometric
   init, save the checkpoint in the JAX package's .npz layout, and render two
   128x128 views with 16 rays per pixel through
   nefii_tpu_torch.scripts.render.main. Checks finite outputs, a hit fraction
   above 0 and that both kernels were launched by the render.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 262_144
# tolerances of kernel vs plain version, in the working type:
#  fp32: the two differ only in summation order (FMA chain vs cuBLAS), ~1e-6
#        relative per layer over 8 layers of 512-long dot products
#  bf16: h is rounded to bf16 after every layer; an order difference can flip
#        one rounding (2^-8 relative) and it propagates: the JAX package's
#        bf16 bound of 1e-2 relative (fused_mlp.py:177-179)
TOL = {"fp32_abs": 1e-4, "bf16_rel": 1e-2, "grad_rel": 1e-3}


def _sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = _sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from nefii_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load("fused_mlp")
    print(f"[build] fused_mlp in {time.perf_counter() - t0:.2f} s", flush=True)
    log = build.BUILD_LOG.get("fused_mlp", "")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[build]", line.strip(), flush=True)


def _flagship_net(device):
    import torch

    from nefii_tpu.config import ConfigFactory
    from nefii_tpu_torch.models.implicit import ImplicitNetwork

    conf = ConfigFactory.parse_file(os.path.join(ROOT, "confs", "conf.conf")).get_config("model")
    net = ImplicitNetwork(feature_vector_size=conf.get_int("feature_vector_size"),
                          device=device, **conf.get_config("implicit_network").as_plain_dict())
    net.reset_parameters(torch.Generator(device=device).manual_seed(0))
    return net


def _time(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels():
    import torch

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm

    dev = torch.device("cuda", 0)
    net = _flagship_net(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    pts = torch.randn(N_POINTS, 3, generator=gen, device=dev) * 0.5
    res = {}
    with torch.no_grad():
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            fw = fm.prepare_weights(net, dtype)
            x = fm.embed_padded(pts, fw)
            h = fm.fused_hidden(x, fw)
            torch.cuda.synchronize()
            ref = fm.fused_hidden_plain(x, fw)
            torch.cuda.synchronize()
            err = (h.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            sdf = fm.build_fused_sdf(net, dtype)(pts)
            torch.cuda.synchronize()
            ok = (err <= TOL["fp32_abs"]) if name == "fp32" else (err <= TOL["bf16_rel"] * scale)
            ms = _time(lambda: fm.fused_hidden(x, fw))
            plain_ms = _time(lambda: fm.fused_hidden_plain(x, fw))
            print(f"[kernels] K1 {name}: N={N_POINTS} max_abs_err={err:.3e} (max|h|={scale:.3e}) "
                  f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms finite_sdf="
                  f"{bool(torch.isfinite(sdf).all())}", flush=True)
            if not ok or not bool(torch.isfinite(h.float()).all()):
                raise RuntimeError(f"K1 {name} disagrees with its plain version: {err:.3e}")
            res[f"k1_{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

        fw = fm.prepare_weights(net, torch.float32)
        x = fm.embed_padded(pts, fw)
        h, dx = fm.fused_fwd_bwd(x, fw)
        torch.cuda.synchronize()
        h_ref, dx_ref = fm.fused_fwd_bwd_plain(x, fw)
        torch.cuda.synchronize()
        err_h = (h - h_ref).abs().max().item()
        err_dx = (dx - dx_ref).abs().max().item()
        dx_scale = dx_ref.abs().max().item()
        ms = _time(lambda: fm.fused_fwd_bwd(x, fw))
        plain_ms = _time(lambda: fm.fused_fwd_bwd_plain(x, fw))
        print(f"[kernels] K2 fp32: N={N_POINTS} h max_abs_err={err_h:.3e} dx max_abs_err="
              f"{err_dx:.3e} (max|dx|={dx_scale:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms",
              flush=True)
        if err_h > TOL["fp32_abs"] or err_dx > TOL["grad_rel"] * dx_scale:
            raise RuntimeError(f"K2 disagrees with its plain version: h {err_h:.3e} dx {err_dx:.3e}")
        res["k2"] = dict(max_abs_err=max(err_h, err_dx), ms=ms, plain_ms=plain_ms)
    return res


REF_RES = 16
# port on the card (K1 fp32 + K2) vs the port on the CPU (plain versions), on
# the quantities no Monte-Carlo sample touches; both fp32, so they differ by
# summation order, which the tracer's 5e-5 stopping threshold can amplify
REF_TOL = {"mask_agree": 0.99, "abs": 1e-3}
REF_KEYS = ("points", "normal_values", "idr_rgb_values", "sg_diffuse_albedo_values",
            "sg_roughness_values")


def phase_reference():
    """A small render through the kernels on the card against the same render
    through the plain versions on the CPU (fp32 trace on both sides)."""
    import numpy as np
    import torch

    from nefii_tpu.config import parse_string
    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.models.idr import IDRNetwork

    with open(os.path.join(ROOT, "confs", "conf.conf")) as f:
        text = f.read()
    if "fused_sdf_dtype = bfloat16" not in text:
        raise RuntimeError("confs/conf.conf no longer sets fused_sdf_dtype = bfloat16")
    mconf = parse_string(text.replace("fused_sdf_dtype = bfloat16",
                                      "fused_sdf_dtype = float32")).get_config("model")
    gpu = IDRNetwork.from_conf(mconf, device="cuda", seed=0)
    cpu = IDRNetwork.from_conf(mconf, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    with tempfile.TemporaryDirectory() as d:
        ds = SceneDataset(1.0, SceneDataset.write_camera_only_split(d, 1, REF_RES, focal=20.0),
                          False)
        _, inp, _ = ds.collate([ds[0]])
    outs = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in inp.items()}
        out = model.forward_with_uv(batch, torch.Generator(device=dev).manual_seed(0))
        outs.append({k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)})
    g, c = outs
    agree = float((g["network_object_mask"] == c["network_object_mask"]).mean())
    both = g["network_object_mask"] & c["network_object_mask"]
    errs = {k: float(np.abs(g[k][both] - c[k][both]).max()) for k in REF_KEYS}
    print(f"[reference] {REF_RES}x{REF_RES} rays, kernels on cuda vs plain on cpu: mask "
          f"agreement {agree:.4f}, hits {int(both.sum())}, max abs err {errs}", flush=True)
    if agree < REF_TOL["mask_agree"] or not both.any():
        raise RuntimeError(f"hit masks disagree: {agree:.4f}")
    bad = {k: v for k, v in errs.items() if not v <= REF_TOL["abs"]}
    if bad:
        raise RuntimeError(f"kernel render disagrees with the plain render: {bad}")
    for k in ("sg_rgb_values", "sg_diffuse_rgb_values", "sg_specular_rgb_values"):
        if not np.isfinite(g[k]).all():
            raise RuntimeError(f"{k} is not finite")
    return dict(mask_agreement=agree, max_abs_err=errs)


RENDER_RES = 128
RENDER_VIEWS = 2
RENDER_RAYS = 16
EXR_NAMES = ("gt", "rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo", "roughness",
             "specular_reflection")


def phase_render(card):
    """Render RENDER_VIEWS views of the full-width conf through the port's CLI."""
    import numpy as np
    import torch

    from nefii_tpu.config import ConfigFactory
    from nefii_tpu.utils import exr
    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.scripts import render
    from nefii_tpu_torch.utils import checkpoints as ckpt

    conf_path = os.path.join(ROOT, "confs", "conf.conf")
    with tempfile.TemporaryDirectory() as d:
        # seeded geometric init: a sphere of radius ~0.6 (implicit_network.bias)
        model = IDRNetwork.from_conf(
            ConfigFactory.parse_file(conf_path).get_config("model"), device="cuda", seed=0)
        ckpt.save_collection(os.path.join(d, "exp", "seed0", "checkpoints"), ckpt.MODEL,
                             "latest", ckpt.params_to_jax(model), {"epoch": 0})
        del model
        scene = SceneDataset.write_camera_only_split(
            os.path.join(d, "scene"), RENDER_VIEWS, RENDER_RES, focal=160.0)
        out_dir = os.path.join(d, "renders")
        argv = ["--conf", conf_path, "--data_split_dir", scene,
                "--old_expdir", os.path.join(d, "exp"), "--num_rays", str(RENDER_RAYS),
                "--max_views", str(RENDER_VIEWS), "--out_dir", out_dir, "--device", "cuda"]

        fm.reset_launch_counts()
        runner = render.main(argv)
        torch.cuda.synchronize()
        launches = dict(fm.LAUNCHES)

        for i in range(RENDER_VIEWS):
            for name in EXR_NAMES:
                img = exr.read(os.path.join(out_dir, f"{name}_{i:03d}.exr"))
                if img.shape[:2] != (RENDER_RES, RENDER_RES) or not np.isfinite(img).all():
                    raise RuntimeError(f"{name}_{i:03d}.exr: shape {img.shape} or non-finite")
            if not os.path.getsize(os.path.join(out_dir, f"render_{i:03d}.png")):
                raise RuntimeError(f"render_{i:03d}.png is empty")
        env = exr.read(os.path.join(out_dir, "envmap.exr"))
        if not np.isfinite(env).all() or env.max() <= 0:
            raise RuntimeError("envmap.exr is not finite and positive")
    stats = runner.stats
    for s in stats:
        print(f"[render] view {s['view']}: {s['seconds']:.3f} s/view, "
              f"{s['pixels'] / s['seconds']:.1f} px/s, {s['sdf_evals'] / s['seconds']:.4g} "
              f"SDF evals/s ({s['sdf_evals']} evals, {RENDER_RES}x{RENDER_RES}, "
              f"{RENDER_RAYS} rays/px), hit fraction {s['hit_fraction']:.3f} [{card}]",
              flush=True)
        if not s["hit_fraction"] > 0:
            raise RuntimeError(f"view {s['view']}: no ray hit the surface")
    print(f"[render] kernel launches during the render: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the render did not launch kernel {name}")
    return launches, stats


def main():
    import torch

    card = phase_device()
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kern = phase_kernels()
    ref = phase_reference()
    launches, stats = phase_render(card)
    print(json.dumps({"render": stats, "reference": ref, "card": card}), flush=True)
    src = "nefii_tpu_torch/ops/kernels/csrc/fused_mlp.cu"
    records = [
        dict(name="fused_sdf_hidden", route="cuda", source=src,
             replaces="nefii_tpu/ops/pallas/fused_mlp.py:136",
             launches=launches["fused_sdf_hidden"], dtype="bfloat16",
             **kern["k1_bf16"], fp32=kern["k1_fp32"]),
        dict(name="fused_sdf_fwd_bwd", route="cuda", source=src,
             replaces="nefii_tpu/ops/pallas/fused_mlp.py:240",
             launches=launches["fused_sdf_fwd_bwd"], dtype="float32", **kern["k2"]),
    ]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
