#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nefii_tpu_torch) on one GPU.

Phases, each of which raises on failure (exit code != 0):

1. device: require CUDA; print `nvidia-smi --query-gpu=name,power.limit`.
2. build: compile the kernel sources of csrc/ with nvcc, one process each,
   all started together.
3. kernels: on the full-width confs/conf.conf SDF net (8x512, skip at 4,
   multires 6), run K1 fp32 (FMA pipe), K1 bf16 on the tensor cores (both
   entries: the hidden state, and the sdf of fused_sdf_value) and K2 (fp32
   accuracy on the tensor cores in split bf16) at 262,144 points, the
   tensor-core kernels also at 1, 63, 64, 65 and 5000 points, and hold each
   against its plain PyTorch version on the same inputs, in the working type
   (K2 also against its split-bf16 plain version, to tell the scheme's error
   from the kernel's); time them with CUDA events, the fp32 FMA K1 beside
   the tensor-core one, and print the tensor-core kernels' TFLOP/s and the
   L2 weight bytes a call requests by their design (computed, not measured).
4. trace-kernel: K3, the whole sphere trace (split fp16 on the tensor cores
   over a pool of live rays), on 262,144 rays of one 512x512 view of the
   seeded-init sphere (camera rays and random pixels in random order under
   the primary tracer, the random pixels under the secondary tracer) against
   its fp32 plain version (and its split-fp16 plain version, to tell the
   scheme's error from the kernel's); the port's gathered tracer through K1
   fp32 is timed beside them, and its count of the evaluations the rays need
   gives K3's bounds and must match the kernel's count. Prints the tiles'
   fill.
5. reference: a 16x16-ray render of confs/conf.conf (trace switched to fp32)
   through the kernels on the card against the same render through the plain
   versions on the CPU, on what no Monte-Carlo sample touches (hit mask,
   points, normals, IDR radiance, albedo, roughness).
6. train-reference: one frozen-geometry training step of confs/conf.conf
   (fp32, K3 on) on 64 pixels x 4 rays through the kernels on the card
   against the plain versions on the CPU, with injected directions and
   min-SDF vector: the loss and each parameter group's gradient. For each K3
   call of the step, the rays on which the kernel decides otherwise than
   the fp32 plain version on the same rays, and whether the split-fp16
   plain version decides as the kernel does.
7. render: build confs/conf.conf unchanged with the port's seeded geometric
   init, save the checkpoint in the JAX package's .npz layout, and render two
   128x128 views with 16 rays per pixel through
   nefii_tpu_torch.scripts.render.main. Checks finite outputs, a hit fraction
   above 0 and that the render launched the tensor-core K1 (its sdf entry)
   and K2.
8. train: Step-2 training of confs/conf.conf with use_fused_trace at full
   width (2048 px x 64 rays a step) through
   nefii_tpu_torch.training.exp_runner.main, four steps on a synthetic 4-view
   128x128 sphere scene from a checkpoint of the seeded geometry, a secondary
   distillation step after each. Checks finite losses, a frozen geometry,
   trained rendering and material nets, a checkpoint the render CLI reads,
   and launches of the tensor-core K1 (its sdf entry), K2 and K3; prints
   s/step, rays/s, the distillation step and peak memory.

The line before the last is the kernels' JSON record (launches from the
training run); the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py

Profiling the training steps is nefii_tpu_torch/scripts/profile_train.py.
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
#        relative per layer over 8 layers of 512-long dot products; K2's
#        split bf16 drops ~2^-16 of each product, ~1e-5 over the chain
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
    build.build_all()  # one nvcc per source, all started together
    for name in build.SOURCES:
        build.load(name)
    print(f"[build] {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in build.SOURCES:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"[build] {name}:", line.strip(), flush=True)


# text replacements of confs/conf.conf
K3_ON = ("use_fused_sdf = True", "use_fused_sdf = True\n    use_fused_trace = True")
FP32_TRACE = ("fused_sdf_dtype = bfloat16", "fused_sdf_dtype = float32")


def _conf_text(replace=()):
    """confs/conf.conf with the (old, new) replacements; raises if an old
    text is no longer there."""
    with open(os.path.join(ROOT, "confs", "conf.conf")) as f:
        text = f.read()
    for old, new in replace:
        if old not in text:
            raise RuntimeError(f"confs/conf.conf no longer holds {old!r}")
        text = text.replace(old, new, 1)
    return text


def _model_conf(replace=()):
    from nefii_tpu_torch.config import parse_string

    return parse_string(_conf_text(replace))


def _flagship_net(device):
    import torch

    from nefii_tpu_torch.models.implicit import ImplicitNetwork

    conf = _model_conf().get_config("model")
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


# H100 SXM published peaks (dense): FP32 outside the tensor cores, bf16 tensor
# cores, HBM3 bandwidth. A kernel's bound is the larger of its operations over
# the peak of their type and the bytes it must move over the memory rate.
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def _bound(flops, nbytes, kind):
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _chain_flops(net):
    """Multiply-add operations per point of the SDF net's hidden chain (real,
    unpadded widths), and of its sdf column."""
    hidden = sum(2 * L.d_in * L.d_out for L in net.layers[:-1])
    return hidden, 2 * net.layers[-1].d_in


RAGGED = (1, 63, 64, 65, 5000)


def _check_bf16(name, got, ref):
    """max |got - ref| and max |ref|; raises unless within TOL['bf16_rel'] of
    the largest value and finite."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= TOL["bf16_rel"] * scale or not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError(f"{name} disagrees with its plain version: {err:.3e} "
                           f"(max {scale:.3e})")
    return err, scale


def phase_kernels():
    import torch

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm

    dev = torch.device("cuda", 0)
    net = _flagship_net(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    pts = torch.randn(N_POINTS, 3, generator=gen, device=dev) * 0.5
    hidden_flops, col_flops = _chain_flops(net)
    res = {}
    with torch.no_grad():
        # K1 fp32, the FMA pipe
        fw = fm.prepare_weights(net, torch.float32)
        x = fm.embed_padded(pts, fw)
        h = fm.fused_hidden(x, fw)
        torch.cuda.synchronize()
        ref = fm.fused_hidden_plain(x, fw)
        torch.cuda.synchronize()
        err = (h - ref).abs().max().item()
        ms = _time(lambda: fm.fused_hidden(x, fw))
        plain_ms = _time(lambda: fm.fused_hidden_plain(x, fw))
        bound = _bound(N_POINTS * hidden_flops,
                       N_POINTS * (fw.emb_dim + fw.real_width) * 4 + fw.buf.numel() * 4, "fp32")
        print(f"[kernels] K1 fp32 (FMA): N={N_POINTS} max_abs_err={err:.3e} kernel {ms:.3f} ms "
              f"plain {plain_ms:.3f} ms bound {bound['bound_ms']:.3f} ms ({bound['bound_by']})",
              flush=True)
        if not err <= TOL["fp32_abs"] or not bool(torch.isfinite(h).all()):
            raise RuntimeError(f"K1 fp32 disagrees with its plain version: {err:.3e}")
        res["k1_fp32"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)

        # K1 bf16 on the tensor cores: the hidden entry and the sdf entry
        fw = fm.prepare_weights(net, torch.bfloat16)
        errs_h, errs_s = [], []
        for n in RAGGED + (N_POINTS,):
            x = fm.embed_padded(pts[:n], fw)
            h = fm.fused_hidden(x, fw)
            sdf = fm.fused_sdf_value(x, fw)
            torch.cuda.synchronize()
            eh, sh = _check_bf16(f"K1 bf16 (tensor cores) at N={n}", h,
                                 fm.fused_hidden_plain(x, fw))
            es, ss = _check_bf16(f"fused_sdf_value at N={n}", sdf, fm.fused_sdf_value_plain(x, fw))
            errs_h.append(eh)
            errs_s.append(es)
            print(f"[kernels] K1 bf16 (tensor cores) N={n}: hidden max_abs_err={eh:.3e} "
                  f"(max|h|={sh:.3e}); fused_sdf_value max_abs_err={es:.3e} (max|sdf|={ss:.3e})",
                  flush=True)
        x = fm.embed_padded(pts, fw)
        ms_h = _time(lambda: fm.fused_hidden(x, fw), reps=10)
        ms_s = _time(lambda: fm.fused_sdf_value(x, fw), reps=10)
        plain_h = _time(lambda: fm.fused_hidden_plain(x, fw))
        plain_s = _time(lambda: fm.fused_sdf_value_plain(x, fw))
        flops = N_POINTS * hidden_flops
        # computed from the design, not measured: every 64-row tile requests
        # every packed weight chunk from L2
        l2_bytes = -(-N_POINTS // fm.TC_BLOCK_ROWS) * fw.tc.numel() * 2
        weights = fw.tc.numel() * 2
        bound_h = _bound(flops, N_POINTS * (fw.emb_dim + fw.real_width) * 2 + weights, "bf16")
        bound_s = _bound(flops + N_POINTS * col_flops, N_POINTS * (fw.emb_dim * 2 + 4) + weights,
                         "bf16")
        print(f"[kernels] K1 bf16 (tensor cores) N={N_POINTS}: hidden {ms_h:.3f} ms "
              f"({flops / ms_h / 1e9:.1f} TFLOP/s), fused_sdf_value {ms_s:.3f} ms "
              f"({flops / ms_s / 1e9:.1f} TFLOP/s); plain {plain_h:.3f} / {plain_s:.3f} ms; "
              f"bound {bound_h['bound_ms']:.3f} / {bound_s['bound_ms']:.3f} ms "
              f"({bound_h['bound_by']}); fp32 FMA K1 {res['k1_fp32']['ms']:.3f} ms; L2 weight "
              f"bytes requested a call, computed from the design: {l2_bytes / 1e9:.3f} GB "
              f"({l2_bytes / ms_s / 1e9:.3f} TB/s requested in the sdf entry)", flush=True)
        tc = dict(fma_fp32_ms=res["k1_fp32"]["ms"], ragged=list(RAGGED))
        res["k1_tc"] = dict(max_abs_err=max(errs_h), ms=ms_h, plain_ms=plain_h, **bound_h, **tc)
        res["sdf_value"] = dict(max_abs_err=max(errs_s), ms=ms_s, plain_ms=plain_s, **bound_s, **tc)

        # K2 on the tensor cores in split bf16, against the fp32 plain version
        # (TOL) and, printed beside, against its split-bf16 plain version
        fw = fm.prepare_weights(net, torch.float32)
        errs = []
        for n in RAGGED + (N_POINTS,):
            x = fm.embed_padded(pts[:n], fw)
            h, dx = fm.fused_fwd_bwd(x, fw)
            torch.cuda.synchronize()
            h_ref, dx_ref = fm.fused_fwd_bwd_plain(x, fw)
            h_sp, dx_sp = fm.fused_fwd_bwd_split_plain(x, fw)
            err_h = (h - h_ref).abs().max().item()
            err_dx = (dx - dx_ref).abs().max().item()
            dx_scale = dx_ref.abs().max().item()
            sp_h = (h - h_sp).abs().max().item()
            sp_dx = (dx - dx_sp).abs().max().item()
            scheme = max((h_sp - h_ref).abs().max().item(), (dx_sp - dx_ref).abs().max().item())
            print(f"[kernels] K2 (split bf16, tensor cores) N={n}: against fp32 plain h "
                  f"max_abs_err={err_h:.3e} dx max_abs_err={err_dx:.3e} (max|dx|={dx_scale:.3e}); "
                  f"against the split plain version h {sp_h:.3e} dx {sp_dx:.3e}; the split "
                  f"scheme itself {scheme:.3e}", flush=True)
            if (not err_h <= TOL["fp32_abs"] or not err_dx <= TOL["grad_rel"] * dx_scale
                    or not bool(torch.isfinite(h).all() and torch.isfinite(dx).all())):
                raise RuntimeError(f"K2 disagrees with its plain version at N={n}: h {err_h:.3e} "
                                   f"dx {err_dx:.3e}")
            errs.append(max(err_h, err_dx))
        x = fm.embed_padded(pts, fw)
        ms = _time(lambda: fm.fused_fwd_bwd(x, fw), reps=10)
        plain_ms = _time(lambda: fm.fused_fwd_bwd_plain(x, fw))
        # forward chain plus the input-gradient chain, which repeats its
        # products: three bf16 products per multiply-add on the tensor cores;
        # the fp32 FMA pipe's bound for the same work beside it
        records = fm.split_weights(fw).numel() * 2
        nbytes = N_POINTS * (2 * fw.emb_dim + fw.real_width) * 4 + records
        bound = _bound(N_POINTS * 2 * hidden_flops * 3, nbytes, "bf16")
        fma = _bound(N_POINTS * 2 * hidden_flops, nbytes, "fp32")
        # computed from the design, not measured: every 64-row tile requests
        # every record of both passes from L2
        l2_bytes = -(-N_POINTS // fm.TC_BLOCK_ROWS) * records
        tflops = N_POINTS * 2 * hidden_flops * 3 / ms / 1e9
        print(f"[kernels] K2 (split bf16, tensor cores) N={N_POINTS}: kernel {ms:.3f} ms "
              f"({tflops:.1f} bf16 TFLOP/s), plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} "
              f"ms ({bound['bound_by']}, three bf16 products a multiply-add), FP32-pipe bound "
              f"{fma['bound_ms']:.3f} ms; L2 weight bytes requested a call, computed from the "
              f"design: {l2_bytes / 1e9:.3f} GB ({l2_bytes / ms / 1e9:.3f} TB/s requested)",
              flush=True)
        res["k2"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, **bound,
                         ragged=list(RAGGED))
    return res


TRACE_RES = 512
# K3 on the card against its plain version on the same rays, both fp32
# accurate (the kernel in split fp16): they differ by summation order, which
# the 5e-5 stop threshold can amplify into a flipped convergence (as REF_TOL
# below), which moves a ray's unfinished or hit flag and its count of
# evaluations
TRACE_TOL = {"unfinished_agree": 0.999, "hit_agree": 0.999, "abs": 1e-4, "evals_rel": 0.01}


def _trace_rays(tracer, device):
    """N_POINTS rays through one TRACE_RES^2 view of the seeded-init sphere:
    the camera rays of the view in scan order (coherent tiles) and random
    pixels of it in random order (incoherent, like a training batch).
    -> {name: (cam, dirs, mask_intersect, near, far)}"""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.utils.camera import get_camera_params, get_sphere_intersection

    with tempfile.TemporaryDirectory() as d:
        ds = SceneDataset(1.0, SceneDataset.write_camera_only_split(
            d, 1, TRACE_RES, focal=1.25 * TRACE_RES), False)
        _, inp, _ = ds.collate([ds[0]])
    uv_grid = inp["uv"][0]
    uv_rand = np.random.default_rng(0).random((N_POINTS, 2)).astype(np.float32) * TRACE_RES
    sets = {}
    for name, uv in (("camera", uv_grid), ("random", uv_rand)):
        dirs, cam_loc = get_camera_params(
            torch.as_tensor(uv[None], device=device),
            torch.as_tensor(inp["pose"], device=device),
            torch.as_tensor(inp["intrinsics"], device=device))
        si, mi = get_sphere_intersection(cam_loc, dirs, r=tracer.object_bounding_sphere)
        n = dirs.shape[1]
        sets[name] = (cam_loc.expand(n, 3).contiguous(), dirs[0].contiguous(), mi.reshape(n),
                      si[..., 0].reshape(n).contiguous(), si[..., 1].reshape(n).contiguous())
    return sets


def _conf_tracer(secondary=False):
    """The primary tracer of confs/conf.conf, or its secondary tracer (the
    secondary_ray_tracer block over the primary's settings, as IDRNetwork
    builds it)."""
    from nefii_tpu_torch.models.idr import _dense_tracer_conf
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    conf = _model_conf().get_config("model")
    tc = _dense_tracer_conf(conf.get_config("ray_tracer").as_plain_dict())
    if secondary:
        tc = {**tc, **_dense_tracer_conf(conf.get_config("secondary_ray_tracer").as_plain_dict())}
    return RayTracer(**tc)


def _trace_agreement(out, ref):
    """(unfinished agreement, hit agreement, max abs distance error on the rays
    that agree on both) of two traces' (acc_start, acc_end, unfinished)."""
    from nefii_tpu_torch.ops.kernels.fused_trace import agreement

    unf, hit, err = agreement(out, ref)
    n = out[0].shape[0]
    return 1.0 - unf / n, 1.0 - hit / n, err


def phase_trace_kernel(card):
    """K3 at full width on N_POINTS rays: camera and random rays under the
    primary tracer, random rays under the secondary tracer; against its fp32
    plain version (the gate) and its split-fp16 plain version (the scheme's
    own error beside the kernel's). The gathered tracer through K1 fp32 is
    timed beside them; its count is the evaluations the rays need, which
    gives K3's bounds and which the kernel's count must match."""
    import torch

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    dev = torch.device("cuda", 0)
    net = _flagship_net(dev)
    tracer, secondary = _conf_tracer(), _conf_tracer(secondary=True)
    fw = fm.prepare_weights(net, torch.float32)
    sdf_k1 = fm.build_fused_sdf(net, torch.float32)
    hidden_flops, col_flops = _chain_flops(net)
    sets = _trace_rays(tracer, dev)
    cases = (("camera", tracer, sets["camera"]), ("random", tracer, sets["random"]),
             ("random_secondary", secondary, sets["random"]))
    res = {}
    with torch.no_grad():
        for name, tr, rays in cases:
            stats = {}
            out = ft.fused_sphere_trace(*rays, fw, tr, stats=stats)
            torch.cuda.synchronize()
            ref = ft.fused_sphere_trace_plain(*rays, fw, tr)
            split = ft.fused_sphere_trace_plain(*rays, fw, tr, split=True)
            unf_agree, hit_agree, err = _trace_agreement(out, ref)
            sp_unf, sp_hit, sp_err = _trace_agreement(out, split)
            sc_unf, sc_hit, sc_err = _trace_agreement(split, ref)
            needed = int(tr._sphere_trace(sdf_k1, *rays)[3])
            evals_rel = abs(out[3] - ref[3]) / ref[3]
            needed_rel = abs(out[3] - needed) / needed
            hits = float((out[0] < out[1]).float().mean())
            ms = _time(lambda: ft.fused_sphere_trace(*rays, fw, tr), reps=3)
            plain_ms = _time(lambda: ft.fused_sphere_trace_plain(*rays, fw, tr), reps=1)
            gathered_ms = _time(lambda: tr._sphere_trace(sdf_k1, *rays), reps=1)
            n = rays[0].shape[0]
            rows = stats["tiles"] * fm.TC_BLOCK_ROWS
            fill, waste = out[3] / rows, stats["empty_rows"] / rows
            # the work the rays need, three fp16 products a multiply-add on
            # the tensor cores (bf16's rate); the FP32 pipe's bound beside it
            rec_bytes = ft.forward_records(fw) * fm.SPLIT_REC * 2
            nbytes = n * (8 * 4 + 1) + n * (2 * 4 + 1) + rec_bytes
            bound = _bound(needed * (hidden_flops + col_flops) * 3, nbytes, "bf16")
            fp32 = _bound(needed * (hidden_flops + col_flops), nbytes, "fp32")
            # computed from the design, not measured: every tile requests every
            # forward record from L2
            l2_bytes = stats["tiles"] * rec_bytes
            print(f"[trace-kernel] K3 {name} rays (sphere_tracing_iters {tr.sphere_tracing_iters}, "
                  f"line_step_iters {tr.line_step_iters}): N={n} hit fraction {hits:.3f}; against "
                  f"the fp32 plain version: unfinished agreement {unf_agree:.6f} hit agreement "
                  f"{hit_agree:.6f} max_abs_err {err:.3e}; against the split-fp16 plain version: "
                  f"{sp_unf:.6f} / {sp_hit:.6f} / {sp_err:.3e}; the split-fp16 scheme itself "
                  f"against fp32: {sc_unf:.6f} / {sc_hit:.6f} / {sc_err:.3e}; evals kernel {out[3]} "
                  f"({out[3] / n:.2f}/ray) plain {ref[3]} ({evals_rel:.2e} rel) needed {needed} "
                  f"({needed / n:.2f}/ray, {needed_rel:.2e} rel); tiles {stats['tiles']}, fill "
                  f"{fill:.4f}, empty rows {stats['empty_rows']} ({waste:.2%}); kernel {ms:.3f} ms "
                  f"plain {plain_ms:.3f} ms gathered K1-fp32 tracer {gathered_ms:.3f} ms; bound "
                  f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, split fp16), FP32-pipe bound "
                  f"{fp32['bound_ms']:.3f} ms; L2 weight bytes requested, computed from the "
                  f"design: {l2_bytes / 1e9:.3f} GB ({l2_bytes / ms / 1e9:.3f} TB/s) [{card}]",
                  flush=True)
            if (unf_agree < TRACE_TOL["unfinished_agree"] or hit_agree < TRACE_TOL["hit_agree"]
                    or not err <= TRACE_TOL["abs"] or evals_rel > TRACE_TOL["evals_rel"]
                    or needed_rel > TRACE_TOL["evals_rel"]):
                raise RuntimeError(f"K3 disagrees with its plain version on the {name} rays")
            res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, gathered_ms=gathered_ms,
                             evals_executed=out[3], evals_needed=needed, evals_plain=ref[3],
                             tiles=stats["tiles"], fill=fill, waste=waste, hit_fraction=hits,
                             unfinished_agreement=unf_agree, hit_agreement=hit_agree,
                             split_scheme_err=sc_err, err_vs_split_plain=sp_err, **bound)
    return res


REF_RES = 16
# port on the card (K1 fp32 + K2) vs the port on the CPU (plain versions), on
# the quantities no Monte-Carlo sample touches; both fp32 accurate, so they
# differ by summation order and K2's split bf16 (~1e-5), which the tracer's
# 5e-5 stopping threshold can amplify
REF_TOL = {"mask_agree": 0.99, "abs": 1e-3}
REF_KEYS = ("points", "normal_values", "idr_rgb_values", "sg_diffuse_albedo_values",
            "sg_roughness_values")


def phase_reference():
    """A small render through the kernels on the card against the same render
    through the plain versions on the CPU (fp32 trace on both sides)."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.models.idr import IDRNetwork

    mconf = _model_conf([FP32_TRACE]).get_config("model")
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
# the kernels each path must launch: the bf16 conf's SDF queries go through the
# tensor-core K1's sdf entry; the fp32 trace of the train-reference through the
# FMA K1; K3 only where use_fused_trace is on
RENDER_KERNELS = ("fused_sdf_value", "fused_sdf_fwd_bwd")
TRAIN_KERNELS = ("fused_sdf_value", "fused_sdf_fwd_bwd", "fused_sphere_trace")
TRAIN_REF_KERNELS = ("fused_sdf_hidden", "fused_sdf_fwd_bwd", "fused_sphere_trace")
EXR_NAMES = ("gt", "rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo", "roughness",
             "specular_reflection")


def phase_render(card):
    """Render RENDER_VIEWS views of the full-width conf through the port's CLI."""
    import numpy as np
    import torch

    from nefii_tpu_torch.config import ConfigFactory
    from nefii_tpu_torch.utils import exr
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
    for name in RENDER_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"the render did not launch kernel {name}")
    return launches, stats


TRAIN_REF_PATCHES = 16   # 2x2 patches: 64 pixels
TRAIN_REF_RAYS = 4
# one training step through the kernels on the card against the same step
# through the plain versions on the CPU, both fp32 accurate with the same
# injected directions and min-SDF vector: they differ by summation order and
# K2's split bf16 (~1e-5 in the feature and the normal) only. The
# gradient gate is the ROADMAP's; the loss gate allows the order differences
# of a 64-pixel masked mean
TRAIN_REF_TOL = {"loss_rel": 1e-4, "grad_rel_l2": 2e-3}
GRAD_GROUPS = ("rendering_network", "envmap_material_network")
STEP_KEYS = ("points", "idr_rgb_values", "sg_rgb_values")


class _InjectedDirections:
    """Replace the three Monte-Carlo samplers of the port's sampling module:
    wi = normalize(n + 0.9 t(n)), t a fixed smooth function of the normal per
    strategy, with the strategy's canonical pdf. The same surface point gets
    the same direction on every device."""

    NAMES = ("cos_sampling", "brdf_sampling", "mix_sg_sampling_shared")

    def __enter__(self):
        import numpy as np
        import torch

        from nefii_tpu_torch.ops import sampling as ts

        rs = np.random.RandomState(7)
        tables = [(torch.from_numpy((rs.randn(3, 3) * 2.0).astype(np.float32)),
                   torch.from_numpy(rs.randn(3).astype(np.float32))) for _ in range(3)]

        def wi_for(k, n):
            a, c = (x.to(n.device) for x in tables[k])
            t = torch.sin(n @ a + c)
            w = n + 0.9 * t / torch.linalg.norm(t, dim=-1, keepdim=True)
            return w / torch.linalg.norm(w, dim=-1, keepdim=True)

        self.saved = {k: getattr(ts, k) for k in self.NAMES}
        ts.cos_sampling = lambda gen, n: (wi_for(0, n),
                                          ts.pdf_fn_cos(wi_for(0, n), n, None, None, None))
        ts.brdf_sampling = lambda gen, n, r, v: (
            wi_for(1, n), ts.pdf_fn_brdf_ggx(wi_for(1, n), n, v, r, None))
        ts.mix_sg_sampling_shared = lambda gen, n, lgt: (
            wi_for(2, n), ts.pdf_fn_mix_sg_shared(wi_for(2, n), n, None, None, lgt))
        self.module = ts
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


class _RecordTraces:
    """Record each K3 call (the rays, weights and tracer, and the returned
    acc_start, acc_end, unfinished, on the CPU) by the device of its rays."""

    def __enter__(self):
        from nefii_tpu_torch.ops.kernels import fused_trace as ft

        self.module, self.real = ft, ft.fused_sphere_trace
        self.calls = {"cuda": [], "cpu": []}

        def recording(*args, **kw):
            out = self.real(*args, **kw)
            self.calls[args[0].device.type].append(
                (tuple(t.detach().cpu() for t in args[:5]), args[5], args[6],
                 tuple(t.detach().cpu() for t in out[:3])))
            return out

        ft.fused_sphere_trace = recording
        return self

    def __exit__(self, *exc):
        self.module.fused_sphere_trace = self.real


def _rays_that_differ(a, b):
    """Indices of the rays whose unfinished flag or hit differs between two
    traces' (acc_start, acc_end, unfinished), or an end by more than
    TRACE_TOL['abs']."""
    far = ((a[0] - b[0]).abs() > TRACE_TOL["abs"]) | ((a[1] - b[1]).abs() > TRACE_TOL["abs"])
    return ((a[2] != b[2]) | ((a[0] < a[1]) != (b[0] < b[1])) | far).nonzero()[:, 0].tolist()


def _largest_gap(a, b):
    """(the largest |acc_start| or |acc_end| difference of two traces, its ray)."""
    import torch

    d = torch.maximum((a[0] - b[0]).abs(), (a[1] - b[1]).abs())
    if not d.numel():
        return 0.0, 0
    i = int(d.argmax())
    return float(d[i]), i


def _trace_divergence(calls):
    """For each K3 call of the card's step, on its rays: where the kernel and
    the fp32 plain version (run on the CPU) differ, where the split-fp16
    plain version differs from each, and where the CPU step's own trace (of
    its own rays, which carry the step's earlier differences) differs from
    the kernel and from the fp32 plain version."""
    import torch

    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    report = []
    for k, ((rays, _, tracer, out), (rays_c, fw_c, _, out_c)) in enumerate(
            zip(calls["cuda"], calls["cpu"])):
        with torch.no_grad():
            plain = ft.fused_sphere_trace_plain(*rays, fw_c, tracer)
            split = ft.fused_sphere_trace_plain(*rays, fw_c, tracer, split=True)
        r = dict(call=k, rays=rays[0].shape[0], iters=tracer.sphere_tracing_iters,
                 kernel_vs_plain=_rays_that_differ(out, plain),
                 kernel_vs_split=_rays_that_differ(out, split),
                 split_vs_plain=_rays_that_differ(split, plain),
                 gap_kernel_plain=_largest_gap(out, plain), gap_kernel_split=_largest_gap(out, split),
                 gap_split_plain=_largest_gap(split, plain))
        same_rays = rays_c[0].shape == rays[0].shape
        if same_rays:
            # per ray, how far the CPU step's ray lies from the card step's
            ray_gap = torch.stack([(a.float() - b.float()).abs().reshape(a.shape[0], -1).amax(1)
                                   for a, b in zip(rays, rays_c)], 1)
            r["input_max_diff"] = dict(zip(("cam", "dirs", "mask", "near", "far"),
                                           ray_gap.amax(0).tolist()))
            r["cpu_step_vs_kernel"] = _rays_that_differ(out_c, out)
            r["cpu_step_vs_plain"] = _rays_that_differ(out_c, plain)
            r["gap_cpu_step_kernel"] = _largest_gap(out_c, out)
        for i in sorted(set(r["kernel_vs_plain"]) | set(r.get("cpu_step_vs_kernel", ())))[:4]:
            ends = {"kernel": out, "fp32 plain": plain, "split plain": split}
            if same_rays:
                ends["cpu step"] = out_c
            r[f"ray {i}"] = {n: (float(t[0][i]), float(t[1][i]), bool(t[2][i]))
                             for n, t in ends.items()}
            if same_rays:
                r[f"ray {i}"]["input_diff"] = ray_gap[i].tolist()
        print(f"[train-reference] K3 call {k}: {r}", flush=True)
        report.append(r)
    return report


def phase_train_reference():
    """One frozen-geometry training step of confs/conf.conf (fp32 trace, K3 on)
    on TRAIN_REF_PATCHES x 4 pixels x TRAIN_REF_RAYS rays: through the kernels
    on the card against the plain versions on the CPU, the same weights,
    directions and min-SDF vector."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.models.loss import IDRLoss
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    conf = _model_conf([K3_ON, FP32_TRACE])
    mconf = conf.get_config("model")
    loss = IDRLoss(**conf.get_config("loss").as_plain_dict())
    gpu = IDRNetwork.from_conf(mconf, device="cuda", seed=0)
    cpu = IDRNetwork.from_conf(mconf, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as d:
        ds = SceneDataset(1.0, SceneDataset.write_camera_only_split(d, 1, 64, focal=80.0), False)
    ds.change_sampling_idx_patch(TRAIN_REF_PATCHES, 1, rng)
    ds.change_sampling_rays(TRAIN_REF_RAYS, rng)
    _, inp, _ = ds.collate([ds[0]])
    n_px = inp["uv"].shape[1]
    inp["object_mask"] = rng.random((1, n_px)) < 0.85
    gt = rng.random((1, n_px, 3)).astype(np.float32)
    steps01 = torch.from_numpy(rng.random(gpu.ray_tracer.n_steps).astype(np.float32))
    res = {}
    with _InjectedDirections(), _RecordTraces() as traces:
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            fm.reset_launch_counts()
            ft.reset_launch_counts()
            batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in inp.items()}
            out = model.forward_with_uv(batch, torch.Generator(device=dev).manual_seed(0),
                                        training=True, freeze_geo=True,
                                        steps01=steps01.to(dev))
            ld = loss(out, {"rgb": torch.as_tensor(gt, device=dev)})
            ld["loss"].backward()
            grads = {g: torch.cat([p.grad.reshape(-1).cpu() for n, p in
                                   model.named_parameters()
                                   if n.startswith(g + ".") and p.grad is not None])
                     for g in GRAD_GROUPS}
            res[dev] = dict(loss=float(ld["loss"].detach()), grads=grads,
                            mask=out["network_object_mask"].cpu(),
                            out={k: out[k].detach().cpu() for k in STEP_KEYS},
                            launches={**fm.LAUNCHES, **ft.LAUNCHES})
    g, c = res["cuda"], res["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    grad_rel = {k: float((g["grads"][k] - c["grads"][k]).norm() / c["grads"][k].norm())
                for k in GRAD_GROUPS}
    mask_agree = float((g["mask"] == c["mask"]).float().mean())
    # the rays whose outputs differ by more than REF_TOL['abs'], by output
    ray_diff = {}
    for k in STEP_KEYS:
        d = (g["out"][k] - c["out"][k]).abs().reshape(g["out"][k].shape[0], -1).amax(1)
        ray_diff[k] = {int(i): float(d[i]) for i in (d > REF_TOL["abs"]).nonzero()[:8, 0]}
    print(f"[train-reference] {n_px} px x {TRAIN_REF_RAYS} rays, kernels on cuda vs plain on "
          f"cpu: loss {g['loss']:.6f} vs {c['loss']:.6f} (rel {loss_rel:.2e}), grad rel L2 "
          f"{grad_rel}, hit mask agreement {mask_agree:.4f}, rays whose outputs differ by "
          f"more than {REF_TOL['abs']:g}: {ray_diff}, launches {g['launches']}",
          flush=True)
    divergence = _trace_divergence(traces.calls)
    if not loss_rel <= TRAIN_REF_TOL["loss_rel"]:
        raise RuntimeError(f"training loss on the card disagrees: rel {loss_rel:.2e}")
    bad = {k: v for k, v in grad_rel.items() if not v <= TRAIN_REF_TOL["grad_rel_l2"]}
    if bad:
        raise RuntimeError(f"training gradients on the card disagree: {bad}")
    if any(g["launches"][k] <= 0 for k in TRAIN_REF_KERNELS):
        raise RuntimeError(f"the card's training step missed a kernel: {g['launches']}")
    if any(n != 0 for n in c["launches"].values()):
        raise RuntimeError("the CPU step launched a kernel")
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, mask_agreement=mask_agree,
                rays_that_differ=ray_diff, trace_divergence=divergence, launches=g["launches"])


TRAIN_RES = 128
TRAIN_VIEWS = 4
TRAIN_MAX_NITER = 3   # one epoch of the 4 views: iterations 0-3


def phase_train(card):
    """Step-2 training of confs/conf.conf at full width (2048 px x 64 rays a
    step, K3 on) through nefii_tpu_torch.training.exp_runner.main, on a
    synthetic scene from a checkpoint of the seeded geometry; then the port's
    render CLI reads the trained checkpoint."""
    import numpy as np
    import torch

    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.scripts import render
    from nefii_tpu_torch.training import exp_runner
    from nefii_tpu_torch.utils import checkpoints as ckpt
    from nefii_tpu_torch.utils import exr

    text = _conf_text([("plot_freq = 1000", "plot_freq = 0"), ("val_freq = 1000", "val_freq = 0"),
                       K3_ON])
    with tempfile.TemporaryDirectory() as d:
        conf_path = os.path.join(d, "train.conf")
        with open(conf_path, "w") as f:
            f.write(text)
        scene = write_sphere_scene(os.path.join(d, "scene"), TRAIN_VIEWS, TRAIN_RES)
        geo_dir = os.path.join(d, "geometry", "checkpoints")
        model = IDRNetwork.from_conf(parse_string(text).get_config("model"), device="cuda",
                                     seed=0)
        before = ckpt.params_to_jax(model)
        ckpt.save_collection(geo_dir, ckpt.MODEL, "latest", before, {"epoch": 0})
        del model
        argv = ["--conf", conf_path, "--data_split_dir", scene, "--freeze_geometry",
                "--geometry", geo_dir, "--exps_folder_name", os.path.join(d, "exps"),
                "--roughness_warmup", "2", "--secondary_train_interval", "1",
                "--secondary_batch_size", "1024", "--max_niter", str(TRAIN_MAX_NITER),
                "--device", "cuda"]
        print("[train] python -m nefii_tpu_torch.training.exp_runner " + " ".join(argv),
              flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        runner = exp_runner.main(argv)
        torch.cuda.synchronize()
        launches = {**fm.LAUNCHES, **ft.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()

        stats = runner.step_stats
        after = ckpt.params_to_jax(runner.model)
        for s in stats:
            print(f"[train] step {s['iter']}: {s['seconds']:.3f} s/step, "
                  f"{s['rays'] / s['seconds']:.1f} rays/s ({s['rays']} rays), loss "
                  f"{s['loss']:.6f}, secondary step {s['secondary_seconds']:.3f} s "
                  f"({s['secondary_points']} hits x 64 rays) [{card}]", flush=True)
        steady = stats[1:] or stats
        summary = dict(
            steps=len(stats), rays_per_step=stats[0]["rays"],
            s_per_step=float(np.mean([s["seconds"] for s in steady])),
            secondary_s=float(np.mean([s["secondary_seconds"] for s in steady])),
            max_memory_allocated=peak)
        summary["rays_per_s"] = summary["rays_per_step"] / summary["s_per_step"]
        print(f"[train] steps after the first: "
              f"{summary['s_per_step']:.3f} s/step, "
              f"{summary['rays_per_s']:.1f} rays/s, secondary step {summary['secondary_s']:.3f} s;"
              f" max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches} [{card}]",
              flush=True)
        if len(stats) != TRAIN_VIEWS or stats[0]["rays"] != 2048 * 64:
            raise RuntimeError(f"expected {TRAIN_VIEWS} steps of 2048 x 64 rays: {stats}")
        if not all(np.isfinite(s["loss"]) for s in stats):
            raise RuntimeError("a training loss is not finite")
        if not all(s["secondary_points"] > 0 for s in stats):
            raise RuntimeError("a secondary distillation step did not run")
        moved = {net: any(not np.array_equal(after[k], before[k]) for k in before
                          if k.startswith(net + "/"))
                 for net in ("implicit_network", "rendering_network", "envmap_material_network")}
        if moved != {"implicit_network": False, "rendering_network": True,
                     "envmap_material_network": True}:
            raise RuntimeError(f"frozen geometry moved or a trained network did not: {moved}")
        for name in TRAIN_KERNELS:
            if launches[name] <= 0:
                raise RuntimeError(f"training did not launch kernel {name}")

        out_dir = os.path.join(d, "renders")
        rr = render.main(["--conf", conf_path, "--data_split_dir", scene, "--old_expdir",
                          runner.expdir, "--timestamp", runner.timestamp, "--num_rays", "1",
                          "--max_views", "1", "--out_dir", out_dir, "--device", "cuda"])
        img = exr.read(os.path.join(out_dir, "rerender_rgb_000.exr"))
        if not np.isfinite(img).all() or not rr.stats[0]["hit_fraction"] > 0:
            raise RuntimeError("the render of the trained checkpoint is not finite or hits nothing")
        print(f"[train] render CLI read the trained checkpoint: hit fraction "
              f"{rr.stats[0]['hit_fraction']:.3f}", flush=True)
    return launches, summary


def main():
    import torch

    card = phase_device()
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kern = phase_kernels()
    trace = phase_trace_kernel(card)
    ref = phase_reference()
    train_ref = phase_train_reference()
    render_launches, stats = phase_render(card)
    launches, train = phase_train(card)
    print(json.dumps({"render": stats, "reference": ref, "train_reference": train_ref,
                      "train": train, "trace_kernel": trace, "card": card}), flush=True)
    src = "nefii_tpu_torch/ops/kernels/csrc/fused_mlp.cu"
    tc_src = "nefii_tpu_torch/ops/kernels/csrc/sdf_mlp_tc.cuh"
    k1 = "nefii_tpu/ops/pallas/fused_mlp.py:136"
    ref_launches = train_ref.pop("launches")
    # launches: the training run's (this slice's main path); the render's and
    # the fp32 train-reference step's beside them. No single PyTorch call
    # computes an MLP chain or a sphere trace, so every library_ms is null.
    records = [
        dict(name="fused_sdf_hidden_tc", route="cuda", source=tc_src, replaces=k1,
             launches=launches["fused_sdf_hidden_tc"],
             render_launches=render_launches["fused_sdf_hidden_tc"], dtype="bfloat16",
             design="wgmma m64n256k16, bulk-copy weight ring", library_ms=None, **kern["k1_tc"]),
        dict(name="fused_sdf_value", route="cuda", source=tc_src, replaces=k1,
             launches=launches["fused_sdf_value"],
             render_launches=render_launches["fused_sdf_value"], dtype="bfloat16",
             design="the tensor-core K1 with the sdf column in its epilogue", library_ms=None,
             **kern["sdf_value"]),
        dict(name="fused_sdf_hidden", route="cuda", source=src, replaces=k1,
             launches=launches["fused_sdf_hidden"],
             render_launches=render_launches["fused_sdf_hidden"],
             reference_launches=ref_launches["fused_sdf_hidden"], dtype="float32",
             design="FMA pipe", library_ms=None, **kern["k1_fp32"]),
        dict(name="fused_sdf_fwd_bwd", route="cuda",
             source="nefii_tpu_torch/ops/kernels/csrc/sdf_mlp_split.cuh",
             replaces="nefii_tpu/ops/pallas/fused_mlp.py:240",
             launches=launches["fused_sdf_fwd_bwd"],
             render_launches=render_launches["fused_sdf_fwd_bwd"], dtype="float32",
             design="split bf16 (hi.hi + lo.hi + hi.lo) on wgmma m64n256k16, bulk-copy "
                    "weight ring", library_ms=None, **kern["k2"]),
        dict(name="fused_sphere_trace", route="cuda",
             source="nefii_tpu_torch/ops/kernels/csrc/fused_trace.cu",
             replaces="nefii_tpu/ops/pallas/fused_trace.py:81",
             launches=launches["fused_sphere_trace"], dtype="float32",
             design="split fp16 (hi.hi + lo.hi + hi.lo, weights scaled by 2^s per layer) on "
                    "wgmma m64n256k16 over a refilled pool of 32 live rays a block, bulk-copy "
                    "weight ring", library_ms=None,
             **{k: trace["camera"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "fill", "waste", "evals_needed",
                                                "evals_executed")},
             random_rays=trace["random"], random_rays_secondary_conf=trace["random_secondary"]),
    ]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
