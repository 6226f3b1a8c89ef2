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
   over a pool of live rays, its near rays traced again in fp32 through K1
   fp32), on 262,144 rays of one 512x512 view of the seeded-init sphere
   (camera rays and random pixels in random order under the primary tracer,
   the random pixels under the secondary tracer): no ray's unfinished or hit
   flag may differ from the K1-fp32 trace's (the re-trace's arithmetic);
   against its fp32 plain version (cuBLAS) the ends within 1e-4, and the
   flags that differ are printed beside those of the K1-fp32 trace against
   it. The kernel alone (without the re-trace) agrees with the fp32 plain
   version on 99.9% of the flags, its ends within 1e-4; at most 10% of the
   rays are near, and at most 2 + 5% of the near flags differ from the
   split-fp16 plain version's. Prints the near share, K3's time with and
   without the re-trace, and the worst split-fp16 sdf error at the rays'
   points, which NEAR_DELTA must cover twice over (also on the nets of
   phases 12 and 13). The gathered tracer through K1 fp32 is timed beside
   them, and its count of the evaluations the rays need gives K3's bounds
   and must match the kernel's count. Prints the tiles' fill.
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
7. unfrozen-reference: the same step with live geometry (freeze_geo off, the
   eikonal points injected): every loss term (eikonal and mask included)
   within rel 1e-5 and every group's gradient, the implicit net's included,
   within a relative L2 of 2e-3 of the CPU's; K1 fp32 and K3 launched, K2
   (no backward) not.
8. render: build confs/conf.conf unchanged with the port's seeded geometric
   init, save the checkpoint in the JAX package's .npz layout, and render two
   128x128 views with 16 rays per pixel through
   nefii_tpu_torch.scripts.render.main. Checks finite outputs, a hit fraction
   above 0 and that the render launched the tensor-core K1 (its sdf entry)
   and K2.
9. train: Step-2 training of confs/conf.conf with use_fused_trace at full
   width (2048 px x 64 rays a step) through
   nefii_tpu_torch.training.exp_runner.main, four steps on a synthetic 4-view
   128x128 sphere scene from a checkpoint of the seeded geometry, a secondary
   distillation step after each. Checks finite losses, a frozen geometry,
   trained rendering and material nets, a checkpoint the render CLI reads,
   and launches of the tensor-core K1 (its sdf entry), K2 and K3; prints
   s/step, rays/s, the distillation step and peak memory.
10. physg: the PhySG baseline, confs/physg.conf at full width (render type
   "sg", the closed-form SG renderer; no kernel, as in JAX), trained without
   --freeze_geometry for 4 steps of 2048 px through exp_runner.main on the
   synthetic 4-view 128x128 sphere, then rendered through render.main with
   --num_rays -1: 2 views at 128x128 and one 512x512 view (one render chunk
   of 262,144 px). Checks finite losses and EXRs, a trained geometry and
   material; prints s/step, s/view and peak memory.
11. unfrozen: confs/conf.conf at full width without --freeze_geometry (2048
   px x 64 rays, bf16 K1 in the tracers, a distillation step after each, idr lr
   1e-6 so that the second step still traces a surface), 2
   steps as shipped and 2 with train.remat and model.remat_strategies,
   through exp_runner.main. Checks that every network trains, that K1 bf16
   launched and that K2 launched 0 times in the shading that keeps a graph
   (it serves the value-only secondary-hit pool); prints s/step and
   max_memory_allocated of each run.
12. neus: confs/conf_neus.conf (NeuS's 8x256 SDF net, padded to the
   kernels' width 512 on the card): K1 and K2 on that packing against their
   plain versions, then a NeuS .pth imported with --geometry_neus and 2
   frozen steps with the workflow's flags through exp_runner.main. Checks
   the imported weights, finite losses and launches of K1 bf16 and K2. K3
   on the NeuS net as on the fitted net of phase 13 (_k3_on_net).
13. geometry: Step 1, mesh export and LPIPS, which reach no kernel (plain
   fp32 cuBLAS). Builds the port's native runtime (g++, printed seconds);
   meshes the radius-0.5 sphere with get_surface_trace at resolution 256;
   turns its faces outward (marching tetrahedra leaves windings as they come,
   and the mesh SDF's sign follows them); holds one full-width Step-1 step of
   confs/sdf.conf (16,384 points) on the card against the same step on the
   CPU (loss, implicit gradients) and times the step alone; trains
   STEP1_ITERS steps (lr STEP1_LR) through
   nefii_tpu_torch.training.geometry_runner.main on that mesh with one vis;
   prints s/step, the sampler's seconds a batch,
   the queue wait, peak memory and the first and last loss; checks the
   fitted SDF at radii 0.3 / 0.5 / 0.8; exports the high-res mesh at
   resolution 300 and checks its radius; loads the Step-1 checkpoint into
   Step 2 (exp_runner --geometry) and checks the implicit parameters; and
   holds LPIPS-alex with seeded weights on the card against the CPU. K3
   on the fitted net: the trace phase's camera and random rays, no flag
   differing from the K1-fp32 trace's, at most 10% of them near, and the
   worst split-fp16 sdf error at their points twice inside NEAR_DELTA.
14. cameras-reference: the unfrozen-reference step with the pose a [1,7]
   quaternion + translation that trains: every loss term within rel 1e-5
   and every group's gradient, the pose's included, within a relative L2 of
   2e-3 of the CPU's own step. The CPU step run again on the card's K3
   decisions (_ReplayTraces) is printed beside it.
15. cameras: --freeze_geometry --train_cameras on confs/conf.conf at full
   width (2048 px x 64 rays, K1 bf16 trace), one epoch of the synthetic
   4-view 128x128 sphere whose poses are turned by 1 degree and moved by 1 cm.
   Checks finite losses, after every step the batch image's pose row moved
   and every other row and its Adam moments bit for bit kept, quaternion
   norms within 0.05 of 1, and launches of K1 bf16 and K2; prints s/step, the
   distillation step and peak memory.
16. view-diff: confs/conf.conf frozen with loss.view_diff_weight = 0.1, each
   image's partner view (i + 3) % 4 appended (262,144 rays a step), one epoch
   of the 4-view sphere. Checks finite losses and a non-zero view_diff_loss;
   prints the pairing's seconds (two eval traces on the plain fp32 net),
   s/step and peak memory.
17. fast-multi-ray: confs/conf.conf with model.fast_multi_ray = True, 2
   frozen steps, then both 128x128 views at 16 rays through render.main.
   Checks finite outputs, one primary-trace ray a pixel (2048 a step, not
   2048 x 64) and launches of K1 bf16 and K2; prints s/step and s/view.
18. multi-gpu: processes started with spawn, each joined within a time
   limit. An NCCL world of 1 on cuda:0: a full-width frozen conf.conf step
   (2048 px x 64 rays, K1 bf16 trace, K2 shading) and its distillation step
   through IDRTrainRunner equal the same step without a process group bit
   for bit (loss, gradients, updated parameters). 2 gloo ranks sharing
   cuda:0 (NCCL refuses two ranks on one device), CUDA tensors in every
   collective: the same step on their halves of the batch, with injected
   directions and min-SDF vector, within loss rel 1e-5 and gradient rel L2
   1e-4 of the one-process step, its secondary hits' masks equal and their
   points and directions and the distilled batch within 1e-6 (MGPU_TOL), and
   rank 0's hits bit for bit those of one process on rank 0's half of the
   batch alone; 3 steps of exp_runner.main with distillation, after which both
   ranks hold the same parameters bit for bit and only rank 0 wrote; a
   128x128 render at 16 rays through RenderRunner within 1e-5 of the
   one-process render. Prints s/step of 1 and 2 ranks (2 ranks share one
   card: not a scaling figure) and each rank's peak memory. With 2 cards or
   more, the 2-rank checks run again over NCCL on cuda:0 and cuda:1.
19. render-types: the 11 render types beside pt_render_indirect_mlp and "sg"
   (path_tracing_sg, path_tracing, the hard, soft and indirect shadows, the
   diff_geo, memsave, constant-envmap and blend variants) on confs/conf.conf
   at full width with the JAX dispatch test's tweaks (a 128x128x3 constant
   light, global materials, K = 2 blended): a 128x128 view at 16 rays of
   each through RenderRunner (finite; s/view, peak memory, launches; K1's
   sdf entry launched in the secondary trace of every type with a shadow,
   K2 at the secondary hits of the three diff_geo = False types), and one
   with use_fused_trace (K3 in the secondary trace of a soft-visibility
   type); one frozen step and its distillation step (2048 px x 64 rays) of
   path_tracing_diff_shadow, pt_render_diff_shadow_indirect_blend and
   pt_render_shadow_indirect_mlp_envmap, and one live step of
   pt_render_diff_shadow_indirect_mlp, through exp_runner.main (s/step, peak
   memory); then each type's 16x16-ray render (fp32 trace, directions
   injected, some into the surface) on the card against the CPU: the
   path-traced images at >= 60 dB, REF_KEYS within REF_TOL.
20. tools: exp_runner.main on confs/conf.conf with --freeze_geometry
   --subsample 0.5, one epoch (4 steps) of 2048 px x 64 rays with their
   distillation steps on a 4-view 256x256 sphere (img_res 128x128, K scaled by 0.5, every
   loss finite, K1's sdf entry and K2 launched; s/step, peak memory); on its
   checkpoint the relighting sweep (vis_rotate_envlight.main, 180-degree
   steps, a 128x128 view at 16 rays: two finite renders that differ, K1's
   sdf entry and K2 launched; s/view) and idr_color_analyze.main on 2
   pixels (K1 fp32 and K2 launched; the hemisphere colours within 1e-4 of
   the same tool's --device cpu run, the hit flags equal); fit_envmap_with_sg
   (128 SGs on a 256x512 map that compute_envmap makes from seeded SGs: the
   first 3 steps from a shared init within rel 1e-4 of the CPU's, then 200
   steps on the card, whose loss must fall; s/step); then
   nefii_tpu_torch/workflows/neus2nefii.sh and run_s2_wmask.sh (--max_niter
   1) through bash, each exiting 0.

The line before the last is the kernels' JSON record (launches from the
frozen training run, and beside them those of the render, the references,
the live-geometry paths, the NeuS run and phases 14-20); the last line is
{"ok": true, "device": {...}}.

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


def _conf_text(replace=(), name="conf.conf"):
    """confs/<name> with the (old, new) replacements; raises if an old text is
    no longer there."""
    with open(os.path.join(ROOT, "confs", name)) as f:
        text = f.read()
    for old, new in replace:
        if old not in text:
            raise RuntimeError(f"confs/{name} no longer holds {old!r}")
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
# K3 on the card (split fp16, its near rays traced again in fp32 through K1
# fp32) against the fp32 traces of the same rays: the gathered tracer on K1
# fp32, whose arithmetic the re-trace shares, must decide every ray's
# unfinished and hit flags as K3 does; the fp32 plain version (cuBLAS) sums
# in another order, which moves ends by less than TRACE_TOL["abs"] and may
# decide a stop test within fp32 rounding of the threshold otherwise, as it
# does against the K1-fp32 trace itself (both counts printed). The kernel
# alone (before the re-trace) against the fp32 plain version: 99.9% of the
# rays' unfinished and of their hit flags agree, the ends within "abs". Its
# near flags against the split-fp16 plain version's: at most 2 + 5% of the
# near rays differ (a sum at the edge of NEAR_DELTA falls either side), and
# at most 10% of the rays are near. Its own count of evaluations within 1%
# of the plain version's live queries.
TRACE_TOL = {"flags_differ": 0, "agree": 0.999, "abs": 1e-4, "evals_rel": 0.01,
             "near_differ": (2, 0.05), "near_share": 0.10}
# NEAR_DELTA must cover the worst |split fp16 sdf - fp32 sdf| seen here at
# least this many times over
NEAR_MARGIN = 2.0


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


def _split_sdf_error(fw, rays, ref):
    """The worst |split fp16 sdf - fp32 sdf| (the plain versions of K3's chain
    and of the fp32 chain) at the points where the rays' decisions fall: each
    ray's first points (near, far), its fp32 trace's ends and their midpoint."""
    import torch

    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    cam, dirs, mi, near, far = rays
    worst = 0.0
    for t in (near, far, ref[0], ref[1], 0.5 * (ref[0] + ref[1])):
        pts = (cam + t[:, None] * dirs)[mi]
        for i in range(0, pts.shape[0], 65536):
            p = pts[i:i + 65536]
            err = (ft._sdf_plain(p, fw, split=True) - ft._sdf_plain(p, fw)).abs().max()
            worst = max(worst, float(err))
    return worst


def phase_trace_kernel(card):
    """K3 at full width on N_POINTS rays: camera and random rays under the
    primary tracer, random rays under the secondary tracer; against the
    K1-fp32 trace and its fp32 plain version, and its split-fp16 plain
    version (the scheme's own error beside the kernel's), with and without
    the fp32 re-trace of its near rays (their share, the flags against the
    split plain version's, the time of both), within TRACE_TOL. The worst
    split-fp16 sdf error at the rays' points must lie NEAR_MARGIN times
    inside NEAR_DELTA. The
    gathered tracer through K1 fp32 is timed beside them; its count is the
    evaluations the rays need, which gives K3's bounds and which the kernel's
    count must match."""
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
    worst_sdf = 0.0
    with torch.no_grad():
        for name, tr, rays in cases:
            stats, raw_stats = {}, {}
            out = ft.fused_sphere_trace(*rays, fw, tr, stats=stats)
            raw = ft._trace_kernel(*rays, fw, tr, stats=raw_stats)[:4]
            torch.cuda.synchronize()
            ref = ft.fused_sphere_trace_plain(*rays, fw, tr)
            *split_raw, split_near = ft._trace_plain(*rays, fw, tr, split=True)
            sdf_err = _split_sdf_error(fw, rays, ref)
            worst_sdf = max(worst_sdf, sdf_err)
            k1 = tr._sphere_trace(sdf_k1, *rays)
            needed = int(k1[3])
            k1_unf, k1_hit, k1_err = ft.agreement(out, k1)
            unf_d, hit_d, err = ft.agreement(out, ref)
            base_unf, base_hit, base_err = ft.agreement(k1, ref)
            raw_unf, raw_hit, raw_err = ft.agreement(raw, ref)
            sp_unf, sp_hit, sp_err = ft.agreement(raw, split_raw)
            sc_unf, sc_hit, sc_err = ft.agreement(split_raw, ref)
            n_near, n = stats["n_near"], rays[0].shape[0]
            near_differ = int((stats["near"] != split_near).sum())
            near_allowed = TRACE_TOL["near_differ"][0] + TRACE_TOL["near_differ"][1] * int(
                split_near.sum())
            evals_rel = abs(raw[3] - ref[3]) / ref[3]
            needed_rel = abs(raw[3] - needed) / needed
            hits = float((out[0] < out[1]).float().mean())
            ms = _time(lambda: ft.fused_sphere_trace(*rays, fw, tr), reps=3)
            raw_ms = _time(lambda: ft._trace_kernel(*rays, fw, tr), reps=3)
            plain_ms = _time(lambda: ft.fused_sphere_trace_plain(*rays, fw, tr), reps=1)
            gathered_ms = _time(lambda: tr._sphere_trace(sdf_k1, *rays), reps=1)
            rows = raw_stats["tiles"] * fm.TC_BLOCK_ROWS
            fill, waste = raw[3] / rows, raw_stats["empty_rows"] / rows
            # the work the rays need, three fp16 products a multiply-add on
            # the tensor cores (bf16's rate); the FP32 pipe's bound beside it
            rec_bytes = ft.forward_records(fw) * fm.SPLIT_REC * 2
            nbytes = n * (8 * 4 + 1) + n * (2 * 4 + 1) + rec_bytes
            bound = _bound(needed * (hidden_flops + col_flops) * 3, nbytes, "bf16")
            fp32 = _bound(needed * (hidden_flops + col_flops), nbytes, "fp32")
            # computed from the design, not measured: every tile requests every
            # forward record from L2
            l2_bytes = raw_stats["tiles"] * rec_bytes
            print(f"[trace-kernel] K3 {name} rays (sphere_tracing_iters {tr.sphere_tracing_iters}, "
                  f"line_step_iters {tr.line_step_iters}): N={n} hit fraction {hits:.3f}; near rays "
                  f"{n_near} ({n_near / n:.4%}; flags differing from the split plain version's "
                  f"{near_differ}, at most {near_allowed:.0f}), re-traced in fp32 with {stats['retrace_evals']} evaluations; "
                  f"rays whose unfinished / hit flag differs and max_abs_err: K3 against the "
                  f"K1-fp32 trace {k1_unf} / {k1_hit} / {k1_err:.3e}; against the fp32 plain "
                  f"version: K3 {unf_d} / {hit_d} / {err:.3e}, the K1-fp32 trace {base_unf} / "
                  f"{base_hit} / {base_err:.3e}, the kernel alone (no re-trace) {raw_unf} / "
                  f"{raw_hit} / {raw_err:.3e}; the kernel alone against the split-fp16 "
                  f"plain version: {sp_unf} / {sp_hit} / {sp_err:.3e}; the split-fp16 scheme itself "
                  f"against fp32: {sc_unf} / {sc_hit} / {sc_err:.3e}; worst |split fp16 sdf - fp32 "
                  f"sdf| at the rays' points {sdf_err:.3e}; evals kernel {raw[3]} "
                  f"({raw[3] / n:.2f}/ray) plain {ref[3]} ({evals_rel:.2e} rel) needed {needed} "
                  f"({needed / n:.2f}/ray, {needed_rel:.2e} rel); tiles {raw_stats['tiles']}, fill "
                  f"{fill:.4f}, empty rows {raw_stats['empty_rows']} ({waste:.2%}); K3 with the "
                  f"re-trace {ms:.3f} ms, the kernel alone {raw_ms:.3f} ms, plain {plain_ms:.3f} "
                  f"ms, gathered K1-fp32 tracer {gathered_ms:.3f} ms; bound "
                  f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, split fp16), FP32-pipe bound "
                  f"{fp32['bound_ms']:.3f} ms; L2 weight bytes requested, computed from the "
                  f"design: {l2_bytes / 1e9:.3f} GB ({l2_bytes / raw_ms / 1e9:.3f} TB/s) [{card}]",
                  flush=True)
            bad = ((out[2] != ref[2]) | ((out[0] < out[1]) != (ref[0] < ref[1])) |
                   (out[2] != k1[2]) | ((out[0] < out[1]) != (k1[0] < k1[1]))).nonzero()
            for i in bad[:8, 0].tolist():
                print(f"[trace-kernel] {name} ray {i} differs: near {bool(stats['near'][i])}; "
                      + "; ".join(f"{what} {float(t[0][i]):.7f} {float(t[1][i]):.7f} "
                                  f"{bool(t[2][i])}" for what, t in (
                                      ("kernel alone", raw), ("K3", out), ("K1-fp32 trace", k1),
                                      ("fp32 plain", ref))), flush=True)
            if (k1_unf + k1_hit > TRACE_TOL["flags_differ"] or not err <= TRACE_TOL["abs"]
                    or not k1_err <= TRACE_TOL["abs"]
                    or evals_rel > TRACE_TOL["evals_rel"] or needed_rel > TRACE_TOL["evals_rel"]):
                raise RuntimeError(f"K3 disagrees with its plain version on the {name} rays")
            if (max(raw_unf, raw_hit) > (1 - TRACE_TOL["agree"]) * n
                    or not raw_err <= TRACE_TOL["abs"]):
                raise RuntimeError(f"K3's kernel alone disagrees with the fp32 plain version on "
                                   f"the {name} rays")
            if near_differ > near_allowed or n_near > TRACE_TOL["near_share"] * n:
                raise RuntimeError(f"K3 flags {n_near} of the {name} rays near, {near_differ} "
                                   f"otherwise than the split plain version")
            res[name] = dict(max_abs_err=err, ms=ms, kernel_alone_ms=raw_ms, plain_ms=plain_ms,
                             gathered_ms=gathered_ms, evals_executed=raw[3], evals_needed=needed,
                             evals_plain=ref[3], retrace_evals=stats["retrace_evals"],
                             near_rays=n_near, near_share=n_near / n,
                             near_flags_vs_split_plain=near_differ, tiles=raw_stats["tiles"],
                             fill=fill, waste=waste, hit_fraction=hits,
                             flags_differ_k1_fp32=k1_unf + k1_hit, flags_differ=unf_d + hit_d,
                             k1_fp32_flags_differ=base_unf + base_hit,
                             kernel_alone_flags_differ=raw_unf + raw_hit,
                             kernel_alone_max_abs_err=raw_err, split_scheme_err=sc_err,
                             err_vs_split_plain=sp_err, split_sdf_err=sdf_err, **bound)
    print(f"[trace-kernel] worst |split fp16 sdf - fp32 sdf| over the three ray sets "
          f"{worst_sdf:.3e}; NEAR_DELTA {ft.NEAR_DELTA:.3e} ({ft.NEAR_DELTA / worst_sdf:.2f} times "
          f"it; at least {NEAR_MARGIN} required)", flush=True)
    if ft.NEAR_DELTA < NEAR_MARGIN * worst_sdf:
        raise RuntimeError("NEAR_DELTA does not cover the split fp16 sdf error")
    res["worst_split_sdf_err"] = worst_sdf
    return res


def _k3_on_net(tag, net, card):
    """K3 with its re-trace on a trained or other net than the trace phase's
    seeded init: the camera and random rays of _trace_rays under the
    primary tracer. No ray's flags may differ from the K1-fp32 trace's, at
    most TRACE_TOL["near_share"] of the rays may be near, and the worst
    split-fp16 sdf error at the rays' points must lie NEAR_MARGIN times
    inside NEAR_DELTA. -> the figures."""
    import torch

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    tracer = _conf_tracer()
    fw = fm.prepare_weights(net, torch.float32)
    sdf_k1 = fm.build_fused_sdf(net, torch.float32)
    res = {}
    with torch.no_grad():
        for name, rays in _trace_rays(tracer, torch.device("cuda", 0)).items():
            stats = {}
            out = ft.fused_sphere_trace(*rays, fw, tracer, stats=stats)
            k1 = tracer._sphere_trace(sdf_k1, *rays)
            unf, hit, err = ft.agreement(out, k1)
            sdf_err = _split_sdf_error(fw, rays, k1)
            n = rays[0].shape[0]
            hits = float((out[0] < out[1]).float().mean())
            print(f"[{tag}] K3 on {name} rays: N={n} hit fraction {hits:.3f}; near rays "
                  f"{stats['n_near']} ({stats['n_near'] / n:.4%}); against the K1-fp32 trace "
                  f"{unf} / {hit} rays whose unfinished / hit flag differs, max_abs_err "
                  f"{err:.3e}; worst |split fp16 sdf - fp32 sdf| at the rays' points "
                  f"{sdf_err:.3e}, NEAR_DELTA {ft.NEAR_DELTA / sdf_err:.2f} times it [{card}]",
                  flush=True)
            if (unf + hit > TRACE_TOL["flags_differ"] or not err <= TRACE_TOL["abs"]
                    or stats["n_near"] > TRACE_TOL["near_share"] * n
                    or ft.NEAR_DELTA < NEAR_MARGIN * sdf_err):
                raise RuntimeError(f"[{tag}] K3 on this net fails the trace phase's gates")
            res[name] = dict(near_share=stats["n_near"] / n, flags_differ_k1_fp32=unf + hit,
                             max_abs_err_k1_fp32=err, split_sdf_err=sdf_err, hit_fraction=hits)
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
    """Replace the Monte-Carlo samplers of the port's sampling module:
    wi = normalize(s n + 0.9 t(n)), t a fixed smooth function of the normal
    per strategy, with the strategy's canonical pdf; s = 1, or with `turn`
    s = -3 where another smooth function of the normal says so (those
    secondary rays enter the surface and hit). The same surface point gets
    the same direction on every device."""

    NAMES = ("cos_sampling", "brdf_sampling", "mix_sg_sampling_shared",
             "constant_2d_light_sampling", "uniform_hemisphere_sampling")

    def __init__(self, turn=False):
        self.turn = turn

    def __enter__(self):
        import numpy as np
        import torch

        from nefii_tpu_torch.ops import sampling as ts

        rs = np.random.RandomState(7)
        tables = [(torch.from_numpy((rs.randn(3, 3) * 2.0).astype(np.float32)),
                   torch.from_numpy(rs.randn(3).astype(np.float32))) for _ in range(4)]
        turn = torch.from_numpy(rs.randn(3).astype(np.float32))

        def wi_for(k, n):
            a, c = (x.to(n.device) for x in tables[k])
            t = torch.sin(n @ a + c)
            side = torch.where(torch.sin(3.0 * n @ turn.to(n.device)) > 0.4, -3.0, 1.0)[
                ..., None] if self.turn else 1.0
            w = side * n + 0.9 * t / torch.linalg.norm(t, dim=-1, keepdim=True)
            return w / torch.linalg.norm(w, dim=-1, keepdim=True)

        self.saved = {k: getattr(ts, k) for k in self.NAMES}
        ts.cos_sampling = lambda gen, n: (wi_for(0, n),
                                          ts.pdf_fn_cos(wi_for(0, n), n, None, None, None))
        ts.brdf_sampling = lambda gen, n, r, v: (
            wi_for(1, n), ts.pdf_fn_brdf_ggx(wi_for(1, n), n, v, r, None))
        ts.mix_sg_sampling_shared = lambda gen, n, lgt: (
            wi_for(2, n), ts.pdf_fn_mix_sg_shared(wi_for(2, n), n, None, None, lgt))
        ts.constant_2d_light_sampling = lambda gen, n, lgt: (
            wi_for(2, n), ts.pdf_fn_constant_2d_light(wi_for(2, n), n, None, None, lgt))
        ts.uniform_hemisphere_sampling = lambda gen, n: wi_for(3, n)
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


def _pose_gap_ray(tag, card_grads, cpu_grads, calls, cpu):
    """Print the ray where the card's and the CPU's gradients of the loss at
    the ray directions part most, its share of the parting, where the
    primary trace (K3 call 0) started its hit on each device, and the
    radiance net's d rgb / d view (CPU) at both of those points."""
    import torch

    gap = (card_grads - cpu_grads).norm(dim=-1)
    i = int(gap.argmax())
    (rays, _, _, on_card), (_, _, _, on_cpu) = calls["cuda"][0], calls["cpu"][0]
    slopes = {}
    for name, out in (("card", on_card), ("cpu", on_cpu)):
        p = (rays[0][i] + out[0][i] * rays[1][i])[None]
        _, feature, grad = cpu.implicit_network.sdf_feature_grad(p, True)
        view = (-rays[1][i])[None].clone().requires_grad_(True)
        rgb = cpu.rendering_network(p, grad / grad.norm(dim=-1, keepdim=True), view, feature)
        slopes[name] = [torch.autograd.grad(rgb[0, k], view, retain_graph=True)[0][0].tolist()
                        for k in range(3)]
    print(f"{tag} the ray directions' gradients part most at ray {i}: "
          f"{float(gap[i] / gap.sum()):.3f} of the sum of |card - CPU|, "
          f"|d loss / d dir| {float(cpu_grads[i].norm()):.3e} on the CPU; its trace start "
          f"{float(on_card[0][i]):.7f} on the card, {float(on_cpu[0][i]):.7f} on the CPU; "
          f"d idr_rgb / d view there (CPU's nets): at the card's point {slopes['card']}, at "
          f"the CPU's {slopes['cpu']}", flush=True)


class _ReplayTraces:
    """Answer the CPU step's K3 calls, in order, with the card step's recorded
    (acc_start, acc_end, unfinished) (_RecordTraces' calls["cuda"]): the CPU
    step then shades where the card's trace decided, and what is left
    between the two steps is the arithmetic downstream of the trace."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        from nefii_tpu_torch.ops.kernels import fused_trace as ft

        self.module, self.real = ft, ft.fused_sphere_trace
        calls = iter(self.calls)

        def replay(cam, *args, **kw):
            rays, _, _, out = next(calls)
            if rays[0].shape != cam.shape:
                raise RuntimeError(f"replayed K3 call of {rays[0].shape[0]} rays, asked for "
                                   f"{cam.shape[0]}")
            return (*(t.to(cam.device) for t in out), 0)

        ft.fused_sphere_trace = replay
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


# the unfrozen-reference gates: every loss term (eikonal and mask included)
# and every group's gradient, the implicit net's included
UNFROZEN_REF_TOL = {"term_rel": 1e-5, "grad_rel_l2": 2e-3}
LIVE_GRAD_GROUPS = ("implicit_network",) + GRAD_GROUPS
LIVE_REF_KERNELS = ("fused_sdf_hidden", "fused_sphere_trace")
LOSS_TERMS = ("loss", "idr_rgb_loss", "sg_rgb_loss", "eikonal_loss", "mask_loss",
              "normalsmooth_loss", "background_rgb_loss")


def phase_train_reference(live=False, cameras=False):
    """One training step of confs/conf.conf (fp32 trace, K3 on) on
    TRAIN_REF_PATCHES x 4 pixels x TRAIN_REF_RAYS rays: through the kernels
    on the card against the plain versions on the CPU, the same weights,
    directions and min-SDF vector. `live`: the unfrozen-reference, with the
    geometry training and its eikonal points injected. `cameras` (with
    `live`): the cameras-reference, the same step with the pose a [1,7]
    quaternion + translation leaf (a 64x64 view of the synthetic sphere
    scene) whose gradient is held as a group's."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models import idr
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.models.loss import IDRLoss
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    tag = ("[cameras-reference]" if cameras else "[unfrozen-reference]") if live \
        else "[train-reference]"
    groups = (LIVE_GRAD_GROUPS if live else GRAD_GROUPS) + (("pose",) if cameras else ())
    conf = _model_conf([K3_ON, FP32_TRACE])
    mconf = conf.get_config("model")
    loss = IDRLoss(**conf.get_config("loss").as_plain_dict())
    gpu = IDRNetwork.from_conf(mconf, device="cuda", seed=0)
    cpu = IDRNetwork.from_conf(mconf, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as d:
        if cameras:
            ds = SceneDataset(1.0, write_sphere_scene(d, 1, 64), True)  # focal 80 too
        else:
            ds = SceneDataset(1.0, SceneDataset.write_camera_only_split(d, 1, 64, focal=80.0),
                              False)
    ds.change_sampling_idx_patch(TRAIN_REF_PATCHES, 1, rng)
    ds.change_sampling_rays(TRAIN_REF_RAYS, rng)
    _, inp, _ = ds.collate([ds[0]])
    n_px = inp["uv"].shape[1]
    inp["object_mask"] = rng.random((1, n_px)) < 0.85
    if live:
        inp["eik_override"] = rng.uniform(-1.0, 1.0, (n_px * TRAIN_REF_RAYS // 2, 3)).astype(
            np.float32)
    gt = rng.random((1, n_px, 3)).astype(np.float32)
    steps01 = torch.from_numpy(rng.random(gpu.ray_tracer.n_steps).astype(np.float32))
    real_rays = idr.get_camera_params

    def step(model, dev):
        model.zero_grad(set_to_none=True)
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in inp.items()}
        params = dict(model.named_parameters())
        rays = {}
        if cameras:
            params["pose."] = batch["pose"] = torch.as_tensor(
                ds.get_pose_init(), device=dev).requires_grad_(True)

            def camera_rays(*args):
                rays["dirs"], cam = real_rays(*args)
                rays["dirs"].retain_grad()
                return rays["dirs"], cam

            idr.get_camera_params = camera_rays
        try:
            out = model.forward_with_uv(batch, torch.Generator(device=dev).manual_seed(0),
                                        training=True, freeze_geo=not live,
                                        steps01=steps01.to(dev))
        finally:
            idr.get_camera_params = real_rays
        ld = loss(out, {"rgb": torch.as_tensor(gt, device=dev)})
        ld["loss"].backward()
        grads = {g: torch.cat([p.grad.reshape(-1).cpu() for n, p in params.items()
                               if n.startswith(g + ".") and p.grad is not None])
                 for g in groups}
        return dict(loss=float(ld["loss"].detach()), grads=grads,
                    dir_grads=rays["dirs"].grad.reshape(-1, 3).cpu() if rays else None,
                    terms={k: float(ld[k].detach()) for k in LOSS_TERMS},
                    mask=out["network_object_mask"].cpu(),
                    out={k: out[k].detach().cpu() for k in STEP_KEYS},
                    launches={**fm.LAUNCHES, **ft.LAUNCHES})

    res = {}
    with _InjectedDirections():
        with _RecordTraces() as traces:
            for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
                res[dev] = step(model, dev)
        if cameras:
            with _ReplayTraces(traces.calls["cuda"]):
                res["replay"] = step(cpu, "cpu")
    g, c = res["cuda"], res["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    term_rel = {k: abs(g["terms"][k] - c["terms"][k]) / max(abs(c["terms"][k]), 1e-30)
                for k in LOSS_TERMS}
    grad_rel = {k: float((g["grads"][k] - c["grads"][k]).norm() / c["grads"][k].norm())
                for k in groups}
    replay_rel = None
    if cameras:
        # the pose gradient is gated against the CPU's own step; the CPU step
        # that shades where the card's K3 decided is printed beside it
        r = res["replay"]["grads"]["pose"]
        replay_rel = float((g["grads"]["pose"] - r).norm() / r.norm())
        print(f"{tag} pose gradient: card {g['grads']['pose'].tolist()}, CPU "
              f"{c['grads']['pose'].tolist()} (rel L2 {grad_rel['pose']:.3e}), CPU on the card's "
              f"K3 decisions {r.tolist()} (rel L2 {replay_rel:.3e})", flush=True)
        _pose_gap_ray(tag, g["dir_grads"], c["dir_grads"], traces.calls, cpu)
    mask_agree = float((g["mask"] == c["mask"]).float().mean())
    # the rays whose outputs differ by more than REF_TOL['abs'], by output
    ray_diff = {}
    for k in STEP_KEYS:
        d = (g["out"][k] - c["out"][k]).abs().reshape(g["out"][k].shape[0], -1).amax(1)
        ray_diff[k] = {int(i): float(d[i]) for i in (d > REF_TOL["abs"]).nonzero()[:8, 0]}
    print(f"{tag} {n_px} px x {TRAIN_REF_RAYS} rays, kernels on cuda vs plain on "
          f"cpu: loss {g['loss']:.6f} vs {c['loss']:.6f} (rel {loss_rel:.2e}), terms rel "
          f"{term_rel}, grad rel L2 {grad_rel}, hit mask agreement {mask_agree:.4f}, rays whose "
          f"outputs differ by more than {REF_TOL['abs']:g}: {ray_diff}, launches "
          f"{g['launches']}", flush=True)
    divergence = _trace_divergence(traces.calls)
    if live:
        bad = {k: v for k, v in term_rel.items() if not v <= UNFROZEN_REF_TOL["term_rel"]}
        if bad or not c["terms"]["eikonal_loss"] > 0 or not c["terms"]["mask_loss"] > 0:
            raise RuntimeError(f"{tag} loss terms on the card disagree: {bad}")
        grad_gate = UNFROZEN_REF_TOL["grad_rel_l2"]
        if any(g["launches"][k] <= 0 for k in LIVE_REF_KERNELS) or g["launches"][
                "fused_sdf_fwd_bwd"] != 0:
            raise RuntimeError(f"{tag} the card's step missed a kernel or ran K2, which has "
                               f"no backward: {g['launches']}")
    else:
        if not loss_rel <= TRAIN_REF_TOL["loss_rel"]:
            raise RuntimeError(f"training loss on the card disagrees: rel {loss_rel:.2e}")
        grad_gate = TRAIN_REF_TOL["grad_rel_l2"]
        if any(g["launches"][k] <= 0 for k in TRAIN_REF_KERNELS):
            raise RuntimeError(f"the card's training step missed a kernel: {g['launches']}")
    bad = {k: v for k, v in grad_rel.items() if not v <= grad_gate}
    if bad:
        raise RuntimeError(f"{tag} training gradients on the card disagree: {bad}")
    if any(n != 0 for n in c["launches"].values()):
        raise RuntimeError("the CPU step launched a kernel")
    return dict(loss_rel=loss_rel, term_rel=term_rel, grad_rel_l2=grad_rel,
                pose_rel_l2_on_card_trace=replay_rel, mask_agreement=mask_agree,
                rays_that_differ=ray_diff,
                trace_divergence=divergence, launches=g["launches"])


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


# the vis renders off: a training run of these phases renders nothing
NO_VIS = (("plot_freq = 1000", "plot_freq = 0"), ("val_freq = 1000", "val_freq = 0"))
PHYSG_VIEWS = 4        # 4 steps: one epoch, iterations 0-3
PHYSG_RENDER_VIEWS = 2
PHYSG_CHUNK_RES = 512  # one view of 262,144 px: one render chunk at memory_capacity_level 18
NETS = ("implicit_network", "rendering_network", "envmap_material_network")


def _moved(before, after):
    import numpy as np

    return {net: any(not np.array_equal(after[k], before[k]) for k in before
                     if k.startswith(net + "/")) for net in NETS}


def _read_views(out_dir, n, res):
    import numpy as np

    from nefii_tpu_torch.utils import exr

    for i in range(n):
        for name in EXR_NAMES:
            img = exr.read(os.path.join(out_dir, f"{name}_{i:03d}.exr"))
            if img.shape[:2] != (res, res) or not np.isfinite(img).all():
                raise RuntimeError(f"{name}_{i:03d}.exr: shape {img.shape} or non-finite")


def phase_physg(card):
    """The PhySG baseline: confs/physg.conf at full width (8x512 SDF, skip at
    4, no geometry feature, 4x512 IDR net, 128 SGs, one global material),
    trained without --freeze_geometry through exp_runner.main (2048 px a
    step, one ray each) on the synthetic sphere scene from the seeded
    geometric init, then rendered through render.main with --num_rays -1:
    two 128x128 views of the training scene and one 512x512 view, a whole
    render chunk at the default memory_capacity_level."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.scripts import render
    from nefii_tpu_torch.training import exp_runner
    from nefii_tpu_torch.utils import checkpoints as ckpt

    text = _conf_text(NO_VIS, name="physg.conf")
    with tempfile.TemporaryDirectory() as d:
        conf_path = os.path.join(d, "physg.conf")
        with open(conf_path, "w") as f:
            f.write(text)
        scene = write_sphere_scene(os.path.join(d, "scene"), PHYSG_VIEWS, TRAIN_RES)
        argv = ["--conf", conf_path, "--data_split_dir", scene, "--exps_folder_name",
                os.path.join(d, "exps"), "--max_niter", str(PHYSG_VIEWS - 1), "--device", "cuda"]
        print("[physg] python -m nefii_tpu_torch.training.exp_runner " + " ".join(argv),
              flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        runner = exp_runner.main(argv)
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated()
        launches = {**fm.LAUNCHES, **ft.LAUNCHES}
        stats = runner.step_stats
        before = ckpt.params_to_jax(type(runner.model).from_conf(
            runner.conf.get_config("model"), device="cuda", seed=0))
        moved = _moved(before, ckpt.params_to_jax(runner.model))
        for st in stats:
            print(f"[physg] step {st['iter']}: {st['seconds']:.4f} s/step ({st['rays']} rays), "
                  f"loss {st['loss']:.6f} [{card}]", flush=True)
        s_step = float(np.mean([st["seconds"] for st in stats[1:]]))
        if len(stats) != PHYSG_VIEWS or stats[0]["rays"] != 2048:
            raise RuntimeError(f"expected {PHYSG_VIEWS} steps of 2048 rays: {stats}")
        if not all(np.isfinite(st["loss"]) for st in stats):
            raise RuntimeError("a PhySG training loss is not finite")
        # idr_rgb_weight = 0: the IDR radiance net gets no gradient, as in JAX
        if moved != {"implicit_network": True, "rendering_network": False,
                     "envmap_material_network": True}:
            raise RuntimeError(f"the PhySG geometry or material did not train: {moved}")
        if any(launches.values()):
            raise RuntimeError(f"physg.conf sets no use_fused_sdf, but a kernel ran: {launches}")

        views = {}
        chunk_scene = SceneDataset.write_camera_only_split(os.path.join(d, "chunk"), 1,
                                                           PHYSG_CHUNK_RES, focal=640.0)
        for key, data, n, res in (("128", scene, PHYSG_RENDER_VIEWS, TRAIN_RES),
                                  ("512", chunk_scene, 1, PHYSG_CHUNK_RES)):
            out_dir = os.path.join(d, "renders_" + key)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rr = render.main(["--conf", conf_path, "--data_split_dir", data, "--old_expdir",
                              runner.expdir, "--timestamp", runner.timestamp, "--num_rays", "-1",
                              "--max_views", str(n), "--out_dir", out_dir, "--device", "cuda"])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            _read_views(out_dir, n, res)
            if not all(st["hit_fraction"] > 0 and st["rays"] == res * res for st in rr.stats):
                raise RuntimeError(f"the PhySG render hit nothing or cast other rays: {rr.stats}")
            views[key] = dict(s_per_view=[st["seconds"] for st in rr.stats],
                              hit_fraction=[st["hit_fraction"] for st in rr.stats],
                              max_memory_allocated=peak)
            for st in rr.stats:
                print(f"[physg] render {res}x{res} view {st['view']}: {st['seconds']:.4f} s/view, "
                      f"{st['pixels'] / st['seconds']:.1f} px/s, hit fraction "
                      f"{st['hit_fraction']:.3f} [{card}]", flush=True)
    summary = dict(s_per_step=s_step, steps=len(stats), max_memory_allocated=train_peak,
                   launches=launches, render=views)
    gib = {k: v["max_memory_allocated"] / 2**30 for k, v in views.items()}
    print(f"[physg] steps after the first: {s_step:.4f} s/step; max_memory_allocated: training "
          f"{train_peak / 2**30:.3f} GiB, 128x128 render {gib['128']:.3f} GiB, 512x512 render "
          f"(one chunk of {PHYSG_CHUNK_RES ** 2} px) {gib['512']:.3f} GiB; launches {launches} "
          f"[{card}]",
          flush=True)
    return summary


UNFROZEN_VIEWS = 2     # 2 steps a run: one epoch, iterations 0-1
# the shipped idr lr 5e-4 moves every parameter of the seeded geometry by
# ~5e-4 in Adam's first update, and on an H100 the second step then found no
# secondary hit (loss 1.28 -> 39.1): its time was not a live surface's. At
# 1e-6 both steps trace one; the time of a step does not depend on the lr
UNFROZEN_LR = ("idr_learning_rate = 5e-4", "idr_learning_rate = 1e-6")
REMAT = (("num_rays = 64", "num_rays = 64\n    remat = True"),
         ("use_fused_sdf = True", "use_fused_sdf = True\n    remat_strategies = True"))


def phase_unfrozen(card):
    """confs/conf.conf at full width without --freeze_geometry (2048 px x 64
    rays a step, bf16 K1 in the tracers, a distillation step after each)
    through exp_runner.main from a checkpoint of the seeded geometry, the idr
    lr at UNFROZEN_LR: two steps as shipped, then two with train.remat and
    model.remat_strategies. K1 must launch, and K2, which has no backward,
    must not in the shading that keeps a graph (the step's and the
    distillation's, get_rbg_value(value_only=False), recomputations under
    remat included); it serves the secondary-hit pool of the rays that
    missed, which is values only."""
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm

    runs = {}
    graph_k2 = [0]
    shade = IDRNetwork.get_rbg_value

    def counted(self, *args, value_only=True, **kw):
        before = fm.LAUNCHES["fused_sdf_fwd_bwd"]
        try:
            return shade(self, *args, value_only=value_only, **kw)
        finally:
            if not value_only:
                graph_k2[0] += fm.LAUNCHES["fused_sdf_fwd_bwd"] - before

    IDRNetwork.get_rbg_value = counted
    try:
        return _unfrozen_runs(card, runs, graph_k2)
    finally:
        IDRNetwork.get_rbg_value = shade


def _unfrozen_runs(card, runs, graph_k2):
    import numpy as np
    import torch

    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.training import exp_runner
    from nefii_tpu_torch.utils import checkpoints as ckpt

    with tempfile.TemporaryDirectory() as d:
        scene = write_sphere_scene(os.path.join(d, "scene"), UNFROZEN_VIEWS, TRAIN_RES)
        geo_dir = os.path.join(d, "geometry", "checkpoints")
        model = IDRNetwork.from_conf(parse_string(_conf_text()).get_config("model"),
                                     device="cuda", seed=0)
        before = ckpt.params_to_jax(model)
        ckpt.save_collection(geo_dir, ckpt.MODEL, "latest", before, {"epoch": 0})
        del model
        for name, replace in (("no_remat", NO_VIS + (UNFROZEN_LR,)),
                              ("remat", NO_VIS + (UNFROZEN_LR,) + REMAT)):
            conf_path = os.path.join(d, name + ".conf")
            with open(conf_path, "w") as f:
                f.write(_conf_text(replace))
            argv = ["--conf", conf_path, "--data_split_dir", scene, "--geometry", geo_dir,
                    "--exps_folder_name", os.path.join(d, "exps_" + name),
                    "--roughness_warmup", "2", "--secondary_train_interval", "1",
                    "--secondary_batch_size", "1024", "--max_niter", str(UNFROZEN_VIEWS - 1),
                    "--device", "cuda"]
            print(f"[unfrozen] {name}: python -m nefii_tpu_torch.training.exp_runner "
                  + " ".join(argv), flush=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fm.reset_launch_counts()
            ft.reset_launch_counts()
            graph_k2[0] = 0
            runner = exp_runner.main(argv)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = {**fm.LAUNCHES, **ft.LAUNCHES}
            stats = runner.step_stats
            moved = _moved(before, ckpt.params_to_jax(runner.model))
            for st in stats:
                print(f"[unfrozen] {name} step {st['iter']}: {st['seconds']:.3f} s/step, "
                      f"{st['rays'] / st['seconds']:.1f} rays/s ({st['rays']} rays), loss "
                      f"{st['loss']:.6f}, secondary step {st['secondary_seconds']:.3f} s "
                      f"({st['secondary_points']} hits x 64 rays) [{card}]", flush=True)
            runs[name] = dict(s_per_step=[st["seconds"] for st in stats],
                              secondary_s=[st["secondary_seconds"] for st in stats],
                              max_memory_allocated=peak, launches=launches,
                              k2_in_graph_shading=graph_k2[0])
            print(f"[unfrozen] {name}: max_memory_allocated {peak / 2**30:.3f} GiB; launches "
                  f"{launches}, K2 in the shading that keeps a graph {graph_k2[0]}, in the "
                  f"secondary-hit pool {launches['fused_sdf_fwd_bwd'] - graph_k2[0]} [{card}]",
                  flush=True)
            if runner.remat != (name == "remat") or runner.freeze_geo:
                raise RuntimeError(f"{name}: the run's settings are not the phase's")
            if len(stats) != UNFROZEN_VIEWS or stats[0]["rays"] != 2048 * 64:
                raise RuntimeError(f"expected {UNFROZEN_VIEWS} steps of 2048 x 64 rays: {stats}")
            if not all(np.isfinite(st["loss"]) and st["secondary_points"] > 0 for st in stats):
                raise RuntimeError("an unfrozen loss is not finite or a distillation did not run")
            if not all(moved.values()):
                raise RuntimeError(f"a network did not train: {moved}")
            if launches["fused_sdf_value"] <= 0 or graph_k2[0] != 0:
                raise RuntimeError(f"unfrozen training must launch K1 bf16, and K2 never in "
                                   f"the shading that keeps a graph ({graph_k2[0]}): {launches}")
    return runs


CAM_VIEWS = 4          # one epoch of the 4 views: iterations 0-3
CAM_TURN_DEG, CAM_SHIFT = 1.0, 0.01
VIEW_DIFF = (("background_rgb_weight = 1.0", "background_rgb_weight = 1.0\n"
              "    view_diff_weight = 0.1"),)
FAST = (("fast_multi_ray = False", "fast_multi_ray = True"),)
FAST_VIEWS = 2         # 2 steps: one epoch, iterations 0-1
FAST_RENDER_RAYS = 16


def _perturb_poses(scene, seed=0):
    """Turn each view's pose in the scene's cam_dict_norm.json by CAM_TURN_DEG
    about a random axis and move it by CAM_SHIFT, the images kept: the poses
    camera training starts from."""
    import numpy as np

    path = os.path.join(scene, "cam_dict_norm.json")
    with open(path) as f:
        cams = json.load(f)
    rs = np.random.RandomState(seed)
    for name in sorted(cams):
        c2w = np.linalg.inv(np.array(cams[name]["W2C"]).reshape(4, 4))
        a = rs.randn(3)
        a /= np.linalg.norm(a)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        t = np.radians(CAM_TURN_DEG)
        c2w[:3, :3] = (np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k) @ c2w[:3, :3]
        shift = rs.randn(3)
        c2w[:3, 3] += CAM_SHIFT * shift / np.linalg.norm(shift)
        cams[name]["W2C"] = np.linalg.inv(c2w).reshape(-1).tolist()
    with open(path, "w") as f:
        json.dump(cams, f)
    return scene


def _step2(tag, d, replace, scene, views, flags, card):
    """Step-2 training of confs/conf.conf with `replace` (the vis renders
    off), frozen geometry from the seeded init, one epoch of `views` steps of
    2048 px x 64 rays (the batch's rows), a distillation step after each,
    through exp_runner.main; the launch counts set to 0 just before and read
    just after. -> (runner, summary)."""
    import numpy as np
    import torch

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.training import exp_runner

    conf_path = os.path.join(d, tag + ".conf")
    with open(conf_path, "w") as f:
        f.write(_conf_text(NO_VIS + tuple(replace)))
    argv = ["--conf", conf_path, "--data_split_dir", scene, "--freeze_geometry",
            "--exps_folder_name", os.path.join(d, "exps_" + tag), "--roughness_warmup", "2",
            "--secondary_train_interval", "1", "--secondary_batch_size", "1024",
            "--max_niter", str(views - 1), "--device", "cuda", *flags]
    print(f"[{tag}] python -m nefii_tpu_torch.training.exp_runner " + " ".join(argv), flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    runner = exp_runner.main(argv)
    torch.cuda.synchronize()
    launches = {**fm.LAUNCHES, **ft.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    stats = runner.step_stats
    for st in stats:
        print(f"[{tag}] step {st['iter']}: {st['seconds']:.3f} s/step ({st['rays']} rays), loss "
              f"{st['loss']:.6f}, view_diff_loss {st['view_diff_loss']:.6f}, pairing "
              f"{st['pairing_seconds']:.3f} s, secondary step {st['secondary_seconds']:.3f} s "
              f"({st['secondary_points']} hits x 64 rays) [{card}]", flush=True)
    steady = stats[1:] or stats
    summary = dict(steps=len(stats), rays_per_step=stats[0]["rays"],
                   s_per_step=[st["seconds"] for st in stats],
                   secondary_s=[st["secondary_seconds"] for st in stats],
                   pairing_s=[st["pairing_seconds"] for st in stats],
                   view_diff_loss=[st["view_diff_loss"] for st in stats],
                   max_memory_allocated=peak, launches=launches)
    print(f"[{tag}] steps after the first: "
          f"{float(np.mean([st['seconds'] for st in steady])):.3f} s/step, secondary step "
          f"{float(np.mean([st['secondary_seconds'] for st in steady])):.3f} s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; launches {launches} [{card}]",
          flush=True)
    if len(stats) != views or not all(np.isfinite(st["loss"]) for st in stats):
        raise RuntimeError(f"[{tag}] expected {views} finite steps: {stats}")
    if not all(st["secondary_points"] > 0 for st in stats):
        raise RuntimeError(f"[{tag}] a secondary distillation step did not run")
    return runner, summary


def phase_cameras(card):
    """--freeze_geometry --train_cameras on confs/conf.conf (widths
    unchanged, K1 bf16 trace, K3 off as shipped), 2048 px x 64 rays, one
    epoch of CAM_VIEWS steps on the synthetic 4-view 128x128 sphere whose
    poses are perturbed (_perturb_poses). After every step the batch image's
    pose row has moved, and every other row and its Adam moments are bit for
    bit what they were; the quaternions stay within 0.05 of unit length; K1
    bf16 and K2 launched."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.training.trainer import IDRTrainRunner

    steps = []
    real = IDRTrainRunner.train_step

    def recorded(self, batch, *args, **kw):
        snap = lambda: [t.detach().reshape(self.pose_vecs.shape).clone()
                        for t in (self.pose_vecs, self.cam_optimizer.mu, self.cam_optimizer.nu)]
        rows = batch["pose_indices"].tolist()
        before = snap()
        out = real(self, batch, *args, **kw)
        steps.append((rows, before, snap()))
        return out

    IDRTrainRunner.train_step = recorded
    try:
        with tempfile.TemporaryDirectory() as d:
            scene = _perturb_poses(write_sphere_scene(os.path.join(d, "scene"), CAM_VIEWS,
                                                      TRAIN_RES))
            runner, summary = _step2("cameras", d, (), scene, CAM_VIEWS, ["--train_cameras"],
                                     card)
    finally:
        IDRTrainRunner.train_step = real
    n = runner.pose_vecs.shape[0]
    for k, (rows, before, after) in enumerate(steps):
        others = [i for i in range(n) if i not in rows]
        moved = [not torch.equal(before[0][i], after[0][i]) for i in rows]
        kept = all(torch.equal(b[others], a[others]) for b, a in zip(before, after))
        if not all(moved) or not kept:
            raise RuntimeError(f"[cameras] step {k}: batch rows {rows} moved {moved}, the other "
                               f"rows and their moments kept {kept}")
    poses = runner.pose_vecs.detach().cpu().numpy()
    qn = np.linalg.norm(poses[:, :4], axis=1)
    init = runner.train_dataset.get_pose_init()
    summary.update(quat_norms=qn.tolist(), pose_change=np.abs(poses - init).max(1).tolist())
    print(f"[cameras] quaternion norms {qn.tolist()}, largest change of each pose row "
          f"{summary['pose_change']}", flush=True)
    if not np.all(np.abs(qn - 1) <= 0.05):
        raise RuntimeError(f"[cameras] quaternion norms off unit length: {qn}")
    if summary["launches"]["fused_sdf_value"] <= 0 or summary["launches"]["fused_sdf_fwd_bwd"] <= 0:
        raise RuntimeError(f"[cameras] K1 bf16 or K2 did not launch: {summary['launches']}")
    return summary


def phase_view_diff(card):
    """confs/conf.conf frozen with loss.view_diff_weight = 0.1 (JAX's
    test_view_diff_training_runs), 2048 px x 64 rays and each image's
    partner view appended (262,144 rays a step), one epoch of the synthetic
    4-view 128x128 sphere. The pairing traces twice on the plain fp32
    implicit net. Checks finite losses and a non-zero view_diff_loss."""
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene

    with tempfile.TemporaryDirectory() as d:
        scene = write_sphere_scene(os.path.join(d, "scene"), CAM_VIEWS, TRAIN_RES)
        _, summary = _step2("view-diff", d, VIEW_DIFF, scene, CAM_VIEWS, [], card)
    if summary["rays_per_step"] != 2 * 2048 * 64 or not any(summary["view_diff_loss"]):
        raise RuntimeError(f"[view-diff] expected 262,144 rays a step and a view_diff_loss: "
                           f"{summary}")
    if summary["launches"]["fused_sdf_value"] <= 0:
        raise RuntimeError(f"[view-diff] K1 bf16 did not launch: {summary['launches']}")
    return summary


def phase_fast_multi_ray(card):
    """confs/conf.conf with model.fast_multi_ray = True: FAST_VIEWS frozen
    steps of 2048 px x 64 rays on the synthetic 2-view 128x128 sphere, then
    both views rendered at FAST_RENDER_RAYS rays a pixel through
    scripts/render.main from the trained checkpoint. The primary trace runs
    one pixel-mean ray a pixel (counted at the model's get_camera_params).
    Checks finite losses and EXRs, S rays a primary trace, and launches of K1
    bf16 and K2 in both."""
    import torch

    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models import idr
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.scripts import render

    traced = []
    real = idr.get_camera_params

    def counted(uv, pose, intrinsics):
        traced.append(uv.shape[0] * uv.shape[1])
        return real(uv, pose, intrinsics)

    idr.get_camera_params = counted
    try:
        with tempfile.TemporaryDirectory() as d:
            scene = write_sphere_scene(os.path.join(d, "scene"), FAST_VIEWS, TRAIN_RES)
            runner, summary = _step2("fast-multi-ray", d, FAST, scene, FAST_VIEWS, [], card)
            summary["primary_rays_per_step"] = list(traced)
            traced.clear()
            out_dir = os.path.join(d, "renders")
            fm.reset_launch_counts()
            ft.reset_launch_counts()
            rr = render.main(["--conf", os.path.join(d, "fast-multi-ray.conf"),
                              "--data_split_dir", scene, "--old_expdir", runner.expdir,
                              "--timestamp", runner.timestamp,
                              "--num_rays", str(FAST_RENDER_RAYS), "--max_views", str(FAST_VIEWS),
                              "--out_dir", out_dir, "--device", "cuda"])
            torch.cuda.synchronize()
            summary["render_launches"] = {**fm.LAUNCHES, **ft.LAUNCHES}
            _read_views(out_dir, FAST_VIEWS, TRAIN_RES)
    finally:
        idr.get_camera_params = real
    summary["render_primary_rays"] = sum(traced)
    summary["s_per_view"] = [s["seconds"] for s in rr.stats]
    for s in rr.stats:
        print(f"[fast-multi-ray] view {s['view']}: {s['seconds']:.3f} s/view "
              f"({TRAIN_RES}x{TRAIN_RES}, {FAST_RENDER_RAYS} rays/px), hit fraction "
              f"{s['hit_fraction']:.3f} [{card}]", flush=True)
    print(f"[fast-multi-ray] primary-trace rays: {summary['primary_rays_per_step']} a training "
          f"step (2048 x 64 = 131,072 without fast_multi_ray), {summary['render_primary_rays']} "
          f"in the render of {FAST_VIEWS} views; render launches {summary['render_launches']}",
          flush=True)
    if summary["primary_rays_per_step"] != [2048] * FAST_VIEWS or \
            summary["render_primary_rays"] != FAST_VIEWS * TRAIN_RES ** 2:
        raise RuntimeError(f"[fast-multi-ray] the primary trace did not run one ray a pixel: "
                           f"{summary}")
    if not all(s["hit_fraction"] > 0 for s in rr.stats) or any(
            summary[k][n] <= 0 for k in ("launches", "render_launches")
            for n in ("fused_sdf_value", "fused_sdf_fwd_bwd")):
        raise RuntimeError(f"[fast-multi-ray] no hit or a kernel did not launch: {summary}")
    return summary


NEUS_VIEWS = 2          # 2 steps: one epoch, iterations 0-1


def _neus_state(imp):
    """A NeuS checkpoint's `sdf_network_fine` of the port ImplicitNetwork
    `imp`: torch weight norm's lin<i>.weight_g / weight_v / bias."""
    state = {}
    for i, layer in enumerate(imp.layers):
        state[f"lin{i}.weight_g"] = layer.g.detach().cpu().clone()
        state[f"lin{i}.weight_v"] = layer.v.detach().cpu().clone()
        state[f"lin{i}.bias"] = layer.b.detach().cpu().clone()
    return {"sdf_network_fine": state}


def phase_neus(card):
    """The workflow without masks (workflows/run_s2_womask.sh):
    confs/conf_neus.conf, whose SDF net is NeuS's 8x256 (skip at 4, multires
    6, 256 features) with use_fused_sdf, bf16 trace. The CUDA kernels take
    one width, 512: prepare_weights pads the 256-wide layers with zero
    weights on the card. K1 (fp32, and bf16 both entries) and K2 on that
    packing against their plain versions at N_POINTS points, then a NeuS
    `.pth` (the seeded net's `sdf_network_fine`) imported through
    exp_runner.main --geometry_neus with the workflow's flags (frozen
    geometry, --wo_mask, --gamma 2.2, a distillation step after each of 2
    steps of 2048 px x 64 rays). Checks the imported weights bit for bit,
    finite losses, a frozen geometry, and launches of K1 bf16 and K2."""
    import numpy as np
    import torch

    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.training import exp_runner

    text = _conf_text(NO_VIS, name="conf_neus.conf")
    mconf = parse_string(text).get_config("model")
    src = IDRNetwork.from_conf(mconf, device="cuda", seed=7)
    imp = src.implicit_network
    gen = torch.Generator(device="cuda").manual_seed(2)
    pts = torch.randn(N_POINTS, 3, generator=gen, device="cuda") * 0.5
    res = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            fw = fm.prepare_weights(imp, dtype)
            if fw.width != fm.KERNEL_WIDTH or fw.real_width != 256:
                raise RuntimeError(f"NeuS packing: width {fw.width}, real {fw.real_width}")
            x = fm.embed_padded(pts, fw)
            h, ref = fm.fused_hidden(x, fw), fm.fused_hidden_plain(x, fw)
            if dtype == torch.float32:
                err = (h - ref).abs().max().item()
                if not err <= TOL["fp32_abs"] or not bool(torch.isfinite(h).all()):
                    raise RuntimeError(f"K1 fp32 on the NeuS net disagrees: {err:.3e}")
                hk, dx = fm.fused_fwd_bwd(x, fw)
                hr, dxr = fm.fused_fwd_bwd_plain(x, fw)
                e_h = (hk - hr).abs().max().item()
                e_dx = (dx - dxr).abs().max().item()
                if not (e_h <= TOL["fp32_abs"]
                        and e_dx <= TOL["grad_rel"] * dxr.abs().max().item()):
                    raise RuntimeError(f"K2 on the NeuS net disagrees: h {e_h:.3e} dx {e_dx:.3e}")
                res["k1_fp32"] = dict(max_abs_err=err, ms=_time(lambda: fm.fused_hidden(x, fw)))
                res["k2"] = dict(max_abs_err_h=e_h, max_abs_err_dx=e_dx,
                                 ms=_time(lambda: fm.fused_fwd_bwd(x, fw)))
            else:
                err, _ = _check_bf16("K1 bf16 on the NeuS net", h, ref)
                es, _ = _check_bf16("fused_sdf_value on the NeuS net", fm.fused_sdf_value(x, fw),
                                    fm.fused_sdf_value_plain(x, fw))
                res["k1_bf16"] = dict(max_abs_err=err, sdf_max_abs_err=es,
                                      ms=_time(lambda: fm.fused_sdf_value(x, fw), reps=10))
    print(f"[neus] 8x256 SDF net padded to width {fm.KERNEL_WIDTH}, N={N_POINTS}: {res} "
          f"[{card}]", flush=True)
    res["k3"] = _k3_on_net("neus", imp, card)

    with tempfile.TemporaryDirectory() as d:
        conf_path = os.path.join(d, "conf_neus.conf")
        with open(conf_path, "w") as f:
            f.write(text)
        pth = os.path.join(d, "neus.pth")
        torch.save(_neus_state(imp), pth)
        scene = write_sphere_scene(os.path.join(d, "scene"), NEUS_VIEWS, TRAIN_RES)
        argv = ["--conf", conf_path, "--data_split_dir", scene, "--exps_folder_name",
                os.path.join(d, "exps"), "--gamma", "2.2", "--wo_mask", "--roughness_warmup",
                "2", "--secondary_batch_size", "1024", "--secondary_train_interval", "1",
                "--freeze_geometry", "--geometry_neus", pth, "--max_niter",
                str(NEUS_VIEWS - 1), "--device", "cuda"]
        print("[neus] python -m nefii_tpu_torch.training.exp_runner " + " ".join(argv),
              flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        runner = exp_runner.main(argv)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {**fm.LAUNCHES, **ft.LAUNCHES}
    stats = runner.step_stats
    for st in stats:
        print(f"[neus] step {st['iter']}: {st['seconds']:.3f} s/step ({st['rays']} rays), loss "
              f"{st['loss']:.6f}, secondary step {st['secondary_seconds']:.3f} s [{card}]",
              flush=True)
    got = runner.model.implicit_network
    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(got.parameters(), imp.parameters()))
    print(f"[neus] imported weights equal the .pth's: {same}; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches {launches} [{card}]", flush=True)
    if not same or not runner.freeze_geo:
        raise RuntimeError("the NeuS geometry was not imported as saved, or it trained")
    if len(stats) != NEUS_VIEWS or not all(np.isfinite(st["loss"]) and st["secondary_points"] > 0
                                           for st in stats):
        raise RuntimeError(f"expected {NEUS_VIEWS} finite steps with distillation: {stats}")
    if launches["fused_sdf_value"] <= 0 or launches["fused_sdf_fwd_bwd"] <= 0:
        raise RuntimeError(f"the NeuS run must launch K1 bf16 and K2: {launches}")
    return dict(kernels=res, s_per_step=[st["seconds"] for st in stats],
                max_memory_allocated=peak, launches=launches)


STEP1_ITERS = 300
STEP1_VIS = 200       # the iteration of the one vis
STEP1_POINTS = 16384
# confs/sdf.conf's 5e-4 is tuned for 800,000 steps; over a few hundred, its
# Adam steps on the 8x512 net leave the sphere's interior short of the JAX
# test's tolerance, where 1e-4 fits it (the time of a step does not depend
# on it)
STEP1_LR = "1e-4"
VIS_RES = 128
SPHERE_RES = 256
EXPORT_RES = 300
# one Step-1 step on the card against the CPU: both fp32 (no TF32), so they
# differ by summation order; the gradient gate is the ROADMAP's
STEP1_TOL = {"loss_rel": 1e-5, "grad_rel_l2": 2e-3}
# the fitted SDF's mean at radii 0.3 / 0.5 / 0.8 of the radius-0.5 sphere
# (tests/test_geometry_train.py), and the exported mesh's mean radius error
FIT_TOL = ((0.3, 0.1), (0.5, 0.05), (0.8, 0.15))
MESH_RADIUS_TOL = 0.02
LPIPS_RES = 256
LPIPS_REL = 1e-5


def _step1_check(conf, mesh):
    """One full-width Step-1 step on the card against the same step on the
    CPU (the same weights and batch): loss rel and the implicit net's
    gradient rel L2."""
    import torch

    from nefii_tpu_torch.training.geometry_trainer import GeometryTrainRunner

    with tempfile.TemporaryDirectory() as d:
        runners = [GeometryTrainRunner(conf=conf, mesh_path=mesh, batch_points=STEP1_POINTS,
                                       max_niters=1, exps_folder_name=os.path.join(d, dev),
                                       device=dev, scale_to_unit=False)
                   for dev in ("cuda", "cpu")]
    gpu, cpu = runners
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    pts, sdf = gpu.dataset[0]
    losses, grads = [], []
    for r in runners:
        losses.append(float(r.train_step(torch.as_tensor(pts, device=r.device),
                                         torch.as_tensor(sdf, device=r.device))))
        grads.append(torch.cat([p.grad.reshape(-1).cpu() for p in
                                r.model.implicit_network.parameters()]))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    grad_rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    # the step alone on the card: no sampler thread competes with its launches
    x, y = (torch.as_tensor(a, device=gpu.device) for a in (pts, sdf))
    step_ms = _time(lambda: gpu.train_step(x, y), reps=20)
    print(f"[geometry] one Step-1 step, {STEP1_POINTS} points, card vs CPU: loss "
          f"{losses[0]:.7f} vs {losses[1]:.7f} (rel {loss_rel:.2e}), implicit gradient rel L2 "
          f"{grad_rel:.2e}; the step alone on the card (CUDA events, 20 steps) {step_ms:.3f} ms",
          flush=True)
    if not loss_rel <= STEP1_TOL["loss_rel"] or not grad_rel <= STEP1_TOL["grad_rel_l2"]:
        raise RuntimeError(f"the card's Step-1 step disagrees with the CPU's: loss rel "
                           f"{loss_rel:.2e}, gradient rel L2 {grad_rel:.2e}")
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, step_alone_ms=step_ms)


def phase_geometry(card):
    """Step 1 at full width through the port's CLI, the mesh tools, the
    Step-1 checkpoint in Step 2, and LPIPS on the card (module docstring,
    phase 13)."""
    import numpy as np
    import torch

    from nefii_tpu_torch import native
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.training import exp_runner, geometry_runner
    from nefii_tpu_torch.utils import lpips, mesh_io, plots

    dev = torch.device("cuda", 0)
    res = {}
    t0 = time.perf_counter()
    native.get_lib()
    print(f"[geometry] native runtime (g++ -O3 -march=native -fopenmp) built in "
          f"{native.BUILD_SECONDS:.2f} s, loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    with tempfile.TemporaryDirectory() as d:
        # the Step-1 mesh: the radius-0.5 sphere through the port's marching
        # tetrahedra, the size of a NeuS marching-cubes export
        t0 = time.perf_counter()
        verts, faces = plots.get_surface_trace(lambda x: torch.linalg.norm(x, dim=-1) - 0.5,
                                               SPHERE_RES, device=dev)
        sphere_s = time.perf_counter() - t0
        err = float(np.abs(np.linalg.norm(verts, axis=1) - 0.5).mean())
        # marching tetrahedra leaves each triangle's winding as it comes (as
        # the JAX package's does), and the mesh SDF takes its sign from the
        # windings' pseudonormals: turn every face outward before Step 1
        tri = verts[faces]
        outward = np.einsum("ij,ij->i", np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                            tri.sum(1)) > 0
        faces = np.where(outward[:, None], faces, faces[:, [0, 2, 1]])
        mesh = os.path.join(d, "sphere.ply")
        mesh_io.save_mesh(mesh, verts, faces)
        print(f"[geometry] get_surface_trace of the radius-0.5 sphere at {SPHERE_RES}^3: "
              f"{len(verts)} vertices, {len(faces)} faces in {sphere_s:.2f} s, mean |r - 0.5| "
              f"{err:.2e}, {outward.mean():.4f} of the faces wound outward (all after turning) "
              f"[{card}]", flush=True)
        if not err <= 1e-3 or len(faces) < 50_000:
            raise RuntimeError(f"the sphere mesh is wrong: {len(faces)} faces, error {err:.2e}")
        res["sphere_mesh"] = dict(vertices=len(verts), faces=len(faces), seconds=sphere_s,
                                  mean_radius_err=err, outward_share=float(outward.mean()))

        with open(os.path.join(ROOT, "confs", "sdf.conf")) as f:
            text = f.read()
        for old in ("plot_freq = 2000", "idr_learning_rate = 5e-4"):
            if old not in text:
                raise RuntimeError(f"confs/sdf.conf no longer holds {old!r}")
        conf_path = os.path.join(d, "sdf.conf")
        with open(conf_path, "w") as f:
            f.write(text.replace("plot_freq = 2000", f"plot_freq = {STEP1_VIS}")
                    .replace("idr_learning_rate = 5e-4", f"idr_learning_rate = {STEP1_LR}"))
        from nefii_tpu_torch.config import ConfigFactory

        res["card_vs_cpu_step"] = _step1_check(ConfigFactory.parse_file(conf_path), mesh)

        scene = write_sphere_scene(os.path.join(d, "scene"), 2, VIS_RES)
        argv = ["--conf", conf_path, "--mesh_path", mesh, "--batch_size", str(STEP1_POINTS),
                "--max_niter", str(STEP1_ITERS), "--not_scale_to_unit", "--data_split_dir", scene,
                "--exps_folder_name", os.path.join(d, "exps"), "--expname", "s1",
                "--device", "cuda"]
        print("[geometry] python -m nefii_tpu_torch.training.geometry_runner " + " ".join(argv),
              flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        t0 = time.perf_counter()
        runner = geometry_runner.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fm.LAUNCHES, **ft.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        stats = runner.step_stats
        steady = stats[1:]
        mean = lambda k: float(np.mean([s[k] for s in steady]))  # noqa: E731
        summary = dict(steps=len(stats), points_per_step=STEP1_POINTS,
                       s_per_step=mean("seconds"), sampler_s_per_batch=mean("sample_seconds"),
                       queue_wait_s=mean("wait"), first_loss=stats[0]["loss"],
                       last_loss=stats[-1]["loss"], max_memory_allocated=peak, wall_s=wall,
                       launches=launches)
        summary["loop_s_per_step"] = mean("seconds") + mean("wait")
        print(f"[geometry] Step 1, steps after the first: {summary['s_per_step'] * 1e3:.3f} ms "
              f"a step (upload, forward, backward, Adam, synchronised), sampler "
              f"{summary['sampler_s_per_batch'] * 1e3:.3f} ms a batch on its thread, queue wait "
              f"{summary['queue_wait_s'] * 1e3:.3f} ms a step; {len(stats)} steps in {wall:.2f} s "
              f"with the vis and checkpoints; loss {summary['first_loss']:.6f} -> "
              f"{summary['last_loss']:.6f}; max_memory_allocated {peak / 2**30:.3f} GiB; kernel "
              f"launches {launches} (Step 1 reaches no kernel) [{card}]", flush=True)
        if len(stats) != STEP1_ITERS or not all(np.isfinite(s["loss"]) for s in stats):
            raise RuntimeError(f"Step 1 did not take {STEP1_ITERS} finite steps")
        if not summary["last_loss"] < 0.5 * summary["first_loss"]:
            raise RuntimeError("the Step-1 loss did not fall")
        vis = os.path.join(runner.plots_dir, f"geo_{STEP1_VIS}.png")
        if not os.path.getsize(vis):
            raise RuntimeError(f"{vis} is empty")

        imp = runner.model.implicit_network
        dirs = np.random.RandomState(0).randn(500, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        fit = {}
        with torch.no_grad():
            for r, tol in FIT_TOL:
                fit[r] = float(imp.sdf(torch.as_tensor(dirs * r, device=dev)).mean())
        print(f"[geometry] fitted SDF mean at radius r (expected r - 0.5): {fit}", flush=True)
        bad = {r: v for (r, tol), v in zip(FIT_TOL, fit.values()) if not abs(v - (r - 0.5)) <= tol}
        if bad:
            raise RuntimeError(f"the fitted SDF misses the sphere: {bad}")
        summary["fit"] = fit
        summary["k3"] = _k3_on_net("geometry", imp, card)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verts, faces = plots.get_surface_high_res_mesh(imp.sdf, EXPORT_RES, device=dev)
        export_s = time.perf_counter() - t0
        err = float(np.abs(np.linalg.norm(verts, axis=1) - 0.5).mean())
        print(f"[geometry] get_surface_high_res_mesh of the fitted net at {EXPORT_RES}: "
              f"{export_s:.2f} s, {len(verts)} vertices, {len(faces)} faces, mean |r - 0.5| "
              f"{err:.2e} [{card}]", flush=True)
        if not len(faces) or not err <= MESH_RADIUS_TOL:
            raise RuntimeError(f"the exported mesh misses the sphere: {err:.2e}")
        summary["export"] = dict(seconds=export_s, vertices=len(verts), faces=len(faces),
                                 mean_radius_err=err)

        step2 = exp_runner.main(["--conf", os.path.join(ROOT, "confs", "conf.conf"),
                                 "--data_split_dir", scene, "--freeze_geometry", "--geometry",
                                 runner.checkpoints_path, "--exps_folder_name",
                                 os.path.join(d, "exps2"), "--max_niter", "-1", "--device",
                                 "cuda"])
        got = step2.model.implicit_network.state_dict()
        same = all(torch.equal(v, got[k]) for k, v in imp.state_dict().items())
        print(f"[geometry] Step 2 --geometry read the Step-1 checkpoint: implicit parameters "
              f"equal {same}", flush=True)
        if not same:
            raise RuntimeError("Step 2's --geometry load differs from the Step-1 parameters")
        del step2
    res["step1"] = summary

    rs = np.random.RandomState(3)
    weights, c_in = {}, 3
    for i, (c_out, k, _, _) in enumerate(lpips._CONVS):
        weights[f"conv{i}_w"] = (rs.randn(c_out, c_in, k, k)
                                 * np.sqrt(2.0 / (c_in * k * k))).astype(np.float32)
        weights[f"conv{i}_b"] = (rs.randn(c_out) * 0.01).astype(np.float32)
        weights[f"lin{i}"] = rs.uniform(0, 0.1, c_out).astype(np.float32)
        c_in = c_out
    a = rs.uniform(0, 1, (LPIPS_RES, LPIPS_RES, 3)).astype(np.float32)
    b = np.clip(a + rs.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    on_card = lpips.lpips_distance(lpips.LPIPS(weights, dev), a, b)
    on_cpu = lpips.lpips_distance(lpips.LPIPS(weights, "cpu"), a, b)
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"[geometry] LPIPS-alex {LPIPS_RES}x{LPIPS_RES}, seeded weights: card {on_card:.7f} "
          f"CPU {on_cpu:.7f} (rel {rel:.2e})", flush=True)
    if not rel <= LPIPS_REL:
        raise RuntimeError(f"LPIPS on the card disagrees with the CPU: rel {rel:.2e}")
    res["lpips"] = dict(card=on_card, cpu=on_cpu, rel=rel)
    return res


MGPU_VIEWS = 3            # exp_runner: one epoch of 3 views, iterations 0-2
MGPU_RES = 128
MGPU_RENDER_RAYS = 16
MGPU_HITS = 1024          # secondary_batch_size
MGPU_TIMEOUT = 600        # seconds for all the ranks of a run
MGPU_DEVICE = "cuda:0"    # every rank's device
# 2 gloo ranks on cuda:0 against one process on the same card, the same
# injected samples: the ranks' sums of (num, den) and gradients run in another
# order than one process's (rel ~1e-7), and a rank's batch is half the rays
MGPU_TOL = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4, "render_abs": 1e-5, "hit_abs": 1e-6}
# hit_abs: the secondary hits' masks are equal, and their points and
# directions lie within 1e-6 of the one-process step's, the bracket of the
# gathered tracer's bisection, which runs as many steps as the slowest ray of
# its batch (ROADMAP Queue 3). The witness that the batch's size is the
# cause: rank 0's hits equal bit for bit those of one process stepping on
# rank 0's half of the batch alone.


class _FixedMinSdfSteps:
    """Give every training forward of the port the same min-SDF step vector
    (each rank's generator would draw its own)."""

    def __init__(self, steps01):
        self.steps01 = steps01

    def __enter__(self):
        from nefii_tpu_torch.models.idr import IDRNetwork

        self.real = real = IDRNetwork.forward_with_uv
        steps01 = self.steps01

        def fixed(model, inputs, gen, **kw):
            if kw.get("training"):
                kw.setdefault("steps01", steps01.to(inputs["uv"].device))
            return real(model, inputs, gen, **kw)

        IDRNetwork.forward_with_uv = fixed
        return self

    def __exit__(self, *exc):
        from nefii_tpu_torch.models.idr import IDRNetwork

        IDRNetwork.forward_with_uv = self.real


def _mgpu_step(spec, tag, part=None):
    """One full-width frozen step of the shipped conf (2048 px x 64 rays, K1
    bf16 trace, K2 shading) on this rank's slice of view 0's epoch-0 sample
    (or on slice `part` = (rank, world) of it in one process), and its
    distillation step, through IDRTrainRunner: the loss terms, the
    gradients, the pool gathered along the ray axis, the distilled batch
    selected from it, the parameters after both updates, seconds and peak
    memory."""
    import torch

    from nefii_tpu_torch.parallel import dist, spmd
    from nefii_tpu_torch.training.trainer import POOL_KEYS, IDRTrainRunner, secondary_batch

    dev = torch.device(spec["device"])
    runner = IDRTrainRunner(conf=spec["conf"], data_split_dir=spec["scene"], freeze_geometry=True,
                            geometry=spec["geometry"], secondary_batch_size=MGPU_HITS,
                            exps_folder_name=os.path.join(spec["dir"], f"{tag}{dist.rank()}"),
                            device=spec["device"])
    runner._sample_pixels(0)
    _, model_input, ground_truth = runner.train_dataset.collate([runner.train_dataset[0]])
    part = part or (None, None)
    batch = spmd.shard_batch(runner._device_inputs(model_input), *part)
    gt = spmd.shard_batch({"rgb": torch.as_tensor(ground_truth["rgb"], device=dev)}, *part)
    params = [p for g in runner.optimizers.values() for p in g.params]
    names = {id(p): n for n, p in runner.model.named_parameters()}
    runner._sync()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ld, out, finite = runner.train_step(batch, gt, False, False, runner._alpha(), distil=True)
    runner._sync()
    step_s = time.perf_counter() - t0
    grads = {names[id(p)]: p.grad.detach().cpu().clone() for p in params}
    pool = {k: dist.gather_along(out[k], 1) for k in POOL_KEYS}
    pb, k, n_hit = secondary_batch(pool, MGPU_HITS, runner.num_rays, dist.process_count())
    t1 = time.perf_counter()
    distilled = runner._train_with_secondary(out, False, False)
    runner._sync()
    return dict(finite=finite, terms={t: float(v.detach()) for t, v in ld.items()}, grads=grads,
                pool={t: v.cpu() for t, v in pool.items()}, hits=n_hit, k=k, distilled=distilled,
                batch={t: v[:k].cpu() for t, v in pb.items()},
                params={n: p.detach().cpu().clone() for n, p in runner.model.named_parameters()},
                step_s=step_s, secondary_s=time.perf_counter() - t1,
                peak=torch.cuda.max_memory_allocated(dev), rays=batch["uv"].shape[:-1].numel())


def _mgpu_render(spec):
    """View 0 at MGPU_RES^2 with MGPU_RENDER_RAYS rays a pixel through the
    render CLI's RenderRunner (each rank its slice of every chunk)."""
    import torch

    from nefii_tpu_torch.scripts import render

    argv = ["--conf", spec["conf"], "--data_split_dir", spec["scene"], "--old_expdir",
            spec["render_exp"], "--num_rays", str(MGPU_RENDER_RAYS), "--max_views", "1",
            "--out_dir", os.path.join(spec["dir"], "renders"), "--device", spec["device"]]
    opt = render.add_argument(__import__("argparse").ArgumentParser()).parse_args(argv)
    runner = render.RenderRunner(**vars(opt))
    t0 = time.perf_counter()
    out = runner.render_view(0)
    return dict(out={k: out[k] for k in ("sg_rgb_values", "idr_rgb_values", "normal_values",
                                         "network_object_mask")},
                seconds=time.perf_counter() - t0)


def _mgpu_cli(spec, exps):
    """MGPU_VIEWS steps of exp_runner.main with distillation after each: the
    parameters, the step records, the run directory and the peak memory."""
    import torch

    from nefii_tpu_torch.training import exp_runner
    from nefii_tpu_torch.utils import checkpoints as ckpt

    dev = torch.device(spec["device"])
    torch.cuda.reset_peak_memory_stats(dev)
    runner = exp_runner.main(spec["cli_argv"] + ["--device", spec["device"], "--exps_folder_name",
                                                 os.path.join(spec["dir"], exps)])
    return dict(params=ckpt.params_to_jax(runner.model), stats=runner.step_stats,
                rundir=runner.rundir, peak=torch.cuda.max_memory_allocated(dev))


def _mgpu_worker(rank, world, store, spec, out_path):
    """A rank of the multi-gpu phase, started with spawn. World 1: the step
    without a process group, then over an NCCL group of one on cuda:0, then
    the one-process render. World 2 (spec["backend"]: gloo on cuda:0, or
    NCCL with rank r on cuda:r): the step, 3 steps of exp_runner.main with
    distillation, the render. The launches of the kernels over the whole
    run."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as tdist

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores (torchrun's one thread a rank would
    # starve the host code of a one-process run)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ["LOCAL_RANK"] = str(rank)
    res = {}
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    try:
        with _InjectedDirections(), _FixedMinSdfSteps(spec["steps01"]):
            if world == 1:
                res["plain"] = _mgpu_step(spec, "plain")
                res["half"] = _mgpu_step(spec, "half", part=(0, 2))
                dev = torch.device(spec["device"])
                tdist.init_process_group("nccl", init_method=f"file://{store}", world_size=1,
                                         rank=0, device_id=dev)
                dist.warmup(dev)
                res["backend"] = tdist.get_backend()
                res["nccl"] = _mgpu_step(spec, "nccl")
                res["cli"] = _mgpu_cli(spec, "cli_one")
                res["render"] = _mgpu_render(spec)
            else:
                if spec["backend"] == "nccl":
                    spec = dict(spec, device=f"cuda:{rank}")
                dist.initialize(num_processes=world, process_id=rank, device=spec["device"],
                                backend=spec["backend"], init_method=f"file://{store}")
                res["backend"] = tdist.get_backend()
                res["step"] = _mgpu_step(spec, f"step_{spec['backend']}")
                res["cli"] = _mgpu_cli(spec, f"cli_{spec['backend']}{rank}")
                res["render"] = _mgpu_render(spec)
        res["launches"] = {**fm.LAUNCHES, **ft.LAUNCHES}
    finally:
        dist.shutdown()
    torch.save(res, out_path)


def _mgpu_run(world, spec, d):
    """Spawn the `world` ranks of _mgpu_worker, join them within
    MGPU_TIMEOUT seconds (or kill them), fail unless each exited 0; -> each
    rank's results."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tag = f"{world}{spec['backend']}"
    store = os.path.join(d, f"store{tag}")
    outs = [os.path.join(d, f"world{tag}_rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_mgpu_worker, args=(r, world, store, spec, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MGPU_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"[multi-gpu] the ranks of world {world} exited with {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def _check_two_ranks(one, two, d, backend, card):
    """Hold 2 ranks' results (over `backend`) against the one-process run on
    the card: the step within MGPU_TOL, its secondary hits and distilled
    batch; exp_runner's parameters equal on both ranks and rank 0 alone
    wrote; the render within MGPU_TOL['render_abs']. Prints s/step and peak
    memory of 1 and 2 ranks. -> the figures."""
    import numpy as np
    import torch

    from nefii_tpu_torch.utils import checkpoints as ckpt

    where = f"on {MGPU_DEVICE}" if backend == "gloo" else "on cuda:0 and cuda:1"
    ref = one["plain"]
    report = {}
    for r, res in enumerate(two):
        st = res["step"]
        loss_rel = abs(st["terms"]["loss"] - ref["terms"]["loss"]) / abs(ref["terms"]["loss"])
        grad_rel = {}
        for g in ("rendering_network", "envmap_material_network"):
            a = torch.cat([st["grads"][k].reshape(-1) for k in sorted(st["grads"])
                           if k.startswith(g + ".")])
            b = torch.cat([ref["grads"][k].reshape(-1) for k in sorted(ref["grads"])
                           if k.startswith(g + ".")])
            grad_rel[g] = _rel_l2(a, b)
        # the hits: the mask equal, the hit points and every direction
        # within MGPU_TOL["hit_abs"] (the points of the rays that hit
        # nothing are never distilled)
        hit = ref["pool"]["secondary_mask"][..., 0]
        hit_err = max(float((st["pool"]["secondary_points"][hit]
                             - ref["pool"]["secondary_points"][hit]).abs().max()),
                      float((st["pool"]["secondary_dir"]
                             - ref["pool"]["secondary_dir"]).abs().max()))
        pool_same = (torch.equal(st["pool"]["secondary_mask"], ref["pool"]["secondary_mask"])
                     and hit_err <= MGPU_TOL["hit_abs"])
        pool_exact = pool_same and hit_err == 0.0
        if r == 0:
            # the witness: the same rays in a batch of the same size
            half, n = one["half"]["pool"], st["pool"]["secondary_mask"].shape[1] // 2
            strategies = st["pool"]["secondary_mask"].shape[0]
            witness = all(torch.equal(st["pool"][k][:, :n], half[k][:strategies])
                          for k in st["pool"])
        batch_err = max(float((st["batch"][k] - ref["batch"][k]).abs().max())
                        for k in ref["batch"])
        batch_same = st["k"] == ref["k"] and batch_err <= MGPU_TOL["hit_abs"]
        report[r] = dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, pool_hits_equal=pool_same,
                         pool_bit_for_bit=pool_exact, hit_point_err=hit_err,
                         pool_equals_half_batch=witness,
                         distilled_equal=batch_same, distilled_point_err=batch_err,
                         first_step_s=st["step_s"], peak=st["peak"])
        print(f"[multi-gpu] 2 ranks over {res['backend']} {where}, rank {r}: {st['rays']} "
              f"rays, loss rel {loss_rel:.3e}, grad rel L2 {grad_rel}, secondary hits: masks "
              f"equal, points and directions within {hit_err:.3e} ({st['hits']} hits; bit for "
              f"bit: {pool_exact}; rank 0's bit for bit one process's on rank 0's half: "
              f"{witness}), distilled batch equal {batch_same} ({st['k']} hits, "
              f"within {batch_err:.3e}); the first step (with its warm-up) "
              f"{st['step_s']:.3f} s, peak {st['peak'] / 2**30:.3f} GiB [{card}]", flush=True)
        if not (loss_rel <= MGPU_TOL["loss_rel"]
                and all(v <= MGPU_TOL["grad_rel_l2"] for v in grad_rel.values())
                and pool_same and witness and batch_same
                and st["distilled"] == ref["distilled"]):
            raise RuntimeError(f"[multi-gpu] rank {r}'s step disagrees with one process")

    # exp_runner: the same parameters on both ranks, rank 0 alone wrote;
    # s/step of the steps after the first, 1 and 2 ranks
    cli = [res["cli"] for res in two]

    def steady(c):
        return float(np.mean([s["seconds"] for s in c["stats"][1:]]))

    s1, s2 = steady(one["cli"]), [steady(c) for c in cli]
    print(f"[multi-gpu] exp_runner {MGPU_VIEWS} steps of 2048 px x 64 rays with "
          f"distillation, s/step after the first: 1 rank {s1:.3f}, 2 ranks over {backend} "
          f"{where} {s2[0]:.3f} / {s2[1]:.3f}; peak memory 1 rank "
          f"{one['cli']['peak'] / 2**30:.3f} GiB, 2 ranks {cli[0]['peak'] / 2**30:.3f} / "
          f"{cli[1]['peak'] / 2**30:.3f} GiB [{card}]", flush=True)
    equal = all(np.array_equal(cli[0]["params"][k], cli[1]["params"][k])
                for k in cli[0]["params"])
    wrote = [os.path.exists(os.path.join(d, f"cli_{backend}{r}")) for r in range(2)]
    trained = ckpt.load_collection(os.path.join(cli[0]["rundir"], "checkpoints"),
                                   ckpt.MODEL, "latest")[0]
    saved = all(np.array_equal(trained[k], cli[0]["params"][k]) for k in trained)
    steps = [s["iter"] for s in cli[0]["stats"]]
    print(f"[multi-gpu] exp_runner on 2 ranks over {backend}: iterations {steps}, "
          f"{[round(s['seconds'], 3) for s in cli[0]['stats']]} s/step, distilled "
          f"{[s['secondary_points'] for s in cli[0]['stats']]} hits; parameters bit for bit "
          f"equal on both ranks: {equal}; run directories written by rank 0 / rank 1: "
          f"{wrote}; rank 0's checkpoint holds its parameters: {saved} [{card}]", flush=True)
    if not (equal and wrote == [True, False] and saved and steps == [0, 1, 2]
            and all(s["secondary_points"] > 0 for s in cli[0]["stats"])):
        raise RuntimeError("[multi-gpu] the 2-rank exp_runner run failed its checks")

    # the render
    render_err = max(float(np.abs(two[r]["render"]["out"][k].astype(np.float64)
                                  - one["render"]["out"][k]).max())
                     for r in range(2) for k in one["render"]["out"])
    print(f"[multi-gpu] {MGPU_RES}^2 render at {MGPU_RENDER_RAYS} rays: 2 ranks over {backend} "
          f"{two[0]['render']['seconds']:.3f} / {two[1]['render']['seconds']:.3f} s, one "
          f"process {one['render']['seconds']:.3f} s; largest difference {render_err:.3e} "
          f"[{card}]", flush=True)
    if not render_err <= MGPU_TOL["render_abs"]:
        raise RuntimeError("[multi-gpu] the 2-rank render differs from one process's")
    return dict(s_per_step_1=s1, s_per_step_2=s2, peak_1=one["cli"]["peak"],
                peak_2=[c["peak"] for c in cli], ranks=report, render_max_abs=render_err,
                cli_params_equal=equal)


def phase_multi_gpu(card):
    """Multi-process training and rendering on the one card: (1) an NCCL
    world of 1 on cuda:0, whose full-width frozen step and distillation
    equal the step without a process group bit for bit; (2) 2 gloo ranks
    with CUDA tensors on cuda:0 (NCCL refuses two ranks on one device): the
    same step within MGPU_TOL of the one-process step, its pool and distilled
    batch equal; 3 steps of exp_runner.main with distillation, after which
    both ranks hold the same parameters and only rank 0 wrote; a 128^2
    16-ray render within MGPU_TOL['render_abs'] of the one-process render.
    Prints s/step of 1 and 2 ranks (2 ranks share one card: not a scaling
    figure) and each rank's peak memory. Where the machine has 2 cards or
    more, the same 2-rank checks run again over NCCL, rank r on cuda:r."""
    import numpy as np
    import torch

    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.utils import checkpoints as ckpt

    text = _conf_text(NO_VIS)
    with tempfile.TemporaryDirectory() as d:
        conf_path = os.path.join(d, "train.conf")
        with open(conf_path, "w") as f:
            f.write(text)
        scene = write_sphere_scene(os.path.join(d, "scene"), MGPU_VIEWS, MGPU_RES)
        mconf = parse_string(text).get_config("model")
        model = IDRNetwork.from_conf(mconf, device=MGPU_DEVICE, seed=0)
        params = ckpt.params_to_jax(model)
        del model
        geo = os.path.join(d, "geometry", "checkpoints")
        ckpt.save_collection(geo, ckpt.MODEL, "latest", params, {"epoch": 0})
        render_exp = os.path.join(d, "render_exp")
        ckpt.save_collection(os.path.join(render_exp, "seed0", "checkpoints"), ckpt.MODEL,
                             "latest", params, {"epoch": 0})
        n_steps = mconf.get_config("ray_tracer").get_int("n_steps")
        spec = dict(dir=d, conf=conf_path, scene=scene, geometry=geo, render_exp=render_exp,
                    steps01=torch.from_numpy(
                        np.random.default_rng(5).random(n_steps).astype(np.float32)),
                    cli_argv=["--conf", conf_path, "--data_split_dir", scene,
                              "--freeze_geometry", "--geometry", geo, "--roughness_warmup", "2",
                              "--secondary_train_interval", "1", "--secondary_batch_size",
                              str(MGPU_HITS), "--max_niter", str(MGPU_VIEWS - 1)],
                    device=MGPU_DEVICE, backend="gloo")
        t0 = time.perf_counter()
        (one,) = _mgpu_run(1, spec, d)
        t1 = time.perf_counter()
        two = _mgpu_run(2, spec, d)
        t2 = time.perf_counter()

        # (1) an NCCL world of 1: bit for bit the step without a group
        plain, nccl = one["plain"], one["nccl"]
        same = (plain["terms"] == nccl["terms"]
                and all(torch.equal(plain["grads"][k], nccl["grads"][k]) for k in plain["grads"])
                and all(torch.equal(plain["params"][k], nccl["params"][k])
                        for k in plain["params"]))
        print(f"[multi-gpu] world of 1 over {one['backend']} on {MGPU_DEVICE}: loss "
              f"{nccl['terms']['loss']:.6f}, the step without a process group "
              f"{plain['terms']['loss']:.6f}; loss, gradients and updated parameters bit for bit "
              f"equal: {same}; {nccl['rays']} rays, {nccl['step_s']:.3f} s (the first step, "
              f"without a group, {plain['step_s']:.3f} s), distillation "
              f"{nccl['secondary_s']:.3f} s ({nccl['distilled']} hits) [{card}]", flush=True)
        if not same or not nccl["finite"] or nccl["distilled"] <= 0:
            raise RuntimeError("[multi-gpu] the NCCL world of 1 differs from the plain step")

        # (2) 2 gloo ranks sharing the card, and 2 NCCL ranks where there are 2 cards
        report = _check_two_ranks(one, two, d, "gloo", card)
        launches = {k: one["launches"][k] + sum(res["launches"][k] for res in two)
                    for k in one["launches"]}
        print(f"[multi-gpu] runs of world 1 / 2: {t1 - t0:.1f} / {t2 - t1:.1f} s; launches "
              f"{launches} [{card}]", flush=True)
        for name in ("fused_sdf_value", "fused_sdf_fwd_bwd"):
            if launches[name] <= 0:
                raise RuntimeError(f"[multi-gpu] the ranks did not launch kernel {name}")
        if torch.cuda.device_count() >= 2:
            report["nccl_2_cards"] = _check_two_ranks(
                one, _mgpu_run(2, dict(spec, backend="nccl"), d), d, "nccl", card)
    return dict(nccl_world1_bit_for_bit=same, **report, launches=launches)


# ---------------------------------------------------------------------------
# 19. render-types
# ---------------------------------------------------------------------------

RT_TYPES = ("path_tracing_sg", "path_tracing", "path_tracing_shadow", "path_tracing_diff_shadow",
            "pt_render_diff_shadow_indirect", "pt_render_diff_shadow_indirect_mlp",
            "pt_render_indirect_mlp_memsave", "pt_render_shadow_indirect_mlp_envmap",
            "pt_render_shadow_indirect_mlp_envmap_memsave",
            "pt_render_diff_shadow_indirect_blend", "pt_render_diff_shadow2_indirect_blend")
RT_RES = 128
RT_RAYS = 16
RT_STEP_TYPES = ("path_tracing_diff_shadow", "pt_render_diff_shadow_indirect_blend",
                 "pt_render_shadow_indirect_mlp_envmap")
RT_LIVE_TYPE = "pt_render_diff_shadow_indirect_mlp"
RT_K3_TYPE = "pt_render_diff_shadow_indirect_mlp"
# the path-traced images of card and CPU: the parity suite's estimator gate
RT_REF_DB = 60.0


def _rt_replace(rt):
    """conf.conf's replacements for render type `rt` (the JAX package's
    dispatch test's): a 128x128x3 constant light for the envmap types, global
    roughness and specular for path_tracing_sg, two global base materials
    for the blend types."""
    from nefii_tpu_torch.models.idr import PT_RENDER_TYPES

    rep = [("render_type = pt_render_indirect_mlp", f"render_type = {rt}")]
    opts = PT_RENDER_TYPES[rt]
    if opts.get("light_type") == "constant":
        rep.append(("white_light = False", "white_light = False\n        light_type = constant"))
    if rt == "path_tracing_sg" or opts.get("blend_materials"):
        rep += [("roughness_mlp = True", "roughness_mlp = False"),
                ("specular_mlp = True", "specular_mlp = False"),
                ("same_mlp = True", "same_mlp = False")]
    if opts.get("blend_materials"):
        rep += [("num_base_materials = 1", "num_base_materials = 2"),
                ("fix_specular_albedo = True", "fix_specular_albedo = False")]
    return rep


class _SecondaryLaunches:
    """Count, by kernel, the launches of the path tracer's secondary rays: in
    their trace ("trace:<kernel>") and in the fused sdf/feature/normal at
    their hits ("shading:<kernel>"), the SceneFns closures of `model`."""

    def __init__(self, model):
        import collections

        self.model, self.counts = model, collections.Counter()

    def _counted(self, fn, part):
        from nefii_tpu_torch.ops.kernels import fused_mlp as fm
        from nefii_tpu_torch.ops.kernels import fused_trace as ft

        def run(*a, **kw):
            before = {**fm.LAUNCHES, **ft.LAUNCHES}
            try:
                return fn(*a, **kw)
            finally:
                for k, v in {**fm.LAUNCHES, **ft.LAUNCHES}.items():
                    self.counts[f"{part}:{k}"] += v - before[k]
        return run

    def __enter__(self):
        real = self.model.scene_fns

        def scene_fns(*a, **kw):
            sf = real(*a, **kw)
            return sf._replace(trace=self._counted(sf.trace, "trace"),
                               implicit_with_grad=self._counted(sf.implicit_with_grad, "shading"))

        self.model.scene_fns = scene_fns
        return self

    def __exit__(self, *exc):
        del self.model.scene_fns


def _rt_view(d, rt, replace, card):
    """One RT_RES^2 view at RT_RAYS rays a pixel of `rt` through RenderRunner,
    from a checkpoint of the seeded init. -> (stats, launches, secondary
    launches, peak memory)."""
    import numpy as np
    import torch

    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.scripts.render import OUTPUT_KEYS, RenderRunner
    from nefii_tpu_torch.utils import checkpoints as ckpt

    conf = parse_string(_conf_text(_rt_replace(rt) + list(replace)))
    exp = os.path.join(d, "exp_" + rt)
    model = IDRNetwork.from_conf(conf.get_config("model"), device="cuda", seed=0)
    ckpt.save_collection(os.path.join(exp, "seed0", "checkpoints"), ckpt.MODEL, "latest",
                         ckpt.params_to_jax(model), {"epoch": 0})
    del model
    scene = os.path.join(d, "scene")
    if not os.path.isdir(scene):
        SceneDataset.write_camera_only_split(scene, 1, RT_RES, focal=160.0)
    runner = RenderRunner(conf=conf, data_split_dir=scene, old_expdir=exp, num_rays=RT_RAYS,
                          out_dir=os.path.join(d, "renders_" + rt), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    with _SecondaryLaunches(runner.model) as sec:
        out = runner.render_view(0)
    torch.cuda.synchronize()
    launches = {**fm.LAUNCHES, **ft.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    for k in OUTPUT_KEYS:
        if not np.isfinite(np.asarray(out[k], np.float64)).all():
            raise RuntimeError(f"[render-types] {rt}: {k} is not finite")
    if runner.model.envmap_material_network.light_type != "sg":
        runner.write_envmap()
    st = runner.stats[0]
    print(f"[render-types] {rt}: {st['seconds']:.3f} s/view ({RT_RES}x{RT_RES}, {RT_RAYS} "
          f"rays/px), hit fraction {st['hit_fraction']:.3f}, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches {launches}, secondary {dict(sec.counts)} [{card}]",
          flush=True)
    return st, launches, dict(sec.counts), peak


def _rt_reference(rt):
    """A REF_RES^2 render of `rt` (fp32 trace) through the kernels on the
    card and through the plain versions on the CPU, the directions injected
    (some into the surface, so that secondary rays hit): the path-traced
    images' PSNR over the rays that hit on both, and REF_KEYS' errors."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.models.idr import IDRNetwork

    mconf = _model_conf(_rt_replace(rt) + [FP32_TRACE]).get_config("model")
    gpu = IDRNetwork.from_conf(mconf, device="cuda", seed=0)
    cpu = IDRNetwork.from_conf(mconf, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    with tempfile.TemporaryDirectory() as d:
        ds = SceneDataset(1.0, SceneDataset.write_camera_only_split(d, 1, REF_RES, focal=20.0),
                          False)
        _, inp, _ = ds.collate([ds[0]])
    outs = []
    with _InjectedDirections(turn=True):
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in inp.items()}
            out = model.forward_with_uv(batch, torch.Generator(device=dev).manual_seed(0))
            outs.append({k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)})
    g, c = outs
    agree = float((g["network_object_mask"] == c["network_object_mask"]).mean())
    both = g["network_object_mask"] & c["network_object_mask"]
    if agree < REF_TOL["mask_agree"] or not both.any():
        raise RuntimeError(f"[render-types] {rt}: hit masks disagree: {agree:.4f}")
    errs = {k: float(np.abs(g[k][both] - c[k][both]).max()) for k in REF_KEYS}
    bad = {k: v for k, v in errs.items() if not v <= REF_TOL["abs"]}
    psnr = {}
    for k in ("sg_rgb_values", "sg_diffuse_rgb_values", "sg_specular_rgb_values"):
        mse = float(np.mean((g[k][both].astype(np.float64) - c[k][both]) ** 2))
        psnr[k] = -10.0 * np.log10(max(mse, 1e-30))
        if not np.isfinite(g[k]).all() or psnr[k] < RT_REF_DB:
            bad[k] = psnr[k]
    if bad:
        raise RuntimeError(f"[render-types] {rt}: the card's render disagrees with the CPU's: "
                           f"{bad}")
    return dict(mask_agreement=agree, max_abs_err=errs, psnr_db=psnr)


def _rt_live_step(d, scene, card):
    """One live-geometry step of RT_LIVE_TYPE (2048 px x 64 rays, a
    distillation step after it) through exp_runner.main: soft visibility and
    the eq. 3 normals at the secondary hits keep their graph."""
    import numpy as np
    import torch

    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.training import exp_runner

    conf_path = os.path.join(d, "live.conf")
    with open(conf_path, "w") as f:
        f.write(_conf_text(NO_VIS + (UNFROZEN_LR,) + tuple(_rt_replace(RT_LIVE_TYPE))))
    argv = ["--conf", conf_path, "--data_split_dir", scene, "--exps_folder_name",
            os.path.join(d, "exps_live"), "--roughness_warmup", "2",
            "--secondary_train_interval", "1", "--secondary_batch_size", "1024",
            "--max_niter", "0", "--device", "cuda"]
    print("[render-types] live: python -m nefii_tpu_torch.training.exp_runner "
          + " ".join(argv), flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    runner = exp_runner.main(argv)
    torch.cuda.synchronize()
    launches = {**fm.LAUNCHES, **ft.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    st = runner.step_stats[0]
    print(f"[render-types] live {RT_LIVE_TYPE}: {st['seconds']:.3f} s/step, secondary step "
          f"{st['secondary_seconds']:.3f} s, remat {runner.remat}, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches {launches} [{card}]", flush=True)
    if runner.freeze_geo or not np.isfinite(st["loss"]) or st["secondary_points"] <= 0:
        raise RuntimeError(f"[render-types] the live step failed: {st}")
    return dict(s_per_step=[st["seconds"]], secondary_s=[st["secondary_seconds"]],
                max_memory_allocated=peak, launches=launches, remat=runner.remat)


def phase_render_types(card):
    """The render types of the slice at full width: a view of each through
    RenderRunner (the secondary rays' launches gated), the card-against-CPU
    check of each, frozen and distillation steps, one live step, and a view
    with K3 serving a soft-visibility path."""
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.models.idr import PT_RENDER_TYPES

    t0 = time.perf_counter()
    res = {"views": {}, "reference": {}, "steps": {}}
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as d:
        for rt in RT_TYPES:
            st, launches, sec, peak = _rt_view(d, rt, (), card)
            opts = PT_RENDER_TYPES[rt]
            res["views"][rt] = dict(s_per_view=st["seconds"], hit_fraction=st["hit_fraction"],
                                    sdf_evals=st["sdf_evals"], max_memory_allocated=peak,
                                    launches=launches, secondary_launches=sec)
            add(launches)
            if opts.get("shadow") is not None and sec.get("trace:fused_sdf_value", 0) <= 0:
                raise RuntimeError(f"[render-types] {rt}: the secondary trace did not launch "
                                   f"K1's sdf entry: {sec}")
            if opts.get("shadow") == "indirect" and not opts.get("diff_geo") and \
                    sec.get("shading:fused_sdf_fwd_bwd", 0) <= 0:
                raise RuntimeError(f"[render-types] {rt}: K2 did not serve the secondary hits: "
                                   f"{sec}")
        st, launches, sec, peak = _rt_view(d, RT_K3_TYPE, (K3_ON,), card)
        res["views"]["k3_" + RT_K3_TYPE] = dict(
            s_per_view=st["seconds"], max_memory_allocated=peak, launches=launches,
            secondary_launches=sec)
        add(launches)
        if sec.get("trace:fused_sphere_trace", 0) <= 0:
            raise RuntimeError(f"[render-types] K3 did not serve the secondary trace: {sec}")

        scene = write_sphere_scene(os.path.join(d, "train_scene"), 1, TRAIN_RES)
        for rt in RT_STEP_TYPES:
            _, summary = _step2("rt_" + rt, d, _rt_replace(rt), scene, 1, (), card)
            res["steps"][rt] = summary
            add(summary["launches"])
        res["steps"]["live_" + RT_LIVE_TYPE] = live = _rt_live_step(d, scene, card)
        add(live["launches"])

        for rt in RT_TYPES:
            res["reference"][rt] = ref = _rt_reference(rt)
            print(f"[render-types] {rt}: card vs cpu at {REF_RES}x{REF_RES} rays: mask "
                  f"agreement {ref['mask_agreement']:.4f}, PSNR {ref['psnr_db']}, max abs err "
                  f"{ref['max_abs_err']}", flush=True)
    res["launches"] = total
    res["seconds"] = time.perf_counter() - t0
    print(f"[render-types] {res['seconds']:.1f} s; launches {total} [{card}]", flush=True)
    return res


TOOLS_RES = 256            # the subsample run's scene, trained at 128x128 (--subsample 0.5)
TOOLS_VIEWS = 4
TOOLS_STEPS = 4            # one epoch of the 4 views (the trainer stops at an epoch's end)
TOOLS_SUBSAMPLE = 0.5
SWEEP_RES = 128
SWEEP_RAYS = 16
SWEEP_STEP_DEG = 180       # two renders: 0 and 180 degrees
IDR_PIXELS = ("64,64", "80,52")
IDR_TOL = 1e-4             # the card's hemisphere colours against the CPU's, absolute
SG_FIT_SHAPE = (256, 512)
SG_FIT_SGS = 128
SG_FIT_STEPS = 200
SG_FIT_CHECKED = 3         # steps held against the CPU's from a shared init
SG_FIT_REL = 1e-4
TOOLS_KERNELS = ("fused_sdf_value", "fused_sdf_fwd_bwd")
IDR_KERNELS = ("fused_sdf_hidden", "fused_sdf_fwd_bwd")


def _fit_steps(fit, gt, init, n, device):
    """fit_envmap_sg for n steps from `init`, logging each: -> ([lobes after
    each step], the final loss)."""
    steps = []
    real = fit._save_progress
    fit._save_progress = lambda lgt, *a: steps.append(lgt)
    try:
        _, loss = fit.fit_envmap_sg(gt, SG_FIT_SGS, "mitsuba", n, 1e-2, init=init, log_every=1,
                                    out_dir="unused", device=device)
    finally:
        fit._save_progress = real
    return steps, loss


def _workflow(script, args, cwd, env):
    """bash nefii_tpu_torch/workflows/<script> args; raises unless it exits 0."""
    path = os.path.join(ROOT, "nefii_tpu_torch", "workflows", script)
    t0 = time.perf_counter()
    r = subprocess.run(["bash", path, *args], cwd=cwd, capture_output=True, text=True,
                       env={**os.environ, "PYTHON": sys.executable, **env}, timeout=600)
    seconds = time.perf_counter() - t0
    print(f"[tools] bash {script}: exit {r.returncode} in {seconds:.1f} s", flush=True)
    if r.returncode != 0:
        raise RuntimeError(f"[tools] {script} exited {r.returncode}:\n{r.stdout[-4000:]}\n"
                           f"{r.stderr[-4000:]}")
    return seconds


def phase_tools(card):
    """Phase 20: the dataset subsample, the offline tools and the workflows
    on the card. A subsample run (exp_runner --subsample 0.5, frozen
    geometry, one epoch of 2048 px x 64 rays a step with distillation on a
    4-view 256x256 sphere trained at 128x128); the relighting sweep and
    idr_color_analyze on its checkpoint (the latter against its own
    --device cpu run); the SG fit (128 SGs on a 256x512 map, its first steps
    against the CPU's); neus2nefii.sh and run_s2_wmask.sh through bash."""
    import numpy as np
    import torch

    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.datasets.synthetic import write_neus_scene, write_sphere_scene
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.sg import compute_envmap
    from nefii_tpu_torch.scripts import fit_envmap_with_sg as fit
    from nefii_tpu_torch.scripts import idr_color_analyze, vis_rotate_envlight
    from nefii_tpu_torch.utils import exr

    t0 = time.perf_counter()
    res = {}
    total = {}

    def counted(fn):
        torch.cuda.synchronize()
        fm.reset_launch_counts()
        ft.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = {**fm.LAUNCHES, **ft.LAUNCHES}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out, launches

    with tempfile.TemporaryDirectory() as d:
        # ---- the subsample run -------------------------------------------------
        scene = write_sphere_scene(os.path.join(d, "scene"), TOOLS_VIEWS, TOOLS_RES)
        runner, summary = _step2("tools-subsample", d, (), scene, TOOLS_STEPS,
                                 ["--subsample", str(TOOLS_SUBSAMPLE)], card)
        for k, v in summary["launches"].items():
            total[k] = total.get(k, 0) + v
        ds = runner.train_dataset
        full = SceneDataset(1.0, scene, False)
        want_res = [int(TOOLS_RES * TOOLS_SUBSAMPLE)] * 2
        for K, K0 in zip(ds.intrinsics_all, full.intrinsics_all):
            want = K0.copy()
            want[[0, 0, 1, 1], [0, 2, 1, 2]] *= TOOLS_SUBSAMPLE
            if not np.array_equal(K, want):
                raise RuntimeError(f"[tools] K not scaled by {TOOLS_SUBSAMPLE}: {K} vs {K0}")
        losses = [v for st in runner.step_stats for k, v in st.items() if k.endswith("loss")]
        if ds.img_res != want_res or not np.isfinite(losses).all():
            raise RuntimeError(f"[tools] subsample run: img_res {ds.img_res} (want {want_res}) "
                               f"or a loss not finite: {losses}")
        if any(summary["launches"][n] <= 0 for n in TOOLS_KERNELS):
            raise RuntimeError(f"[tools] the subsample run did not launch {TOOLS_KERNELS}: "
                               f"{summary['launches']}")
        res["subsample"] = {k: summary[k] for k in ("s_per_step", "secondary_s",
                                                    "max_memory_allocated", "launches")}
        res["subsample"]["img_res"] = ds.img_res
        conf = os.path.join(d, "tools-subsample.conf")
        exp = ["--conf", conf, "--old_expdir", runner.expdir, "--timestamp", runner.timestamp]

        # ---- the relighting sweep ----------------------------------------------
        views = SceneDataset.write_camera_only_split(os.path.join(d, "views"), 1, SWEEP_RES,
                                                     focal=160.0)
        out = os.path.join(d, "sweep")
        vr, launches = counted(lambda: vis_rotate_envlight.main(
            exp + ["--data_split_dir", views, "--step_deg", str(SWEEP_STEP_DEG), "--num_rays",
                   str(SWEEP_RAYS), "--out_dir", out, "--device", "cuda"]))
        imgs = [exr.read(os.path.join(out, f"rot_{a:03d}", "render.exr"))
                for a in range(0, 360, SWEEP_STEP_DEG)]
        if any(i.shape != (SWEEP_RES, SWEEP_RES, 3) or not np.isfinite(i).all() for i in imgs) \
                or np.array_equal(imgs[0], imgs[1]):
            raise RuntimeError("[tools] the sweep's renders are not finite or do not differ")
        if any(launches[n] <= 0 for n in TOOLS_KERNELS):
            raise RuntimeError(f"[tools] the sweep did not launch {TOOLS_KERNELS}: {launches}")
        s_view = [st["seconds"] for st in vr.stats]
        res["sweep"] = dict(s_per_view=s_view, launches=launches,
                            max_abs_diff_between_angles=float(np.abs(imgs[0] - imgs[1]).max()))
        print(f"[tools] relighting sweep: {len(s_view)} views of {SWEEP_RES}x{SWEEP_RES} at "
              f"{SWEEP_RAYS} rays/px, s/view {s_view}; launches {launches} [{card}]", flush=True)

        # ---- idr_color_analyze, card against CPU -------------------------------
        argv = exp + ["--data_split_dir", views, "--pixels", *IDR_PIXELS]
        t1 = time.perf_counter()
        got, launches = counted(lambda: idr_color_analyze.main(
            argv + ["--out_dir", os.path.join(d, "idr_card"), "--device", "cuda"]))
        idr_s = time.perf_counter() - t1
        cpu = idr_color_analyze.main(argv + ["--out_dir", os.path.join(d, "idr_cpu"),
                                             "--device", "cpu"])
        err = max(float(np.abs(a - b).max()) for a, b in zip(got["colors"], cpu["colors"]))
        print(f"[tools] idr_color_analyze: {len(IDR_PIXELS)} pixels, hit {got['hit'].tolist()} "
              f"(cpu {cpu['hit'].tolist()}), card vs cpu max abs err {err:.3g} (tol {IDR_TOL}); "
              f"{idr_s:.2f} s; launches {launches} [{card}]", flush=True)
        if not np.array_equal(got["hit"], cpu["hit"]) or not err <= IDR_TOL:
            raise RuntimeError(f"[tools] idr_color_analyze: the card disagrees with the CPU")
        if any(launches[n] <= 0 for n in IDR_KERNELS):
            raise RuntimeError(f"[tools] idr_color_analyze did not launch {IDR_KERNELS}: "
                               f"{launches}")
        res["idr_color_analyze"] = dict(seconds=idr_s, max_abs_err=err, launches=launches,
                                        hit=got["hit"].tolist())

        # ---- the SG fit ---------------------------------------------------------
        rs = np.random.RandomState(0)
        sgs = rs.randn(16, 7).astype(np.float32)
        sgs[:, 3] = np.abs(sgs[:, 3]) * 20.0
        sgs[:, 4:] = np.abs(sgs[:, 4:])
        with torch.no_grad():
            gt = compute_envmap(torch.as_tensor(sgs, device="cuda"), *SG_FIT_SHAPE).cpu().numpy()
        init = torch.randn((SG_FIT_SGS, 7), generator=torch.Generator().manual_seed(0)).numpy()
        init[:, 3] *= 100.0
        card_steps, _ = _fit_steps(fit, gt, init, SG_FIT_CHECKED, "cuda")
        cpu_steps, _ = _fit_steps(fit, gt, init, SG_FIT_CHECKED, "cpu")
        rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(card_steps, cpu_steps))
        _, loss0 = fit.fit_envmap_sg(gt, SG_FIT_SGS, n_iter=0, init=init, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, loss = fit.fit_envmap_sg(gt, SG_FIT_SGS, n_iter=SG_FIT_STEPS, lr=1e-2, init=init,
                                    device="cuda")
        fit_s = (time.perf_counter() - t1) / SG_FIT_STEPS
        print(f"[tools] SG fit: {SG_FIT_SGS} SGs on {SG_FIT_SHAPE[0]}x{SG_FIT_SHAPE[1]}, first "
              f"{SG_FIT_CHECKED} steps card vs cpu rel {rel:.3g} (tol {SG_FIT_REL}); loss "
              f"{loss0:.6g} -> {loss:.6g} in {SG_FIT_STEPS} steps, {fit_s * 1e3:.3f} ms/step "
              f"[{card}]", flush=True)
        if not rel <= SG_FIT_REL or not loss < loss0:
            raise RuntimeError("[tools] the SG fit disagrees with the CPU or its loss did not fall")
        res["sg_fit"] = dict(s_per_step=fit_s, loss_start=loss0, loss_end=loss, rel_err=rel)

        # ---- the workflows ------------------------------------------------------
        data = os.path.join(d, "data")
        write_sphere_scene(os.path.join(data, "ball", "train"), 2, SWEEP_RES)
        write_sphere_scene(os.path.join(data, "ball", "test"), 1, SWEEP_RES)
        env = {"DATA_PATH": data, "SAVE_PATH": os.path.join(d, "wf_exps")}
        res["workflows"] = {
            "neus2nefii.sh": _workflow("neus2nefii.sh", [write_neus_scene(
                os.path.join(d, "neus")), os.path.join(d, "converted")], d, env),
            "run_s2_wmask.sh": _workflow("run_s2_wmask.sh", [
                "ball", os.path.join(runner.expdir, runner.timestamp, "checkpoints"),
                "--conf", conf, "--max_niter", "1"], d, env)}
        if not os.path.isfile(os.path.join(d, "converted", "train", "cam_dict_norm.json")):
            raise RuntimeError("[tools] neus2nefii.sh wrote no cam_dict_norm.json")
    res["launches"] = total
    res["seconds"] = time.perf_counter() - t0
    print(f"[tools] {res['seconds']:.1f} s; launches {total} [{card}]", flush=True)
    return res


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
    unfrozen_ref = phase_train_reference(live=True)
    render_launches, stats = phase_render(card)
    launches, train = phase_train(card)
    physg = phase_physg(card)
    unfrozen = phase_unfrozen(card)
    neus = phase_neus(card)
    geometry = phase_geometry(card)
    cameras_ref = phase_train_reference(live=True, cameras=True)
    cameras = phase_cameras(card)
    view_diff = phase_view_diff(card)
    fast = phase_fast_multi_ray(card)
    mgpu = phase_multi_gpu(card)
    rtypes = phase_render_types(card)
    tools = phase_tools(card)
    print(json.dumps({"render": stats, "reference": ref, "train_reference": train_ref,
                      "unfrozen_reference": unfrozen_ref, "train": train, "physg": physg,
                      "unfrozen": unfrozen, "neus": neus, "trace_kernel": trace,
                      "geometry": geometry, "cameras_reference": cameras_ref,
                      "cameras": cameras, "view_diff": view_diff, "fast_multi_ray": fast,
                      "multi_gpu": {k: v for k, v in mgpu.items() if k != "launches"},
                      "render_types": {k: v for k, v in rtypes.items() if k != "launches"},
                      "tools": {k: v for k, v in tools.items() if k != "launches"},
                      "card": card}), flush=True)
    src = "nefii_tpu_torch/ops/kernels/csrc/fused_mlp.cu"
    tc_src = "nefii_tpu_torch/ops/kernels/csrc/sdf_mlp_tc.cuh"
    k1 = "nefii_tpu/ops/pallas/fused_mlp.py:136"
    ref_launches = train_ref.pop("launches")
    # launches: the frozen training run's (the first slice's main path); the
    # render's, the fp32 train-reference step's and the live-geometry paths'
    # (the PhySG run, the unfrozen runs without and with remat, the
    # unfrozen-reference step) beside them. No single PyTorch call computes an
    # MLP chain or a sphere trace, so every library_ms is null.
    live = {"physg_launches": physg.pop("launches"),
            "unfrozen_launches": unfrozen["no_remat"].pop("launches"),
            "unfrozen_remat_launches": unfrozen["remat"].pop("launches"),
            "unfrozen_reference_launches": unfrozen_ref.pop("launches"),
            "neus_launches": neus.pop("launches"),
            "cameras_reference_launches": cameras_ref.pop("launches"),
            "cameras_launches": cameras.pop("launches"),
            "view_diff_launches": view_diff.pop("launches"),
            "fast_multi_ray_launches": fast.pop("launches"),
            "fast_multi_ray_render_launches": fast.pop("render_launches"),
            "multi_gpu_launches": mgpu["launches"],
            "render_types_launches": rtypes["launches"],
            "tools_launches": tools["launches"]}

    def paths(name):
        return {k: v[name] for k, v in live.items()}

    records = [
        dict(name="fused_sdf_hidden_tc", route="cuda", source=tc_src, replaces=k1,
             launches=launches["fused_sdf_hidden_tc"], **paths("fused_sdf_hidden_tc"),
             render_launches=render_launches["fused_sdf_hidden_tc"], dtype="bfloat16",
             design="wgmma m64n256k16, bulk-copy weight ring", library_ms=None, **kern["k1_tc"]),
        dict(name="fused_sdf_value", route="cuda", source=tc_src, replaces=k1,
             launches=launches["fused_sdf_value"], **paths("fused_sdf_value"),
             render_launches=render_launches["fused_sdf_value"], dtype="bfloat16",
             design="the tensor-core K1 with the sdf column in its epilogue", library_ms=None,
             **kern["sdf_value"]),
        dict(name="fused_sdf_hidden", route="cuda", source=src, replaces=k1,
             launches=launches["fused_sdf_hidden"], **paths("fused_sdf_hidden"),
             render_launches=render_launches["fused_sdf_hidden"],
             reference_launches=ref_launches["fused_sdf_hidden"], dtype="float32",
             design="FMA pipe", library_ms=None, **kern["k1_fp32"]),
        dict(name="fused_sdf_fwd_bwd", route="cuda",
             source="nefii_tpu_torch/ops/kernels/csrc/sdf_mlp_split.cuh",
             replaces="nefii_tpu/ops/pallas/fused_mlp.py:240",
             launches=launches["fused_sdf_fwd_bwd"], **paths("fused_sdf_fwd_bwd"),
             render_launches=render_launches["fused_sdf_fwd_bwd"], dtype="float32",
             design="split bf16 (hi.hi + lo.hi + hi.lo) on wgmma m64n256k16, bulk-copy "
                    "weight ring", library_ms=None, **kern["k2"]),
        dict(name="fused_sphere_trace", route="cuda",
             source="nefii_tpu_torch/ops/kernels/csrc/fused_trace.cu",
             replaces="nefii_tpu/ops/pallas/fused_trace.py:81",
             launches=launches["fused_sphere_trace"], **paths("fused_sphere_trace"),
             dtype="float32",
             design="split fp16 (hi.hi + lo.hi + hi.lo, weights scaled by 2^s per layer) on "
                    "wgmma m64n256k16 over a refilled pool of 32 live rays a block, bulk-copy "
                    "weight ring", library_ms=None,
             **{k: trace["camera"][k] for k in ("max_abs_err", "ms", "kernel_alone_ms",
                                                "plain_ms", "bound_ms", "bound_by", "fill",
                                                "waste", "evals_needed", "evals_executed",
                                                "near_share", "retrace_evals")},
             random_rays=trace["random"], random_rays_secondary_conf=trace["random_secondary"]),
    ]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
