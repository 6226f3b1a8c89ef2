"""The port's kernels against their plain PyTorch versions on the card: the
tolerances of those comparisons, in one place, and the nets and rays they run
on. tests/test_torch_port_cuda.py calls the gates; chip_smoke.py calls them
on the kernels it times (phases 3 and 4) and on its Step-1 fit (phase 13).
Each gate raises AssertionError naming what failed and returns its figures.

fp32 within FP32_ABS (FMA chain vs cuBLAS summation order over 8 layers of
512-long dot products; K2's split bf16 stays within ~1e-5 of the fp32 chain);
bf16 within BF16_REL of the largest value (one bf16 rounding of h flipped by
the order propagates); K2's input gradient within GRAD_REL of its largest
value. K3: see check_k3. On a whole view at most NEAR_SHARE of the rays are
near, and NEAR_DELTA covers the worst |split-fp16 sdf - fp32 sdf| at the
rays' points NEAR_MARGIN times over.
"""

import os
import tempfile

import numpy as np
import torch

from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.ops.kernels import fused_trace as ft

ROOT = os.path.dirname(os.path.abspath(__file__))
FP32_ABS, BF16_REL, GRAD_REL = 1e-4, 1e-2, 1e-3
AGREE, EVALS_REL, NEAR_DIFFER = 0.999, 0.01, (2, 0.05)
NEAR_SHARE, NEAR_MARGIN = 0.10, 2.0
N_RAYS, TRACE_RES = 262_144, 512
NEUS_SEED = 7  # NeuS's net in chip_smoke.py's phases 3, 4 and 12 and on the test's view


def _model_conf(name):
    from nefii_tpu_torch.config import parse_file

    return parse_file(os.path.join(ROOT, "confs", name)).get_config("model")


def sdf_net(conf, device, seed=0):
    """The SDF net of confs/<conf> (conf.conf: 8x512, conf_neus.conf: NeuS's
    8x256) at its seeded init."""
    from nefii_tpu_torch.models.implicit import ImplicitNetwork

    mconf = _model_conf(conf)
    net = ImplicitNetwork(feature_vector_size=mconf.get_int("feature_vector_size"), device=device,
                          **mconf.get_config("implicit_network").as_plain_dict())
    net.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return net


def conf_tracer(secondary=False):
    """The primary tracer of confs/conf.conf, or its secondary tracer (the
    secondary_ray_tracer block over the primary's settings, as IDRNetwork
    builds it)."""
    from nefii_tpu_torch.models.idr import _dense_tracer_conf
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    conf = _model_conf("conf.conf")
    tc = _dense_tracer_conf(conf.get_config("ray_tracer").as_plain_dict())
    if secondary:
        tc = {**tc, **_dense_tracer_conf(conf.get_config("secondary_ray_tracer").as_plain_dict())}
    return RayTracer(**tc)


def trace_rays(tracer, device):
    """N_RAYS rays through one TRACE_RES^2 view of the seeded-init sphere: the
    camera rays of the view in scan order (coherent tiles) and random pixels
    of it in random order (incoherent, like a training batch).
    -> {name: (cam, dirs, mask_intersect, near, far)}"""
    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.utils.camera import get_camera_params, get_sphere_intersection

    with tempfile.TemporaryDirectory() as d:
        ds = SceneDataset(1.0, SceneDataset.write_camera_only_split(
            d, 1, TRACE_RES, focal=1.25 * TRACE_RES), False)
        _, inp, _ = ds.collate([ds[0]])
    uv_rand = np.random.default_rng(0).random((N_RAYS, 2)).astype(np.float32) * TRACE_RES
    sets = {}
    for name, uv in (("camera", inp["uv"][0]), ("random", uv_rand)):
        dirs, cam_loc = get_camera_params(
            torch.as_tensor(uv[None], device=device),
            torch.as_tensor(inp["pose"], device=device),
            torch.as_tensor(inp["intrinsics"], device=device))
        si, mi = get_sphere_intersection(cam_loc, dirs, r=tracer.object_bounding_sphere)
        n = dirs.shape[1]
        sets[name] = (cam_loc.expand(n, 3).contiguous(), dirs[0].contiguous(), mi.reshape(n),
                      si[..., 0].reshape(n).contiguous(), si[..., 1].reshape(n).contiguous())
    return sets


def _hold(ok, what):
    if not ok:
        raise AssertionError(what)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_k1(fw, x, h, *sdfs):
    """K1 on the packing `fw`: its hidden entry's h on the embedded points x
    (None: not run) and its sdf entry's sdf (each of `sdfs`) on the same
    points against their plain versions, finite; fp32 within FP32_ABS and each
    sdf equal bit for bit to sdf_column of h (the FMA K1 sums its sdf column
    in that order), bf16 within BF16_REL of the largest value.
    -> {"h": worst error, "sdf": worst error}"""
    n, fp32, figs = x.shape[0], fw.dtype == torch.float32, {}
    if h is not None:
        ref = fm.fused_hidden_plain(x, fw).float()
        _hold(h.shape == (n, fw.width) and bool(torch.isfinite(h).all()),
              f"K1's h: shape {tuple(h.shape)} at width {fw.width}, or not finite")
        figs["h"] = _err(h, ref)
        _hold(figs["h"] <= (FP32_ABS if fp32 else BF16_REL * ref.abs().max().item()),
              f"K1 {fw.dtype} at {n} points: h {figs['h']} off its plain version")
    if sdfs:
        ref = fm.fused_sdf_value_plain(x, fw)
        for s in sdfs:
            _hold(s.shape == (n,) and s.dtype == torch.float32 and bool(torch.isfinite(s).all()),
                  f"K1's sdf: shape {tuple(s.shape)}, {s.dtype}, or not finite")
            if fp32 and h is not None:
                _hold(torch.equal(s, fm.sdf_column(h[:, :fw.real_width], fw.w_last[:, 0],
                                                   fw.b_last[0])),
                      f"K1 fp32's sdf at {n} points is not sdf_column of its h")
        figs["sdf"] = max(_err(s, ref) for s in sdfs)
        _hold(figs["sdf"] <= (FP32_ABS if fp32 else BF16_REL * ref.abs().max().item()),
              f"K1 {fw.dtype} at {n} points: sdf {figs['sdf']} off its plain version")
    return figs


def check_k2(fw, x, h, dx):
    """K2's h and input gradient dx on the embedded points x against its fp32
    plain version: h within FP32_ABS, dx within GRAD_REL of its largest value.
    -> {"h": worst error, "dx": worst error}"""
    h_r, dx_r = fm.fused_fwd_bwd_plain(x, fw)
    _hold(h.shape == (x.shape[0], fw.width) and dx.shape == (x.shape[0], fw.x_cols),
          f"K2's shapes {tuple(h.shape)}, {tuple(dx.shape)}")
    figs = {"h": _err(h, h_r), "dx": _err(dx, dx_r)}
    _hold(figs["h"] <= FP32_ABS and figs["dx"] <= GRAD_REL * dx_r.abs().max().item(),
          f"K2 at {x.shape[0]} points off its plain version: {figs}")
    return figs


def check_k3_k1(out, k1):
    """K3's trace `out` against the K1-fp32 trace `k1` of the same rays.
    -> the largest end error"""
    unf, hit, err = ft.agreement(out, k1)
    _hold(unf == hit == 0 and err <= FP32_ABS,
          f"K3 against the K1-fp32 trace: {unf} unfinished and {hit} hit flags differ, "
          f"ends {err} apart")
    return err


def check_k3_near(fw, rays, stats, ref):
    """A whole view's near rays (K3's `stats`): at most NEAR_SHARE of them,
    and NEAR_DELTA NEAR_MARGIN times the worst |split fp16 sdf - fp32 sdf|
    (the plain versions of K3's chain and of the fp32 chain) at the points
    where the rays' decisions fall: each ray's first points (near, far), the
    fp32 trace `ref`'s ends and their midpoint. -> that error"""
    cam, dirs, mi, near, far = rays
    worst = 0.0
    for t in (near, far, ref[0], ref[1], 0.5 * (ref[0] + ref[1])):
        pts = (cam + t[:, None] * dirs)[mi]
        for i in range(0, pts.shape[0], 65536):
            p = pts[i:i + 65536]
            worst = max(worst, _err(ft._sdf_plain(p, fw, split=True), ft._sdf_plain(p, fw)))
    n = cam.shape[0]
    _hold(stats["n_near"] <= NEAR_SHARE * n, f"K3: {stats['n_near']} of {n} rays near")
    _hold(ft.NEAR_DELTA >= NEAR_MARGIN * worst,
          f"NEAR_DELTA {ft.NEAR_DELTA} under {NEAR_MARGIN} times the split-fp16 error {worst}")
    return worst


def check_k3(fw, tracer, rays, out, stats, k1, view=False, fp32_pair=False):
    """K3's trace `out` of `rays` under `tracer` on the packing `fw` (`stats`
    as fused_sphere_trace fills them). Against the K1-fp32 trace `k1`, whose
    arithmetic the re-trace shares: check_k3_k1. Against its fp32 plain
    version, which sums in cuBLAS's order and may decide a stop test within
    fp32 rounding of the threshold otherwise: AGREE of the unfinished flags,
    the ends within FP32_ABS on the rays that agree, the evaluations within
    EVALS_REL (and adding up: the re-trace's, every tile's rows); its near
    flags as the split-fp16 plain version's up to NEAR_DIFFER (a sum at the
    edge of NEAR_DELTA falls either side). With `view` (a whole view): the
    view hits and misses; the kernel alone (before the re-trace) holds AGREE
    of its unfinished and of its hit flags and the ends; the evaluations
    within EVALS_REL of k1's, what the rays need; check_k3_near. With
    `fp32_pair` (NeuS's 8x256 net, where the two fp32 traces leave the exit
    end of a few hit rays a line-search back-step, ~4e-4, apart) the two
    fp32 traces agree on AGREE of the rays, and the ends are held on those
    (the kernel alone's also off its near rays, which it does not decide as
    fp32 does). -> the figures"""
    n = rays[0].shape[0]
    ref = ft.fused_sphere_trace_plain(*rays, fw, tracer)
    split_near = ft._trace_plain(*rays, fw, tracer, split=True)[4]
    figs = {"k1_fp32_err": check_k3_k1(out, k1),
            "near_differ": int((stats["near"] != split_near).sum())}
    _hold(stats["n_near"] == int(stats["near"].sum())
          and figs["near_differ"] <= NEAR_DIFFER[0] + NEAR_DIFFER[1] * int(split_near.sum()),
          f"K3's {stats['n_near']} near flags: {figs['near_differ']} differ from the split "
          f"plain version's {int(split_near.sum())}")
    keep = torch.ones_like(ref[2])
    if fp32_pair:
        keep = ((k1[2] == ref[2]) & ((k1[0] < k1[1]) == (ref[0] < ref[1]))
                & (torch.maximum((k1[0] - ref[0]).abs(), (k1[1] - ref[1]).abs()) <= FP32_ABS))
        _hold(int(keep.sum()) >= AGREE * n, f"the two fp32 traces part on {n - int(keep.sum())}")

    def ends(a, rows):
        return ft.agreement(*(tuple(t[rows] for t in x[:3]) for x in (a, ref)))[2]

    figs.update(agree=(out[2] == ref[2]).float().mean().item(), plain_err=ends(out, keep))
    _hold(figs["agree"] >= AGREE and figs["plain_err"] <= FP32_ABS,
          f"K3 against its plain version: {figs}")
    _hold(abs(stats["evals"] - ref[3]) <= EVALS_REL * ref[3]
          and stats["evals"] + stats["retrace_evals"] == out[3]
          and stats["tiles"] * fm.TC_BLOCK_ROWS == stats["evals"] + stats["empty_rows"],
          f"K3's evaluations {stats['evals']} + {stats['retrace_evals']} = {int(out[3])} in "
          f"{stats['tiles']} tiles, the plain version's {int(ref[3])}")
    if view:
        hits = int((out[0] < out[1]).sum())
        *alone, alone_near, _ = ft._trace_kernel(*rays, fw, tracer)
        a_unf, a_hit, _ = ft.agreement(alone, ref)
        figs["alone_err"] = ends(alone, keep & ~alone_near if fp32_pair else keep)
        _hold(0 < hits < n and n - max(a_unf, a_hit) >= AGREE * n
              and figs["alone_err"] <= FP32_ABS
              and abs(stats["evals"] - k1[3]) <= EVALS_REL * k1[3],
              f"K3 on a view: {hits} of {n} hit; the kernel alone: {a_unf} unfinished and "
              f"{a_hit} hit flags off the plain version, ends {figs['alone_err']}; evaluations "
              f"{stats['evals']}, the K1-fp32 trace's {int(k1[3])}")
        figs["split_sdf_err"] = check_k3_near(fw, rays, stats, ref)
    return figs
