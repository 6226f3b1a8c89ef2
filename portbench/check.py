"""The check that decides `correct`: the plain reference follows the steps or
chunks the program ran, and each number here measures a gap between the two.

Training (three steps, the first a distillation iteration):
  loss_gap         the relative gap of the first step's loss (the later
                   steps' losses part by Adam's round-off, printed beside
                   as a detail; the updates are held by update_gap)
  distil_loss_gap  the relative gap of the distillation step's loss
  grad_gap         the first gradient, by the worst leaf: |‖g_prog‖ - ‖g_ref‖|
                   over the larger of ‖g_ref‖ and the median leaf's norm; the
                   program's gradient is read from its Adam state (m / (1 - b1))
  update_gap       the parameters' change over the three steps, by the worst
                   leaf, likewise; leaves whose first reference gradient is
                   under a thousandth of the median leaf's are left out (they
                   move by round-off alone)
Rendering (the sampled chunks): shade_gap, the largest absolute gap of an
output (normal, albedo, roughness, specular, rgb) of a pixel.
Both: trace_flip_share, the share of primary rays whose hit the program and
the reference's own trace decide differently; trace_point_gap, the 99th
percentile of the distance between their surface points on rays both hit;
sec_flip_share, the same share on a sample of the secondary rays; and
gt_mismatch (training), the pixels whose ground truth in the program's
batch is not the benchmark's image.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

from portbench import flops
from portbench.reference import pipeline as R
from portbench.reference.tracer import Tracer


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and the median leaf's."""
    nr = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    med = sorted(nr.values())[len(nr) // 2]
    return {k: abs(float(torch.linalg.norm(prog[k].double())) - nr[k]) / max(nr[k], med, 1e-30)
            for k in ref}


def worst(gaps: Dict[str, float]) -> str:
    k = max(gaps, key=gaps.get)
    return f"{k} {gaps[k]:.3g}"


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    n = {k: float(torch.linalg.norm(v.double())) for k, v in grads.items()}
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= 1e-3 * med]


# ---- the traces ------------------------------------------------------------------

def trace_stage(model: R.Model, P, tracer_conf: Dict, cam, dirs, hit, pts, consider, q=None,
                chunk: int = 1 << 16):
    """Trace rays (cam [N,3], dirs [N,3]) with the reference tracer and
    compare with the program's (hit [N], points [N,3]) on the rays in
    `consider` [N]. -> (flips, rays, point gaps [k], evaluations)."""
    tr = Tracer(tracer_conf)
    flips, gaps = 0, [cam.new_zeros(0)]
    sdf = (lambda x: model.sdf.sdf(P, x, q))
    with torch.no_grad():
        for i in range(0, cam.shape[0], chunk):
            p2, h2, _ = tr(sdf, cam[i:i + chunk], dirs[i:i + chunk])
            c = consider[i:i + chunk]
            flips += int(((h2 != hit[i:i + chunk]) & c).sum())
            both = h2 & hit[i:i + chunk] & c
            gaps.append(torch.linalg.norm(p2[both] - pts[i:i + chunk][both], dim=-1))
    return flips, int(consider.sum()), torch.cat(gaps), tr.evals


def p99(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    return float(torch.quantile(x.double(), 0.99)) if x.numel() < 1 << 24 else float(x.max())


SEC_SAMPLE = 1 << 15  # secondary rays a step or chunk whose trace is held to the reference's


def sample_secondary(events, n: int, gen: torch.Generator):
    """A seeded sample of n rays of the first secondary trace recorded."""
    for ev in events:
        if ev[0] == "trace" and ev[1].shape[0]:
            _, o, d, p, h, _ = ev
            idx = torch.randperm(o.shape[0], generator=gen, device="cpu")[:n].to(o.device)
            return o[idx], d[idx], h[idx], p[idx]
    return None


# ---- the work the step needs ------------------------------------------------------

class Work:
    """FLOPs a step needs, split by the precision the configuration
    declares for them (the trace's SDF evaluations in fused_sdf_dtype, the
    rest in fp32), counted from the reference's own evaluations."""

    def __init__(self, model: R.Model, trace_kind: str):
        self.kind = trace_kind
        hid, col = flops.chain_flops(model.sdf.shapes)
        self.f_val = hid + col
        self.f_sdf = flops.mlp_flops(model.sdf.shapes)
        self.f_rnd = flops.mlp_flops(model.render.shapes)
        self.f_mat = flops.mlp_flops(model.mat.shapes)
        self.by = {"bf16": 0.0, "fp32": 0.0}

    def trace(self, rays: float, evals_per_ray: float):
        self.by[self.kind] += rays * evals_per_ray * self.f_val

    def shade(self, points: float, training: bool):
        c = 3 if training else 1
        self.by["fp32"] += points * (2 * self.f_sdf + c * (self.f_rnd + self.f_mat))

    def indirect(self, points: float, training: bool):
        c = 3 if training else 1
        self.by["fp32"] += points * (2 * self.f_sdf + c * self.f_rnd)

    def values(self, points: float):
        self.by["fp32"] += points * self.f_sdf

    def seconds(self) -> float:
        return sum(v / flops.PEAK_FLOPS[k] for k, v in self.by.items())


def _events_work(w: Work, events, e_s: float, training: bool):
    for ev in events:
        if ev[0] == "trace":
            n = ev[1].shape[0]
            w.trace(n, e_s)
            w.indirect(int(ev[4].sum()), training)


# ---- training -------------------------------------------------------------------

def follow_train(model: R.Model, conf_loss: Dict, P0, steps: List[Dict], lr: Dict[str, float],
                 groups: Dict[str, List[str]]):
    """The reference's three steps, each on the program's batch, trace and
    draws. -> losses, distil losses, first gradients, parameters after."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    for g in groups.values():
        for k in g:
            P[k].requires_grad_(True)
    opt = {g: R.Adam([P[k] for k in names], lr[g]) for g, names in groups.items()}
    losses, distil, grads = [], [], None
    for st in steps:
        rep = R.Replay(st["events"])
        limit = st["distil"]["limit"] if st["distil"] else 0
        out, pool = R.forward(model, P, st["batch"], st["primary"], rep, training=True,
                              fake_r=st["fake_r"], limit=limit)
        total, _ = R.loss(conf_loss, out, st["gt"], st["alpha"])
        total.backward()
        if grads is None:
            grads = {k: (P[k].grad if P[k].grad is not None else torch.zeros_like(P[k])).clone()
                     for names in groups.values() for k in names}
        for o in opt.values():
            o.step()
        losses.append(float(total.detach()))
        if not rep.done():
            raise RuntimeError(f"replay: {len(rep.events) - rep.i} events of the program's step "
                               "left over")
        if st["distil"]:
            drep = R.Replay(st["distil"]["events"])
            dl = R.distil_loss(model, P, pool[0], pool[1], st["distil"]["R"], drep, st["fake_r"])
            dl.backward()
            for o in opt.values():
                o.step()
            distil.append(float(dl.detach()))
            if not drep.done():
                raise RuntimeError("replay: events of the distillation step left over")
    return dict(losses=losses, distil=distil, grads=grads,
                params={k: P[k].detach() for names in groups.values() for k in names})


def control_trace(model: R.Model, P, cfg: Dict, q):
    """The reference's trace in the control's precision, in the program's
    place: fn(cam, dirs) -> (hit, points)."""
    def fn(cam, dirs, chunk: int = 1 << 16):
        tr = Tracer(cfg)
        hs, ps = [], []
        with torch.no_grad():
            for i in range(0, cam.shape[0], chunk):
                p, h, _ = tr(lambda x: model.sdf.sdf(P, x, q), cam[i:i + chunk], dirs[i:i + chunk])
                hs.append(h)
                ps.append(p)
        return torch.cat(hs), torch.cat(ps)
    return fn


def _follow(fn, *args):
    """The reference's run, or None where it cannot follow the program (the
    program drew or traced what the reference does not: a fault)."""
    try:
        return fn(*args)
    except (RuntimeError, IndexError, ValueError) as e:
        print(f"check: the reference cannot follow the program: {e}", file=sys.stderr, flush=True)
        return None


def check_train(model: R.Model, conf: Dict, P0, steps, prog: Dict, lr, groups, limits: Dict,
                images: List, gen: Optional[torch.Generator] = None,
                control: Optional[Dict] = None):
    """-> (numbers {name: (value, limit)}, work per iteration {regular, distil}).
    With `control` ({"q": ..., "trace_q": ...}) the reference in those
    precisions stands in the program's place."""
    ref = _follow(follow_train, model, conf["loss"], P0, steps, lr, groups)
    if control is not None:
        cmodel = R.Model(conf["model"], q=control["q"])
        prog = follow_train(cmodel, conf["loss"], P0, steps, lr, groups)
    tcfg = conf["model"]["ray_tracer"]
    scfg = {**tcfg, **conf["model"].get("secondary_ray_tracer", {})}
    flips = rays = evals = 0
    gaps = []
    sec_flips = sec_rays = sec_evals = 0
    gt_bad = 0
    for st in steps:
        b = st["batch"]
        B, S = b["uv"].shape[:2]
        Rr = b["uv"].shape[2] if b["uv"].dim() == 4 else 1
        dirs, cam = R.camera_rays(b["uv"].reshape(B, S * Rr, 2), b["pose"], b["intrinsics"])
        dirs = dirs.reshape(-1, 3)
        cam = cam[:, None].expand(B, S * Rr, 3).reshape(-1, 3)
        obj = b["object_mask"].reshape(B, S, 1).expand(B, S, Rr).reshape(-1)
        pts, hit = st["primary"][0], st["primary"][1]
        if control is not None:
            hit, pts = control_trace(model, P0, tcfg, control["trace_q"])(cam, dirs)
        f, n, g, e = trace_stage(model, P0, tcfg, cam, dirs, hit, pts, obj)
        flips, rays, evals = flips + f, rays + n, evals + e
        gaps.append(g)
        smp = sample_secondary(st["events"], SEC_SAMPLE, gen)
        if smp is not None:
            s_hit, s_pts = smp[2], smp[3]
            if control is not None:
                s_hit, s_pts = control_trace(model, P0, scfg, control["trace_q"])(smp[0], smp[1])
            f, n, _, e = trace_stage(model, P0, scfg, smp[0], smp[1], s_hit, s_pts,
                                     torch.ones_like(s_hit))
            sec_flips, sec_rays, sec_evals = sec_flips + f, sec_rays + n, sec_evals + e
        # the batch's ground truth against the benchmark's own image
        img = images[st["image"]]
        px = torch.round(b["uv"].reshape(B, S, Rr, 2).mean(2)).long().reshape(-1, 2)
        want = img[px[:, 1].clamp(0, img.shape[0] - 1), px[:, 0].clamp(0, img.shape[1] - 1)]
        gt_bad += int((st["gt"].reshape(-1, 3) != want).any(-1).sum())
    g_all = torch.cat(gaps)
    inf = math.inf
    if ref is not None:
        moving = moving_leaves(ref["grads"])
        g_gaps = leaf_gaps(prog["grads"], ref["grads"])
        u_gaps = leaf_gaps({k: prog["params"][k] - P0[k] for k in moving},
                           {k: ref["params"][k] - P0[k] for k in moving})
        steps_nums = {
            "loss_gap": rel(prog["losses"][0], ref["losses"][0]),
            "distil_loss_gap": max([rel(a, b) for a, b in zip(prog["distil"], ref["distil"])]
                                   or [0.0]),
            "grad_gap": max(g_gaps.values()),
            "update_gap": max(u_gaps.values())}
    else:
        steps_nums = dict(loss_gap=inf, distil_loss_gap=inf, grad_gap=inf, update_gap=inf)
    if ref is not None:
        print("check detail: loss gaps by step " + ", ".join(
            f"{rel(a, b):.3g}" for a, b in zip(prog["losses"], ref["losses"])), file=sys.stderr)
        print(f"check detail: worst leaf of grad_gap {worst(g_gaps)}, of update_gap "
              f"{worst(u_gaps)} ({len(moving)} of {len(ref['grads'])} leaves move)",
              file=sys.stderr)
    nums = {
        **steps_nums,
        "trace_flip_share": flips / max(rays, 1),
        "trace_point_gap": p99(g_all),
        "sec_flip_share": sec_flips / max(sec_rays, 1),
        "gt_mismatch": float(gt_bad),
    }
    # the work of an iteration, as the reference counts it
    e_p, e_s = evals / max(rays, 1), sec_evals / max(sec_rays, 1)
    kind = "bf16" if conf["model"].get("fused_sdf_dtype", "float32") == "bfloat16" else "fp32"
    regular, distil = [], None
    for st in steps:
        w = Work(model, kind)
        n = st["primary"][0].shape[0]
        h = int(st["primary"][1].sum())
        w.trace(n, e_p)
        w.values(n)
        w.shade(h, True)
        main_ev, pool_ev = st["events"][:4], st["events"][4:]
        _events_work(w, main_ev, e_s, True)
        if st["distil"]:
            # the pool of the missed rays, then the distillation forward
            for ev in pool_ev:
                if ev[0] == "draw":
                    w.values(ev[2].shape[0])
            _events_work(w, pool_ev, e_s, False)
            dw = Work(model, kind)
            rows = st["distil"]["rows"]
            dw.shade(rows, True)
            _events_work(dw, st["distil"]["events"], e_s, True)
            distil = dw.seconds()
            # the pool is part of a distillation iteration
            distil += w.seconds()
            continue
        regular.append(w.seconds())
    work = {"iter_s": sum(regular) / max(len(regular), 1), "distil_iter_s": distil,
            "evals_per_ray": e_p, "sec_evals_per_ray": e_s}
    return {k: (v, float(limits.get(k, math.inf))) for k, v in nums.items()}, work


# ---- rendering --------------------------------------------------------------------

RENDER_KEYS = ("normal_values", "sg_diffuse_albedo_values", "sg_roughness_values",
               "sg_specular_reflection_values", "sg_rgb_values", "sg_diffuse_rgb_values",
               "sg_specular_rgb_values", "idr_rgb_values", "points")


def check_render(model: R.Model, conf: Dict, P, chunks: List[Dict], limits: Dict,
                 gen: Optional[torch.Generator] = None,
                 control: Optional[Dict] = None):
    """chunks: [{batch, primary, events, outputs (the program's, host
    numpy)}] -> (numbers, work per chunk). With `control` the reference in
    its precisions stands in the program's place."""
    tcfg = conf["model"]["ray_tracer"]
    scfg = {**tcfg, **conf["model"].get("secondary_ray_tracer", {})}
    kind = "bf16" if conf["model"].get("fused_sdf_dtype", "float32") == "bfloat16" else "fp32"
    shade_gap, mask_bad = 0.0, 0
    flips = rays = evals = sec_flips = sec_rays = sec_evals = 0
    gaps, per_chunk = [], []
    for ch in chunks:
        b = ch["batch"]
        with torch.no_grad():
            out = _follow(lambda: R.forward(model, P, b, ch["primary"], R.Replay(ch["events"]))[0])
            outputs = ch["outputs"]
            if control is not None and out is not None:
                cm = R.Model(conf["model"], q=control["q"])
                outputs = R.forward(cm, P, b, ch["primary"], R.Replay(ch["events"]))[0]
        if out is None:
            shade_gap, mask_bad = math.inf, mask_bad + 1
        else:
            for k in RENDER_KEYS:
                a = torch.as_tensor(outputs[k], device=out[k].device).reshape(out[k].shape)
                shade_gap = max(shade_gap, float((a.float() - out[k].float()).abs().max()))
            m = torch.as_tensor(outputs["network_object_mask"], device=out["points"].device)
            mask_bad += int((m.reshape(-1) != out["network_object_mask"].reshape(-1)).sum())
        B, S = b["uv"].shape[:2]
        Rr = b["uv"].shape[2] if b["uv"].dim() == 4 else 1
        dirs, cam = R.camera_rays(b["uv"].reshape(B, S * Rr, 2), b["pose"], b["intrinsics"])
        dirs = dirs.reshape(-1, 3)
        cam = cam[:, None].expand(B, S * Rr, 3).reshape(-1, 3)
        pts, hit = ch["primary"][0], ch["primary"][1]
        t_hit, t_pts = hit, pts
        if control is not None:
            t_hit, t_pts = control_trace(model, P, tcfg, control["trace_q"])(cam, dirs)
        f, n, g, e = trace_stage(model, P, tcfg, cam, dirs, t_hit, t_pts, torch.ones_like(hit))
        flips, rays, evals = flips + f, rays + n, evals + e
        gaps.append(g)
        smp = sample_secondary(ch["events"], SEC_SAMPLE, gen)
        if smp is not None:
            s_hit, s_pts = smp[2], smp[3]
            if control is not None:
                s_hit, s_pts = control_trace(model, P, scfg, control["trace_q"])(smp[0], smp[1])
            f, n, _, e = trace_stage(model, P, scfg, smp[0], smp[1], s_hit, s_pts,
                                     torch.ones_like(s_hit))
            sec_flips, sec_rays, sec_evals = sec_flips + f, sec_rays + n, sec_evals + e
        per_chunk.append((hit, ch["events"]))
    e_p = evals / max(rays, 1)
    e_s = sec_evals / max(sec_rays, 1)
    secs = []
    for hit, events in per_chunk:
        w = Work(model, kind)
        w.trace(hit.shape[0], e_p)
        w.shade(int(hit.sum()), False)
        _events_work(w, events, e_s, False)
        secs.append(w.seconds())
    nums = {"shade_gap": shade_gap, "mask_mismatch": float(mask_bad),
            "trace_flip_share": flips / max(rays, 1), "trace_point_gap": p99(torch.cat(gaps)),
            "sec_flip_share": sec_flips / max(sec_rays, 1)}
    work = {"chunk_s": sum(secs) / max(len(secs), 1), "evals_per_ray": e_p,
            "sec_evals_per_ray": e_s}
    return {k: (v, float(limits.get(k, math.inf))) for k, v in nums.items()}, work
