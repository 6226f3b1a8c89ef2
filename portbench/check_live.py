"""The check of training with live geometry through the closed-form SG render
(PhySG): the plain reference (`reference/physg.py`) follows the program's
first three steps, each on the program's batch, primary trace and eikonal
points, and computes everything else again.

  loss_gap         the relative gap of the first step's loss
  grad_gap         the first gradient, by the worst leaf, the SDF net's
                   second-order terms included (check.leaf_gaps; the
                   program's gradient read from its Adam state)
  update_gap       the parameters' change over the three steps, by the worst
                   moving leaf (check.moving_leaves)
  sg_gap           the largest absolute gap of a pixel's SG colour in the
                   first step
  trace_flip_share, trace_point_gap, gt_mismatch   as in check.py, on the
                   rays inside the object mask, against `tracer.Tracer` on
                   the same plain fp32 net
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

from portbench import check, flops
from portbench.reference import physg as PH
from portbench.reference import pipeline as R
from portbench.reference.tracer import sphere_intersection


def follow_live(model: PH.Model, conf_loss: Dict, P0, steps: List[Dict], lr: Dict[str, float],
                groups: Dict[str, List[str]]):
    """The reference's steps, each on the program's batch, trace and eikonal
    points -> losses, first gradients, parameters after, the first step's
    SG colours, and the SDF net's leaves before each step."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    for g in groups.values():
        for k in g:
            P[k].requires_grad_(True)
    opt = {g: R.Adam([P[k] for k in names], lr[g]) for g, names in groups.items()}
    losses, grads, sg, sdf_at = [], None, None, []
    for st in steps:
        sdf_at.append({k: v.detach().clone() for k, v in P.items()
                       if k.startswith("implicit_network.")})
        out = PH.forward(model, P, st["batch"], st["primary"], st["eik"], st["fake_r"])
        total, _ = PH.loss(conf_loss, out, st["gt"], st["alpha"])
        total.backward()
        if grads is None:
            grads = {k: (P[k].grad if P[k].grad is not None else torch.zeros_like(P[k])).clone()
                     for names in groups.values() for k in names}
            sg = out["sg_rgb_values"].detach()
        for o in opt.values():
            o.step()
        losses.append(float(total.detach()))
    return dict(losses=losses, grads=grads, sg=sg, sdf_at=sdf_at,
                params={k: P[k].detach() for names in groups.values() for k in names})


class Work:
    """FLOPs a step needs, all fp32 (the conf's trace runs the plain net):
    the trace's evaluations, the min-SDF search of the rays inside the
    bounding sphere that do not hit inside the mask, the attached SDF and its
    gradient at the eikonal and traced points and at the shaded points
    (forward, input gradient and the backward of both: 6 chains), the
    radiance and material nets at the shaded points (forward and backward: 3).
    The SG render's elementwise work is left out."""

    def __init__(self, model: PH.Model):
        hid, col = flops.chain_flops(model.sdf.shapes)
        self.f_val = hid + col
        self.f_sdf = flops.mlp_flops(model.sdf.shapes)
        self.f_nets = flops.mlp_flops(model.render.shapes) + flops.mlp_flops(model.mat.shapes)
        self.flops = 0.0

    def step(self, rays, evals_per_ray, min_sdf_evals, live_points, shaded):
        self.flops += (rays * evals_per_ray + min_sdf_evals) * self.f_val
        self.flops += live_points * 6 * self.f_sdf + shaded * (6 * self.f_sdf + 3 * self.f_nets)

    def seconds(self) -> float:
        return self.flops / flops.PEAK_FLOPS["fp32"]


def _rays(b):
    uv = b["uv"]
    B, S = uv.shape[:2]
    dirs, cam = R.camera_rays(uv.reshape(B, S, 2), b["pose"], b["intrinsics"])
    return dirs.reshape(-1, 3), cam[:, None].expand(B, S, 3).reshape(-1, 3), \
        b["object_mask"].reshape(-1)


def _follow(fn, *args):
    try:
        return fn(*args)
    except (RuntimeError, IndexError, ValueError) as e:
        print(f"check: the reference cannot follow the program: {e}", file=sys.stderr, flush=True)
        return None


def check_live(model: PH.Model, conf: Dict, P0, steps, prog: Dict, lr, groups, limits: Dict,
               images: List, control: Optional[Dict] = None):
    """steps: [{batch, gt, primary (points, hit, dists), eik, fake_r, alpha,
    image, sg (the program's SG colours)}]; prog: {losses, grads, params}.
    -> (numbers {name: (value, limit)}, work {iter_s, distil_iter_s}). With
    `control` ({"q": ...}) the reference in that precision, its trace
    included (the conf's trace is fp32 too), stands in the program's place."""
    ref = _follow(follow_live, model, conf["loss"], P0, steps, lr, groups)
    prog_sg = steps[0]["sg"]
    if control is not None:
        cmodel = PH.Model(conf["model"], q=control["q"])
        prog = follow_live(cmodel, conf["loss"], P0, steps, lr, groups)
        prog_sg = prog["sg"]
    # the geometry trains: each step's trace is held to the reference's on the
    # SDF net as the reference has it before that step (P0 before the first)
    sdf_at = ref["sdf_at"] if ref is not None else [P0] * len(steps)
    tcfg = conf["model"]["ray_tracer"]
    n_steps = int(tcfg.get("n_steps", 100))
    flips = rays = traced = evals = gt_bad = 0
    gaps, per_step = [], []
    for i, st in enumerate(steps):
        dirs, cam, obj = _rays(st["batch"])
        pts, hit = st["primary"][0], st["primary"][1]
        if control is not None:
            hit, pts = check.control_trace(model, prog["sdf_at"][i], tcfg, control["q"])(cam,
                                                                                        dirs)
        f, n, g, e = check.trace_stage(model, sdf_at[i], tcfg, cam, dirs, hit, pts, obj)
        flips, rays, evals = flips + f, rays + n, evals + e
        traced += cam.shape[0]
        gaps.append(g)
        img = images[st["image"]]
        px = torch.round(st["batch"]["uv"].reshape(-1, 2)).long()
        want = img[px[:, 1].clamp(0, img.shape[0] - 1), px[:, 0].clamp(0, img.shape[1] - 1)]
        gt_bad += int((st["gt"].reshape(-1, 3) != want).any(-1).sum())
        inside = sphere_intersection(cam, dirs, model.bounding_sphere)[2]
        hit_in = st["primary"][1] & obj
        per_step.append((pts.shape[0], int((inside & ~hit_in).sum()), st["eik"].shape[0],
                         int(hit_in.sum())))
    inf = math.inf
    if ref is not None:
        moving = check.moving_leaves(ref["grads"])
        g_gaps = check.leaf_gaps(prog["grads"], ref["grads"])
        u_gaps = check.leaf_gaps({k: prog["params"][k] - P0[k] for k in moving},
                                 {k: ref["params"][k] - P0[k] for k in moving})
        nums = {"loss_gap": check.rel(prog["losses"][0], ref["losses"][0]),
                "grad_gap": max(g_gaps.values()), "update_gap": max(u_gaps.values()),
                "sg_gap": float((prog_sg.float() - ref["sg"].float()).abs().max())}
        print("check detail: loss gaps by step " + ", ".join(
            f"{check.rel(a, b):.3g}" for a, b in zip(prog["losses"], ref["losses"])),
            file=sys.stderr)
        print(f"check detail: worst leaf of grad_gap {check.worst(g_gaps)}, of update_gap "
              f"{check.worst(u_gaps)} ({len(moving)} of {len(ref['grads'])} leaves move)",
              file=sys.stderr)
    else:
        nums = dict(loss_gap=inf, grad_gap=inf, update_gap=inf, sg_gap=inf)
    nums.update({"trace_flip_share": flips / max(rays, 1),
                 "trace_point_gap": check.p99(torch.cat(gaps)), "gt_mismatch": float(gt_bad)})
    e_p = evals / max(traced, 1)  # the reference traces every ray
    secs = []
    for n_rays, n_min, n_eik, shaded in per_step:
        w = Work(model)
        w.step(n_rays, e_p, n_min * n_steps, n_eik + n_rays, shaded)
        secs.append(w.seconds())
    work = {"iter_s": sum(secs) / len(secs), "distil_iter_s": None, "evals_per_ray": e_p}
    return {k: (v, float(limits.get(k, math.inf))) for k, v in nums.items()}, work
