"""Step-2 training with live geometry through the closed-form SG render (the
PhySG baseline, `run_physg.sh` without a geometry): `IDRTrainRunner` on the
cell's conf with `freeze_geometry` off, in the closed loop of
`traffic/train.py` (`Loop`: the runner's collate, `_device_inputs`,
`train_step` and run()'s synchronise, an iteration at a time). No
self-distillation. The checkpoint, plot and validation cadences are left out.

Parameters (workloads/<cell>.json "params"): n_views, res, start_iter,
gamma, wo_mask, fit_steps, fit_batch, trace_iters (the traced stretch). The
runner's own seed (pixel batches, eikonal points, the min-SDF steps) comes
from the run's seed.

The check (`check_live.py`) follows the window's first three iterations: a
recorder hands it each step's primary trace, eikonal points and SG colours.
`run(..., fault=NAME)` plants one of `faults_live.FAULTS` underneath the
timed path (the tests and `faults_live.py`; never the benchmark's runs).
"""

from __future__ import annotations

import contextlib
import os

import torch

from portbench import check_live, core, harness, scene, scene_physg, tracing
from portbench.record import Recorder
from portbench.reference import physg as PH
from portbench.traffic.train import Loop


class LiveRecorder:
    """While installed: the input of each call of the implicit net's
    graph-keeping `sdf_feature_grad` (the live branch's first such call in a
    step is at the eikonal and traced points), and the SG colours each loss
    call is given. Keeps references only."""

    def __init__(self, runner):
        self.r = runner
        self.geometry, self.sg = [], []

    def __enter__(self):
        imp, loss = self.r.model.implicit_network, self.r.loss
        orig = imp.sdf_feature_grad

        def sdf_feature_grad(pts, value_only=True, grad_graph=True):
            if not value_only:
                self.geometry.append(pts.detach())
            return orig(pts, value_only, grad_graph)

        outer = self

        class _Loss:
            def __getattr__(self, name):
                return getattr(loss, name)

            def __call__(self, model_outputs, ground_truth, alpha=None, all_reduce=None):
                outer.sg.append(model_outputs["sg_rgb_values"].detach())
                return loss(model_outputs, ground_truth, alpha=alpha, all_reduce=all_reduce)

        imp.sdf_feature_grad = sdf_feature_grad
        self.r.loss = _Loss()
        self._saved = loss
        return self

    def __exit__(self, *exc):
        del self.r.model.implicit_network.sdf_feature_grad  # the class's method again
        self.r.loss = self._saved
        return False

    def take(self, n_rays: int):
        """-> (eikonal points, SG colours) of the step just run, and start afresh."""
        if not self.geometry or len(self.sg) != 1:
            raise RuntimeError(f"{len(self.geometry)} geometry calls, {len(self.sg)} losses in "
                               "one step")
        eik = self.geometry[0][: self.geometry[0].shape[0] - n_rays]
        sg = self.sg[0]
        self.geometry.clear()
        self.sg.clear()
        return eik, sg


def run(run: core.Run, fault=None) -> core.Outcome:
    from nefii_tpu_torch.ops import path_tracing as ptr
    from nefii_tpu_torch.training.trainer import IDRTrainRunner

    from portbench.faults_live import FAULTS

    with FAULTS[fault]() if fault else contextlib.nullcontext():
        return _run(run, IDRTrainRunner, ptr)


def _run(run: core.Run, IDRTrainRunner, ptr) -> core.Outcome:
    p = {**run.cell.params, **(run.tiny or {}).get("params", {})}
    phase = harness.Phases(run.t0)
    phase("imports")
    dev = torch.device(run.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work_dir = harness.workdir(run.cell.name)
    s_scene, s_weights, s_check, s_prog = harness.seeds(run.seed, 4)
    conf = harness.conf(run)
    cm = conf.get_config("model").as_plain_dict()

    # ---- set-up: the scene, the weights, the program ---------------------------
    data = os.path.join(work_dir, "train")
    cams = scene.ring_cameras(p["n_views"], p["res"])
    light = scene.seeded_light(harness.generator(dev, s_scene), 8, dev)
    split = scene.write_split(data, cams, p["res"], light, dev)
    phase("scene")
    P, fit_err = scene_physg.physg_weights(cm, s_weights, p, dev)
    phase(f"weights (the SDF fit's L1 {fit_err:.5f})")
    runner = IDRTrainRunner(
        conf=conf, data_split_dir=data, exps_folder_name=os.path.join(work_dir, "exps"),
        expname=run.cell.name, batch_size=1, nepochs=1 << 30, max_niters=1 << 62,
        freeze_geometry=False, gamma=p["gamma"], wo_mask=p["wo_mask"],
        coordinate_type="blender", device=run.device, seed=s_prog % (1 << 31))
    model = runner.model
    harness.load_into(model, P)
    names = dict(model.named_parameters())
    groups = harness.groups_of(runner, names)
    known = set(sum(PH.Model(cm).leaf_names().values(), []))
    for n in sum(groups.values(), []):
        if n not in known:
            raise RuntimeError(f"the program trains {n}, which the reference does not hold")
    runner.cur_iter = p["start_iter"]
    loop = Loop(runner, len(runner.train_dataset))
    phase("runner")

    # ---- the iterations the reference follows: the first of the run --------------
    steps, prog = [], {"losses": []}
    P0 = {k: v.detach().clone() for k, v in P.items()}
    del P
    with Recorder(model, ptr) as rec, LiveRecorder(runner) as live:
        for i in range(harness.CHECK_STEPS):
            captured = {}

            def on_step(batch, gt, loss_dict, fake_r, alpha):
                captured.update(batch=batch, gt=gt["rgb"], fake_r=fake_r, alpha=alpha,
                                loss=float(loss_dict["loss"].detach()))
                if i == 0:
                    prog["grads"] = {}
                    for g, opt in runner.optimizers.items():
                        for n, part in zip(groups[g], opt.mu.split([q.numel() for q in opt.params])):
                            prog["grads"][n] = (part / (1 - opt.B1)).view_as(names[n]).clone()

            img, _ = loop.iteration(on_step)
            prim, _ = rec.take()
            if len(prim) != 1:
                raise RuntimeError(f"{len(prim)} primary traces in one step")
            eik, sg = live.take(prim[0][0].shape[0])
            prog["losses"].append(captured.pop("loss"))
            steps.append(dict(captured, primary=prim[0], eik=eik, sg=sg, image=img))
    prog["params"] = {n: names[n].detach().clone() for g in groups.values() for n in g}
    host = torch.device("cpu")
    steps, prog, P0 = harness.moved(steps, host), harness.moved(prog, host), harness.moved(P0, host)
    harness.release()
    phase("the followed iterations (the first of the run)")

    # ---- the window ----------------------------------------------------------------
    harness.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_w = harness.clock()
    setup_s = t_w - run.t0
    n_iter, timeline, st_iters = 0, None, 0
    while harness.clock() - t_w < run.seconds or n_iter == 0 or (run.trace and timeline is None):
        if run.trace and timeline is None and (harness.clock() - t_w > 0.1 * run.seconds
                                               or n_iter >= p["trace_iters"]):
            stretch = tracing.Stretch(os.path.join(work_dir, "trace.json"))
            loop.timed_collate = True
            stretch.start(lambda: harness.sync(dev))
            for _ in range(p["trace_iters"]):
                loop.iteration()
                st_iters += 1
            timeline = stretch.stop(lambda: harness.sync(dev))
            loop.timed_collate = False
            n_iter += st_iters
            continue
        loop.iteration()
        n_iter += 1
    window_s = harness.clock() - t_w
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    out = core.Outcome(attempted=n_iter, failed=0, memory_peak_bytes=peak)
    out.e2e = {"iter_s": window_s / n_iter, "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}

    # ---- the check, once the program's state is freed --------------------------------
    lr = {g: float(opt.schedule(0)) for g, opt in runner.optimizers.items()}
    collate_s = loop.collate_s
    del runner, model, names, loop, rec, live
    harness.release()
    ref_model = PH.Model(cm)
    steps, prog, P0 = harness.moved(steps, dev), harness.moved(prog, dev), harness.moved(P0, dev)

    def numbers_for(control):
        return check_live.check_live(
            ref_model, conf.as_plain_dict(), P0, steps, prog, lr, groups, run.cell.limits,
            harness.images_as_loaded(split, p["gamma"], dev), control=control)

    out.numbers, work = numbers_for(None)
    if run.control is not None:
        out.program_numbers, out.numbers = out.numbers, numbers_for(run.control)[0]
    if run.trace:
        out.busy_s, out.window_s = timeline.busy_s(), timeline.wall_s
        out.breakdown = timeline.breakdown()
        out.reading = dict(kind="train", timeline=timeline, iters=st_iters, distils=0,
                           collate_s=collate_s, shapes=ref_model.sdf.shapes, work=work)
    del steps
    harness.release()
    return out
