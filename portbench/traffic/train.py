"""Step-2 training with frozen geometry, as `IDRTrainRunner.run()` runs it,
in a closed loop: an iteration is the runner's collate and `_device_inputs`,
`train_step` and, on every `secondary_train_interval`-th iteration, the
self-distillation step `_train_with_secondary`, each followed by the
synchronise `run()` makes. The checkpoint, plot and validation cadences are
left out.

Parameters (workloads/<cell>.json "params"): n_views, res (the training
views), start_iter, secondary_batch_size, secondary_train_interval,
roughness_warmup, gamma, wo_mask, memory_capacity_level, fit_steps,
fit_batch; start_iter should be a distillation iteration. The runner's own
seed, which draws the pixel batches and the Monte-Carlo samples, comes
from the run's seed.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, core, flops, harness, scene, tracing
from portbench.record import Recorder
from portbench.reference import pipeline as R


class Loop:
    """The runner's iterations, in run()'s order of epochs and images."""

    def __init__(self, runner, n_images: int):
        self.r, self.n = runner, n_images
        self.epoch = runner.cur_iter // n_images
        self.step_i = runner.cur_iter % n_images
        self.order = None
        self.collate_s = 0.0
        self.timed_collate = False

    def iteration(self, on_step=None):
        """One iteration -> (image index, distilled hits or None)."""
        from nefii_tpu_torch.parallel import spmd

        r = self.r
        if self.order is None or self.step_i == 0:
            if not r.loss.sample_each_iter:
                r._sample_pixels(self.epoch)
            self.order = np.random.default_rng(self.epoch).permutation(self.n)
        img = int(self.order[self.step_i])
        if self.timed_collate:
            harness.sync(r.device)
            t0 = harness.clock()
        with record_function("portbench.collate"):
            if r.loss.sample_each_iter:
                r._sample_pixels(r.cur_iter)
            _, model_input, ground_truth = r.train_dataset.collate([r.train_dataset[img]])
            batch = r._device_inputs(model_input)
            gt = {"rgb": torch.as_tensor(np.asarray(ground_truth["rgb"], np.float32),
                                         device=r.device)}
        if self.timed_collate:
            harness.sync(r.device)
            self.collate_s += harness.clock() - t0
        batch, gt = spmd.shard_batch(batch), spmd.shard_batch(gt)
        fake_r, fake_s = r._fakes()
        alpha = r._alpha()
        distil = (r.secondary_train_interval > 0
                  and r.cur_iter % r.secondary_train_interval == 0)
        loss_dict, out, finite = r.train_step(batch, gt, fake_r, fake_s, alpha, distil)
        if not finite:
            raise RuntimeError(f"a non-finite loss at iteration {r.cur_iter}")
        r._sync()
        if on_step is not None:
            on_step(batch, gt, loss_dict, fake_r, alpha)
        k = None
        if distil:
            k = r._train_with_secondary(out, fake_r, fake_s)
            r._sync()
        del out
        r.cur_iter += 1
        self.step_i = (self.step_i + 1) % self.n
        if self.step_i == 0:
            self.epoch += 1
        return img, k


def run(run: core.Run) -> core.Outcome:
    from nefii_tpu_torch.ops import path_tracing as ptr
    from nefii_tpu_torch.ops.kernels import fused_mlp
    from nefii_tpu_torch.training import trainer as trainer_mod
    from nefii_tpu_torch.training.trainer import IDRTrainRunner

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
    P, fit_err = harness.make_weights(cm, s_weights, p, dev)
    phase(f"weights (the SDF fit's L1 {fit_err:.5f})")
    runner = IDRTrainRunner(
        conf=conf, data_split_dir=data, exps_folder_name=os.path.join(work_dir, "exps"),
        expname=run.cell.name, batch_size=1, nepochs=1 << 30, max_niters=1 << 62,
        freeze_geometry=True, roughness_warmup=p["roughness_warmup"],
        secondary_train_interval=p["secondary_train_interval"],
        secondary_batch_size=p["secondary_batch_size"],
        memory_capacity_level=p["memory_capacity_level"], gamma=p["gamma"],
        wo_mask=p["wo_mask"], coordinate_type="blender", device=run.device,
        seed=s_prog % (1 << 31))
    model = runner.model
    if model.secondary_ray_tracer is None:
        raise ValueError("the check follows a conf with a secondary_ray_tracer block")
    harness.load_into(model, P)
    names = dict(model.named_parameters())
    groups = harness.groups_of(runner, names)
    harness.check_leaves(cm, groups)
    runner.cur_iter = p["start_iter"]
    loop = Loop(runner, len(runner.train_dataset))
    phase("runner")

    # ---- the iterations the reference follows: the first of the run --------------
    steps, prog = [], {"losses": [], "distil": []}
    distil_losses = []
    orig_distil = trainer_mod.distillation_loss

    def distillation_loss(*a, **k):
        loss = orig_distil(*a, **k)
        distil_losses.append(loss.detach())
        return loss

    P0 = {k: v.detach().clone() for k, v in P.items()}
    del P
    trainer_mod.distillation_loss = distillation_loss
    try:
        with Recorder(model, ptr) as rec:
            for i in range(harness.CHECK_STEPS):
                captured = {}

                def on_step(batch, gt, loss_dict, fake_r, alpha):
                    captured.update(batch=batch, gt=gt["rgb"], fake_r=fake_r, alpha=alpha,
                                    loss=float(loss_dict["loss"].detach()))
                    if i == 0:
                        prog["grads"] = {}
                        for g, opt in runner.optimizers.items():
                            for n, part in zip(groups[g], opt.mu.split(
                                    [q.numel() for q in opt.params])):
                                prog["grads"][n] = (part / (1 - opt.B1)).view_as(names[n]).clone()
                    captured["primary"], captured["events"] = rec.take()

                img, k = loop.iteration(on_step)
                prim = captured.pop("primary")
                if len(prim) != 1:
                    raise RuntimeError(f"{len(prim)} primary traces in one step")
                st = dict(captured, primary=prim[0], image=img, distil=None)
                prog["losses"].append(st.pop("loss"))
                if k is not None:
                    _, dev_events = rec.take()
                    st["distil"] = dict(events=dev_events, limit=p["secondary_batch_size"],
                                        R=max(runner.num_rays, 1), rows=k * max(runner.num_rays, 1))
                steps.append(st)
    finally:
        trainer_mod.distillation_loss = orig_distil
    prog["distil"] = [float(x) for x in distil_losses]
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
    n_iter, timeline, rows = 0, None, None
    st_iters = st_distil = 0
    interval = max(runner.secondary_train_interval, 1)
    while harness.clock() - t_w < run.seconds or n_iter == 0 or (run.trace and timeline is None):
        if run.trace and timeline is None and runner.cur_iter % interval == 0 \
                and (harness.clock() - t_w > 0.1 * run.seconds or n_iter >= interval):
            stretch = tracing.Stretch(os.path.join(work_dir, "trace.json"))
            loop.timed_collate = True
            with flops.KernelRows(fused_mlp) as rows:
                stretch.start(lambda: harness.sync(dev))
                for _ in range(harness.TRACE_PERIODS * interval):
                    _, k = loop.iteration()
                    st_iters += 1
                    st_distil += k is not None
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
    del runner, model, names, loop, rec
    harness.release()
    ref_model = R.Model(cm)
    steps, prog, P0 = harness.moved(steps, dev), harness.moved(prog, dev), harness.moved(P0, dev)

    def numbers_for(control):
        return check.check_train(
            ref_model, conf.as_plain_dict(), P0, steps, prog, lr, groups, run.cell.limits,
            harness.images_as_loaded(split, p["gamma"], dev),
            gen=torch.Generator().manual_seed(s_check), control=control)

    out.numbers, work = numbers_for(None)
    if run.control is not None:
        out.program_numbers, out.numbers = out.numbers, numbers_for(run.control)[0]
    if run.trace:
        shapes = ref_model.sdf.shapes
        out.busy_s, out.window_s = timeline.busy_s(), timeline.wall_s
        out.breakdown = timeline.breakdown()
        out.reading = dict(kind="train", timeline=timeline, iters=st_iters, distils=st_distil,
                           collate_s=collate_s, rows=rows, shapes=shapes, work=work)
    del steps
    harness.release()
    return out
