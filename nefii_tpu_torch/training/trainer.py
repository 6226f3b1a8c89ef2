"""IDRTrainRunner — Step-2 training of the materials, the SG light and the
IDR radiance net on a frozen geometry (counterpart of
nefii_tpu/training/trainer.py).

What it keeps of the JAX trainer: the experiment directory (conf copy, code
backup, runcmd.txt), the train/plot/test datasets, the two Adam groups — idr
(rendering net; the implicit net stays frozen) and sg (material net and
light, minus the frozen parts) — with their multistep schedules, the alpha
schedule of the mask loss, the roughness/specular warmups, the pixel and
patch sampling with the same numpy seeds, the NaN guard, the secondary
self-distillation and the checkpoint cadence. `vis` writes the panel PNG,
the sg_rgb EXR and the envmap EXR; scalars are printed.

Differences by design:
  * One process on one device; there is no mesh. Multi-process training,
    `--train_cameras` (with the view-diff pairing) and unfrozen geometry
    raise. The port has no compaction budgets, so nothing escalates them.
  * Frozen parameters have requires_grad off and belong to no optimizer, so
    they never change. Every trainable parameter is updated on every step,
    a zero gradient standing in for a missing one, as optax updates every
    leaf of its "train" label.
  * The NaN guard checks the loss before the update, so the checkpoint it
    writes holds the last finite parameters.
  * The secondary step distils at most `secondary_batch_size` hits and no
    padding (the JAX step pads to a static size and masks the padding out of
    the loss, which gives the same loss and gradients). Its pool is the JAX
    pipeline's, the hits traced from the points of the rays that missed
    included; the forward builds the pool only on the steps that distil,
    and the missed rays' part only for the strategies that hold the first
    `secondary_batch_size` hits (`IDRNetwork.forward_with_uv(secondary_limit=...)`).
  * The mesh export of `vis` is not ported.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from datetime import datetime
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from nefii_tpu_torch.config import ConfigFactory, ConfigTree, get_class
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils import exr as exr_io
from nefii_tpu_torch.utils import general as utils

def multistep_lr(lr: float, milestones, factor: float) -> Callable[[int], float]:
    """lr for the update that follows `count` earlier ones: scaled by
    `factor` once for every milestone reached (optax's
    piecewise_constant_schedule, torch's MultiStepLR)."""
    ms = sorted(int(m) for m in milestones)
    return lambda count: lr * factor ** sum(count >= m for m in ms)


def trainable_names(model, *, freeze_geometry=False, freeze_idr=False,
                    freeze_decompose_render=False, freeze_light=False,
                    freeze_diffuse=False) -> Dict[str, List[str]]:
    """The parameters each Adam group trains (the JAX trainer's labels)."""
    groups: Dict[str, List[str]] = {"idr": [], "sg": []}
    em = model.envmap_material_network
    for name, _ in model.named_parameters():
        net, rest = name.split(".", 1)
        if net == "implicit_network" and not (freeze_geometry or freeze_idr):
            groups["idr"].append(name)
        elif net == "rendering_network" and not freeze_idr:
            groups["idr"].append(name)
        elif net == "envmap_material_network":
            key = rest.split(".", 1)[0]
            frozen = (freeze_decompose_render
                      or (key == "lgtSGs" and freeze_light)
                      or (key == "diffuse_albedo_layers" and freeze_diffuse)
                      or (key == "specular_reflectance" and em.fix_specular_albedo))
            if not frozen:
                groups["sg"].append(name)
    return groups


class AdamGroup:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a list of parameters with a
    schedule of the update count. A parameter without a gradient gets a zero
    one, so it moves as optax moves it."""

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float]):
        self.params = params
        self.schedule = schedule
        self.count = 0
        self.opt = (torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
                    if params else None)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        if self.opt is not None:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            for g in self.opt.param_groups:
                g["lr"] = self.schedule(self.count)
            self.opt.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "adam": self.opt.state_dict() if self.opt else None}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        if self.opt is not None:
            self.opt.load_state_dict(state["adam"])


def secondary_batch(out: Dict, k_max: int, num_rays: int):
    """The batch the secondary step distils: the first `k_max` hits of the
    pool out["secondary_mask"] [S', N, 1] in its [strategy, ray] order (the
    JAX trainer's stable argsort), each seen along num_rays copies of its
    ray. -> ({points, ray_dirs} [K,R,3], K, hits in the pool), or None when
    the pool has no hit."""
    mask = out["secondary_mask"].reshape(-1)
    n_hit = int(mask.sum())
    if n_hit < 1:
        return None
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:min(k_max, n_hit)]
    R = max(num_rays, 1)
    K = order.shape[0]
    batch = {"points": out["secondary_points"].reshape(-1, 3)[order][:, None].expand(K, R, 3),
             "ray_dirs": out["secondary_dir"].reshape(-1, 3)[order][:, None].expand(K, R, 3)}
    return batch, K, n_hit


def distillation_loss(model, batch: Dict[str, torch.Tensor], gen: torch.Generator, *,
                      fake_roughness=False, fake_specular=False) -> torch.Tensor:
    """Secondary self-distillation: L1(sg_rgb, idr_rgb) over the points of
    batch {points, ray_dirs} [K,R,3] (the JAX make_point_grad_fn, whose
    `valid` mask masks padding the port does not add)."""
    out = model.forward_with_point(batch, gen, freeze_geo=True, fake_roughness=fake_roughness,
                                   fake_specular=fake_specular)
    return (out["sg_rgb_values"] - out["idr_rgb_values"]).abs().mean()


PROFILE_STEPS = 3
# the spans of one training step (record_function names), outermost first
SPANS = ("train.forward", "primary_trace", "sphere_trace", "ray_sampler", "min_sdf_points",
         "shading", "secondary_trace", "secondary_shading", "secondary_pool", "train.loss",
         "train.backward", "train.update", "train.secondary")


class StepProfiler:
    """torch.profiler over training steps: the first step warms up and is not
    recorded, the next PROFILE_STEPS are. Then it writes `trace.json` (chrome
    trace) and `summary.txt` into out_dir and prints the summary, a step's
    average of: the wall time (ProfilerStep, which ends in the step's
    synchronisation), the device's busy time (kernels, copies, sets) and idle
    share, each span's host time and extent on the device timeline, and the
    kernels by device time."""

    def __init__(self, out_dir: str, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.out_dir = out_dir
        self.on_device = device.type == "cuda"
        self.prof = torch.profiler.profile(
            activities=acts, on_trace_ready=self._write,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=PROFILE_STEPS, repeat=1))
        self.prof.start()

    def step(self) -> None:
        if self.prof is not None:
            self.prof.step()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            self.prof = None

    def _write(self, prof) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
        cpu, gpu = {}, {}  # key -> event; a span has a host and a device-timeline event
        for e in prof.key_averages():
            (gpu if e.device_type == torch.autograd.DeviceType.CUDA else cpu)[e.key] = e
        steps = [e for k, e in cpu.items() if k.startswith("ProfilerStep")]
        n = max(sum(e.count for e in steps), 1)
        wall = sum(e.cpu_time_total for e in steps) / 1e6
        # device work: kernels, copies and sets, not the annotations of the spans
        kernels = [e for k, e in gpu.items() if k not in SPANS and not k.startswith("ProfilerStep")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        lines = [f"{n} steps: {wall / n:.3f} s wall a step, " + (
            f"device busy {busy / n:.3f} s a step, idle {100 * (1 - busy / wall):.1f}%"
            if self.on_device else "no device (a CPU run)")]
        for name in SPANS:
            if name in cpu:
                dev = gpu[name].device_time_total / 1e6 / n if name in gpu else 0.0
                lines.append(f"span {name}: {cpu[name].count / n:g} calls, host "
                             f"{cpu[name].cpu_time_total / 1e6 / n:.3f} s, device timeline "
                             f"{dev:.3f} s a step")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
            lines.append(f"kernel {e.key[:90]}: {e.count / n:g} launches, "
                         f"{e.self_device_time_total / 1e6 / n:.3f} s a step")
        with open(os.path.join(self.out_dir, "summary.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        for line in lines:
            print("[profile]", line, flush=True)


class IDRTrainRunner:
    def __init__(self, **kwargs):
        conf = kwargs["conf"]
        self.conf = conf if isinstance(conf, ConfigTree) else ConfigFactory.parse_file(conf)
        self.device = torch.device(kwargs.get("device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
        # full-fp32 matmuls and convolutions (no TF32) for the plain MLPs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.batch_size = kwargs.get("batch_size", 1)
        self.nepochs = kwargs.get("nepochs", 2000)
        self.max_niters = kwargs.get("max_niters", 200001)
        self.exps_folder_name = kwargs.get("exps_folder_name", "exps")
        self.freeze_geometry = kwargs.get("freeze_geometry", False)
        self.freeze_idr = kwargs.get("freeze_idr", False)
        self.roughness_warmup = kwargs.get("roughness_warmup", -1)
        self.specular_warmup = kwargs.get("specular_warmup", -1)
        self.secondary_train_interval = kwargs.get("secondary_train_interval", -1)
        self.secondary_batch_size = kwargs.get("secondary_batch_size", 1)
        self.memory_capacity_level = kwargs.get("memory_capacity_level", 18)
        self.seed = kwargs.get("seed", 0)
        self.profile_dir = kwargs.get("profile_dir") or None
        self.coordinate_type = kwargs.get("coordinate_type", "mitsuba")
        if kwargs.get("train_cameras", False):
            raise NotImplementedError("--train_cameras is not ported (ROADMAP.md queue 1)")
        if not (self.freeze_geometry or self.freeze_idr):
            raise NotImplementedError("training with unfrozen geometry is not ported "
                                      "(ROADMAP.md queue 1, item 1): pass --freeze_geometry")

        # ---- experiment dir -------------------------------------------------
        self.expname = kwargs.get("expname") or self.conf.get_string("train.expname",
                                                                      default="default")
        is_continue = kwargs.get("is_continue", False)
        timestamp = kwargs.get("timestamp", "latest")
        self.expdir = os.path.join(self.exps_folder_name, self.expname)
        if is_continue and timestamp == "latest" and os.path.exists(self.expdir):
            stamps = sorted(os.listdir(self.expdir))
            timestamp = stamps[-1] if stamps else datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        elif not is_continue:
            timestamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.timestamp = timestamp
        self.rundir = os.path.join(self.expdir, timestamp)
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        self.plots_dir = os.path.join(self.rundir, "plots")
        for d in (self.rundir, self.checkpoints_path, self.plots_dir):
            utils.mkdir_ifnotexists(d)
        conf_path = kwargs["conf"] if isinstance(kwargs["conf"], str) else None
        if conf_path and os.path.exists(conf_path):
            shutil.copy(conf_path, os.path.join(self.rundir, "runconf.conf"))
        if not is_continue:
            import nefii_tpu_torch

            dst = os.path.join(self.rundir, "code", "nefii_tpu_torch")
            if not os.path.exists(dst):
                shutil.copytree(os.path.dirname(os.path.abspath(nefii_tpu_torch.__file__)), dst,
                                ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "build"))
        with open(os.path.join(self.rundir, "runcmd.txt"), "a") as f:
            f.write(" ".join(sys.argv) + "\n")

        # ---- data -----------------------------------------------------------
        dataset_class = get_class(self.conf.get_string("train.dataset_class"))
        gamma, wo_mask = kwargs.get("gamma", 1.0), kwargs.get("wo_mask", False)
        subsample = kwargs.get("subsample", 1)
        self.train_dataset = dataset_class(gamma, kwargs["data_split_dir"], False, subsample,
                                           wo_mask=wo_mask)
        vis_sub = subsample * kwargs.get("vis_subsample", 1)
        self.plot_dataset = dataset_class(gamma, kwargs["data_split_dir"], False, vis_sub,
                                          wo_mask=wo_mask)
        test_dir = kwargs.get("data_split_dir_test") or kwargs["data_split_dir"]
        self.test_dataset = dataset_class(gamma, test_dir, False, vis_sub, wo_mask=wo_mask)

        # ---- model / loss ---------------------------------------------------
        model_class = get_class(self.conf.get_string("train.model_class"))
        self.model = model_class.from_conf(self.conf.get_config("model"), device=self.device,
                                           seed=self.seed)
        self.loss = IDRLoss(**self.conf.get_config("loss").as_plain_dict())

        # ---- optimizers -----------------------------------------------------
        names = trainable_names(
            self.model, freeze_geometry=self.freeze_geometry, freeze_idr=self.freeze_idr,
            freeze_decompose_render=kwargs.get("freeze_decompose_render", False),
            freeze_light=kwargs.get("freeze_light", False),
            freeze_diffuse=kwargs.get("freeze_diffuse", False))
        params = dict(self.model.named_parameters())
        trained = set(names["idr"]) | set(names["sg"])
        for name, p in params.items():
            p.requires_grad_(name in trained)
        self.optimizers: Dict[str, AdamGroup] = {}
        for group in ("idr", "sg"):
            self.optimizers[group] = AdamGroup(
                [params[n] for n in names[group]],
                multistep_lr(self.conf.get_float(f"train.{group}_learning_rate"),
                             self.conf.get_list(f"train.{group}_sched_milestones", default=[]),
                             self.conf.get_float(f"train.{group}_sched_factor", default=0.0)))

        # ---- pretrained / partial loads ------------------------------------
        self.start_epoch = 0
        self.cur_iter = 0
        self._partial_loads(kwargs, is_continue)

        # ---- schedule/bookkeeping ------------------------------------------
        self.num_pixels = self.conf.get_int("train.num_pixels")
        self.num_rays = self.conf.get_int("train.num_rays", default=-1)
        self.total_pixels = self.train_dataset.total_pixels
        self.img_res = self.train_dataset.img_res
        self.plot_freq = self.conf.get_int("train.plot_freq")
        self.val_freq = self.conf.get_int("train.val_freq")
        self.ckpt_freq = self.conf.get_int("train.ckpt_freq")
        self.alpha_milestones = [int(a) for a in
                                 self.conf.get_list("train.alpha_milestones", default=[])]
        self.alpha_factor = self.conf.get_float("train.alpha_factor", default=0.0)
        self.base_alpha = self.loss.alpha
        self.log_freq = max(50 // self.batch_size, 1)
        if self.cur_iter == 0:
            steps_per_epoch = max(1, -(-len(self.train_dataset) // self.batch_size))
            self.cur_iter = self.start_epoch * steps_per_epoch
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        # per training step: iteration, seconds, rays, loss, and the seconds
        # and distilled hits of its secondary step (0 when none ran)
        self.step_stats: List[Dict] = []

    # ------------------------------------------------------------------
    def _partial_loads(self, kwargs, is_continue):
        def torch_import(path):
            if path.endswith(".pth"):
                raise NotImplementedError(f"{path}: importing a torch .pth geometry is not ported "
                                          "(ROADMAP.md queue 1); pass a JAX-layout ckpt dir")

        p = kwargs.get("pretrain_geometry_path")
        if p and os.path.exists(p):
            torch_import(p)
            ckpt.restore_subtree(self.model, p, "latest", "implicit_network")
        p = kwargs.get("pretrain_idr_rendering_path")
        if p and os.path.exists(p) and not p.endswith(".pth"):
            ckpt.restore_subtree(self.model, p, "latest", "rendering_network")
        p = kwargs.get("pretrain_diffuse_path")
        if p and os.path.exists(p) and not p.endswith(".pth"):
            ckpt.restore_subtree(self.model, p, "latest",
                                 "envmap_material_network/diffuse_albedo_layers")
        p = kwargs.get("light_sg_path")
        if p and os.path.exists(p):
            with torch.no_grad():
                lgt = self.model.envmap_material_network.lgtSGs
                lgt.copy_(torch.as_tensor(np.load(p), dtype=lgt.dtype))

        if is_continue:
            old_expdir = kwargs.get("old_expdir") or self.expdir
            ckdir = os.path.join(old_expdir, self.timestamp, "checkpoints")
            states, self.start_epoch, self.cur_iter = ckpt.load_all(
                ckdir, kwargs.get("checkpoint", "latest"), self.model)
            for name, group in self.optimizers.items():
                group.load_state_dict(states[name])

        g = kwargs.get("geometry", "")
        if g:
            torch_import(g)
            if os.path.isdir(g):
                ckpt.restore_subtree(self.model, g, "latest", "implicit_network")
        if kwargs.get("geometry_neus", ""):
            raise NotImplementedError("--geometry_neus is not ported (ROADMAP.md queue 1)")

    # ------------------------------------------------------------------
    def _alpha(self) -> float:
        a = self.base_alpha
        for m in self.alpha_milestones:
            if self.cur_iter > m:
                a *= self.alpha_factor
        return a

    def _fakes(self):
        return (self.roughness_warmup > 0 and self.cur_iter < self.roughness_warmup,
                self.specular_warmup > 0 and self.cur_iter < self.specular_warmup)

    def save_checkpoints(self, epoch: int):
        ckpt.save_all(self.checkpoints_path, epoch, self.model,
                      {k: g.state_dict() for k, g in self.optimizers.items()}, self.cur_iter)

    def _sample_pixels(self, epoch: int):
        """Pixel or patch sampling from the epoch-seeded generator (the JAX
        trainer's seeds, so both packages draw the same pixels)."""
        rng = np.random.default_rng(epoch + 7919 * self.seed)
        if self.loss.r_patch < 1:
            self.train_dataset.change_sampling_idx(self.num_pixels, rng)
        else:
            self.train_dataset.change_sampling_idx_patch(
                self.num_pixels // (4 * self.loss.r_patch ** 2), self.loss.r_patch, rng)
        self.train_dataset.change_sampling_rays(self.num_rays, rng)

    def _device_inputs(self, model_input):
        dev = self.device
        return {
            "uv": torch.as_tensor(np.asarray(model_input["uv"], np.float32), device=dev),
            "object_mask": torch.as_tensor(np.asarray(model_input["object_mask"]), device=dev),
            "intrinsics": torch.as_tensor(np.asarray(model_input["intrinsics"], np.float32),
                                          device=dev),
            "pose": torch.as_tensor(np.asarray(model_input["pose"], np.float32), device=dev),
        }

    # ------------------------------------------------------------------
    def train_step(self, batch, gt, fake_r: bool, fake_s: bool, alpha: float,
                   distil: bool = False):
        """One frozen-geometry step: forward, loss, backward, both Adam
        updates. -> (loss dict, model outputs, finite). A non-finite loss
        updates nothing. With `distil` the outputs hold the secondary-hit
        pool as far as the secondary step's batch needs it."""
        for group in self.optimizers.values():
            group.zero_grad()
        with record_function("train.forward"):
            out = self.model.forward_with_uv(
                batch, self.gen, training=True, freeze_geo=True, fake_roughness=fake_r,
                fake_specular=fake_s, secondary_limit=self.secondary_batch_size if distil else 0)
        with record_function("train.loss"):
            ld = self.loss(out, gt, alpha=alpha)
        if not np.isfinite(float(ld["loss"].detach())):
            return ld, out, False
        with record_function("train.backward"):
            ld["loss"].backward()
        with record_function("train.update"):
            for group in self.optimizers.values():
                group.step()
        return ld, out, True

    def _train_with_secondary(self, out, fake_r, fake_s) -> int:
        """Secondary self-distillation on at most secondary_batch_size of the
        step's secondary hits, each seen along num_rays copies of its ray.
        -> the number of hits distilled (0: there was none, nothing ran)."""
        picked = secondary_batch(out, self.secondary_batch_size, self.num_rays)
        if picked is None:
            return 0
        batch, K, n_hit = picked
        for group in self.optimizers.values():
            group.zero_grad()
        with record_function("train.secondary"):
            loss = distillation_loss(self.model, batch, self.gen, fake_roughness=fake_r,
                                     fake_specular=fake_s)
            loss.backward()
            for group in self.optimizers.values():
                group.step()
        if self.cur_iter % 50 == 0:
            print(f"\tsecondary_num={K}/{n_hit}, secondary_loss = {float(loss.detach()):.6f}")
        return K

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self):
        mse2psnr = lambda x: -10.0 * np.log(x + 1e-8) / np.log(10.0)
        n_images = len(self.train_dataset)
        prof = StepProfiler(self.profile_dir, self.device) if self.profile_dir else None

        def stop_profiler():
            if prof is not None:
                prof.stop()

        for epoch in range(self.start_epoch, self.nepochs + 1):
            if not self.loss.sample_each_iter:
                self._sample_pixels(epoch)
            if self.cur_iter > self.max_niters:
                stop_profiler()
                self.save_checkpoints(epoch)
                print(f"Training reached max iters {self.cur_iter}; exiting")
                return
            order = np.random.default_rng(epoch).permutation(n_images)
            n_batches = max(1, -(-n_images // self.batch_size))
            for step_i in range(n_batches):
                img_ids = order[step_i * self.batch_size:(step_i + 1) * self.batch_size]
                if self.loss.sample_each_iter:
                    self._sample_pixels(self.cur_iter)
                if self.cur_iter % self.ckpt_freq == 0:
                    self.save_checkpoints(epoch)
                if self.plot_freq > 0 and self.cur_iter % max(self.plot_freq // self.batch_size,
                                                              1) == 0:
                    self.vis("train", self.cur_iter)
                if self.val_freq > 0 and self.cur_iter % max(self.val_freq // self.batch_size,
                                                             1) == 0:
                    self.vis("test", self.cur_iter)

                _, model_input, ground_truth = self.train_dataset.collate(
                    [self.train_dataset[int(i)] for i in img_ids])
                batch = self._device_inputs(model_input)
                gt = {"rgb": torch.as_tensor(np.asarray(ground_truth["rgb"], np.float32),
                                             device=self.device)}
                fake_r, fake_s = self._fakes()
                alpha = self._alpha()
                distil = (self.secondary_train_interval > 0
                          and self.cur_iter % self.secondary_train_interval == 0)
                t0 = time.perf_counter()
                loss_dict, out, finite = self.train_step(batch, gt, fake_r, fake_s, alpha, distil)
                if not finite:
                    print("[WARNING] NaN in loss — checkpointing and exiting")
                    stop_profiler()
                    self.save_checkpoints(epoch)
                    return
                self._sync()
                seconds = time.perf_counter() - t0
                if self.cur_iter % self.log_freq == 0:
                    self.log_scalars(epoch, loss_dict, mse2psnr, alpha)
                sec_seconds, n_distilled = 0.0, 0
                if distil:
                    t1 = time.perf_counter()
                    n_distilled = self._train_with_secondary(out, fake_r, fake_s)
                    self._sync()
                    sec_seconds = time.perf_counter() - t1
                del out
                self.step_stats.append(dict(
                    iter=self.cur_iter, seconds=seconds, rays=int(batch["uv"].shape[:-1].numel()),
                    loss=float(loss_dict["loss"].detach()), secondary_seconds=sec_seconds,
                    secondary_points=n_distilled))
                self.cur_iter += 1
                if prof is not None:
                    prof.step()
        stop_profiler()
        self.save_checkpoints(self.nepochs)

    def log_scalars(self, epoch, loss_dict, mse2psnr, alpha):
        it = self.cur_iter
        vals = {k: float(v.detach()) for k, v in loss_dict.items()}
        print(f"{self.expname} [{epoch}] ({it}): loss = {vals['loss']:.6f}, "
              f"idr_rgb = {vals['idr_rgb_loss']:.6f}, sg_rgb = {vals['sg_rgb_loss']:.6f}, "
              f"eikonal = {vals['eikonal_loss']:.6f}, mask = {vals['mask_loss']:.6f}, "
              f"alpha = {alpha:.1f}, idr_psnr = {mse2psnr(vals['idr_rgb_loss'] ** 2):.2f}, "
              f"sg_psnr = {mse2psnr(vals['sg_rgb_loss'] ** 2):.2f}", flush=True)

    # ------------------------------------------------------------------
    def vis(self, split: str, it: int, img_idx: int = 0):
        """Render a full view and write the panel PNG (gt|sg|idr,
        diffuse|specular|normal, albedo|roughness|specular, depth), the sg_rgb
        EXR and the current envmap EXR."""
        from nefii_tpu_torch.ops.sg import compute_envmap
        from nefii_tpu_torch.utils.png import write_png

        dataset = self.plot_dataset if split == "train" else self.test_dataset
        out = self.render_image(dataset, img_idx)
        H, W = dataset.img_res

        def im(key):
            v = out[key].reshape(H, W, -1)
            return np.clip(np.tile(v, (1, 1, 3)) if v.shape[-1] == 1 else v, 0, 1)

        pose = np.asarray(dataset.pose_all[img_idx], np.float64)
        pts = np.asarray(out["points"], np.float64).reshape(-1, 3)
        depth = ((pts - pose[:3, 3]) @ np.linalg.inv(pose[:3, :3]).T)[:, 2]
        depth = np.where(np.asarray(out["network_object_mask"]).reshape(-1), depth, np.nan)
        if np.isfinite(depth).any():
            lo, hi = np.nanmin(depth), np.nanmax(depth)
            depth = (depth - lo) / max(hi - lo, 1e-8)
        depth = np.tile(np.where(np.isnan(depth), 1.0, depth).reshape(H, W, 1), (1, 1, 3))
        white = np.ones_like(depth)
        rows = [[out["gt"].reshape(H, W, 3), im("sg_rgb_values"), im("idr_rgb_values")],
                [im("sg_diffuse_rgb_values"), im("sg_specular_rgb_values"),
                 (out["normal_values"].reshape(H, W, 3) + 1) / 2],
                [im("sg_diffuse_albedo_values"), im("sg_roughness_values"),
                 im("sg_specular_reflection_values")],
                [depth, white, white]]
        stack = np.concatenate([np.concatenate([np.clip(p, 0, 1) for p in row], axis=1)
                                for row in rows], axis=0)
        write_png(os.path.join(self.plots_dir, f"{split}_{it}.png"),
                  (stack * 255).astype(np.uint8))
        exr_io.write(os.path.join(self.plots_dir, f"{split}_{it}_sg_rgb.exr"),
                     out["sg_rgb_values"].reshape(H, W, 3))
        em = self.model.envmap_material_network
        if em.light_type == "sg":
            with torch.no_grad():
                env = compute_envmap(em.get_lgtSGs(), 64, 128,
                                     coordinate_type=self.coordinate_type)
            exr_io.write(os.path.join(self.plots_dir, f"{split}_{it}_envmap.exr"),
                         env.cpu().numpy())

    @torch.no_grad()
    def render_image(self, dataset, img_idx: int = 0) -> Dict[str, np.ndarray]:
        """Chunked full-image eval render, one ray per pixel."""
        from nefii_tpu_torch.scripts.render import OUTPUT_KEYS

        saved = dataset.sampling_idx, dataset.sampling_rays
        dataset.sampling_idx = dataset.sampling_rays = None
        item = dataset[img_idx]
        dataset.sampling_idx, dataset.sampling_rays = saved
        _, model_input, ground_truth = dataset.collate([item])
        total = dataset.total_pixels
        n_pix = min(utils.pixels_per_chunk(self.memory_capacity_level, 1), total)
        gen = torch.Generator(device=self.device).manual_seed(0)

        def forward(chunk):
            out = self.model.forward_with_uv(self._device_inputs(chunk), gen)
            return {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}

        out = utils.chunked_forward(forward, model_input, total, n_pix)
        out["gt"] = np.asarray(ground_truth["rgb"][0])
        return out
