"""IDRTrainRunner — Step-2 training of the materials, the SG light, the IDR
radiance net and, unless `--freeze_geometry` or `--freeze_idr`, the geometry
(counterpart of nefii_tpu/training/trainer.py).

What it keeps of the JAX trainer: the experiment directory (conf copy, code
backup, runcmd.txt), the train/plot/test datasets, the two Adam groups — idr
(rendering net, and the implicit net when the geometry is not frozen) and sg
(material net and light, minus the frozen parts) — with their multistep
schedules, `--train_cameras` (a [n_views, 7] quaternion + translation leaf
beside the model, initialised from the dataset's poses, the batch's rows
gathered by image index, and a third Adam at `train.learning_rate_cam` with
SparseAdam's rows: `RowAdam`), the view-diff pairing (each image's partner
view (i + 3) % n appended to the batch, `_append_paired_view`), which
excludes `--train_cameras` as in JAX, the geometry imports (a JAX-layout
checkpoint directory, a torch `.pth` state dict, a NeuS `sdf_network_fine`),
`train.remat`, the alpha
schedule of the mask loss, the roughness/specular warmups, the pixel and
patch sampling with the same numpy seeds, the NaN guard, the secondary
self-distillation and the checkpoint cadence. `vis` writes the panel PNG,
the sg_rgb EXR and the envmap EXR, and on the train split the SDF's
zero-surface as surface_<it>.obj (plot.surface_resolution, default 100);
scalars are printed.

Multi-GPU: one process per card over torch.distributed (`parallel/dist.py`;
JAX runs one process over every chip of its host). Every rank draws the same
epoch sample (the same numpy seeds) and trains on its contiguous slice of the
batch (`spmd.shard_batch`); the loss's (num, den) pairs are summed over the
ranks (`spmd.loss_all_reduce`) and the gradients summed before each group's
update (`spmd.all_reduce_grads`), so a step of W processes computes the
gradient of the single-process step on the whole batch. The ranks' Monte-Carlo
generators are seeded from (seed, rank), rank 0's as the single process's.
Rank 0 makes the directories and writes the checkpoints, vis and logs; vis
renders through the sharded eval forward on every rank. A world of 1 is the
single-process trainer.

Differences by design:
  * The port has no compaction budgets, so nothing escalates them.
  * `train.remat` checkpoints the forward after the primary trace, in two
    regions (`IDRNetwork.forward_with_uv(remat=True)`); the JAX package's
    jax.checkpoint takes the trace too. Nothing is differentiated through
    the trace, so its outputs stay outside and the backward does not re-run
    it.
  * Frozen parameters have requires_grad off and belong to no optimizer, so
    they never change. Every trainable parameter is updated on every step,
    a zero gradient standing in for a missing one, as optax updates every
    leaf of its "train" label.
  * The NaN guard checks the loss before the update, so the checkpoint it
    writes holds the last finite parameters.
  * The secondary step distils at most `secondary_batch_size` hits and, in
    one process, no padding (the JAX step pads to a static size and masks
    the padding out of the loss, which gives the same loss and gradients);
    W processes pad the hits to a multiple of W with masked rows, cut them
    over the ranks and take the L1 as (num, den). Its pool is the JAX
    pipeline's, the hits traced from the points of the rays that missed
    included; the forward builds the pool only on the steps that distil,
    and the missed rays' part only for the strategies that hold the first
    `secondary_batch_size` hits (`IDRNetwork.forward_with_uv(secondary_limit=...)`,
    whose hit counts are summed over the ranks). W processes gather their
    pools along the ray axis, in rank order, before they select.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import sys
import time
from datetime import datetime
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from nefii_tpu_torch.config import ConfigFactory, ConfigTree, get_class
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.models.pixel_pair_generator import PixelPairGenerator
from nefii_tpu_torch.parallel import dist, spmd
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils import exr as exr_io
from nefii_tpu_torch.utils import general as utils
from nefii_tpu_torch.utils import telemetry
from nefii_tpu_torch.utils.telemetry import host_sync, span

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


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c as a fused multiply-add in a's type: two float32 values
    multiply exactly in float64, and the sum is rounded to float64 and then to
    a's type, which differs from one rounding only in rare double-rounding
    ties."""
    return (a.double() * float(np.float32(b)) + c.double()).to(a.dtype)


class AdamGroup:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a list of parameters with a
    schedule of the update count, in the arithmetic of the JAX package's
    jitted optax.adam: mu = (1-b1) g + b1 mu and nu = (1-b2) g^2 + b2 nu,
    the step -lr * mu / (bc1 * (sqrt(nu / bc2) + eps)) with bc = 1 - b^count
    in float32, and each of the three sums of a product rounded once, as XLA
    compiles them (fused multiply-adds). A parameter without a gradient gets
    a zero one, so it moves as optax moves it."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float]):
        self.params = params
        self.schedule = schedule
        self.count = 0
        # both moments of every parameter, flat in the order of `params`
        n = sum(p.numel() for p in params)
        dev = params[0].device if params else None
        self.mu = torch.zeros(n, device=dev)
        self.nu = torch.zeros(n, device=dev)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        if not self.params:
            return
        count = torch.tensor(float(self.count))
        with host_sync("adam.bias_correction"):
            bc1 = (1 - torch.pow(torch.tensor(self.B1), count)).to(self.mu.device)
        with host_sync("adam.bias_correction"):
            bc2 = (1 - torch.pow(torch.tensor(self.B2), count)).to(self.mu.device)
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        self.mu = _fma(g, 1 - self.B1, self.mu * self.B1)
        self.nu = _fma(g * g, 1 - self.B2, self.nu * self.B2)
        u = self.mu / (bc1 * (torch.sqrt(self.nu / bc2) + self.EPS))
        flat = _fma(u, -lr, torch.cat([p.reshape(-1) for p in self.params]))
        for p, new in zip(self.params, flat.split([p.numel() for p in self.params])):
            p.copy_(new.view_as(p))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu.cpu(), "nu": self.nu.cpu()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mu = state["mu"].to(self.mu.device)
        self.nu = state["nu"].to(self.nu.device)


class RowAdam(AdamGroup):
    """AdamGroup over one [rows, d] tensor with torch SparseAdam's rows, as the
    JAX trainer applies them (`_mask_adam_rows`): a row whose gradient sums to
    0 in absolute value keeps its parameters and both moments bit for bit;
    the count advances every step, so the bias correction is the step's."""

    @torch.no_grad()
    def step(self) -> None:
        (p,) = self.params
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        keep = ~(g.abs().sum(-1, keepdim=True) > 0).expand_as(p).reshape(-1)
        old_p, old_mu, old_nu = p.detach().reshape(-1).clone(), self.mu, self.nu
        super().step()
        p.copy_(torch.where(keep, old_p, p.reshape(-1)).view_as(p))
        self.mu = torch.where(keep, old_mu, self.mu)
        self.nu = torch.where(keep, old_nu, self.nu)


POOL_KEYS = ("secondary_points", "secondary_mask", "secondary_dir")


def secondary_batch(out: Dict, k_max: int, num_rays: int, multiple: int = 1):
    """The batch the secondary step distils: the first `k_max` hits of the
    pool out["secondary_mask"] [S', N, 1] in its [strategy, ray] order (the
    JAX trainer's stable argsort), each seen along num_rays copies of its
    ray, then rows of the pool's first entry up to a multiple of `multiple`
    rows (the padding of the JAX step, masked out of its loss). -> ({points,
    ray_dirs} [K',R,3], K hits, hits in the pool), or None when the pool has
    no hit or the render type traces no secondary rays."""
    if "secondary_mask" not in out:
        return None
    mask = out["secondary_mask"].reshape(-1)
    with host_sync("pool.count"):
        n_hit = int(mask.sum())
    if n_hit < 1:
        return None
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:min(k_max, n_hit)]
    K = order.shape[0]
    if K % multiple:
        order = torch.cat([order, order.new_zeros(multiple - K % multiple)])
    R = max(num_rays, 1)
    rows = order.shape[0]
    batch = {"points": out["secondary_points"].reshape(-1, 3)[order][:, None].expand(rows, R, 3),
             "ray_dirs": out["secondary_dir"].reshape(-1, 3)[order][:, None].expand(rows, R, 3)}
    return batch, K, n_hit


def distillation_loss(model, batch: Dict[str, torch.Tensor], gen: torch.Generator, *,
                      freeze_geo=True, fake_roughness=False, fake_specular=False,
                      valid: Optional[torch.Tensor] = None, all_reduce=None) -> torch.Tensor:
    """Secondary self-distillation: L1(sg_rgb, idr_rgb) over the points of
    batch {points, ray_dirs} [K,R,3] (the JAX make_point_grad_fn). Without
    `freeze_geo` the implicit net trains through the features. With
    `all_reduce` (a rank's slice of the rows, `valid` [K] masking the
    padding) the L1 is a (num, den) pair summed over the ranks."""
    out = model.forward_with_point(batch, gen, freeze_geo=freeze_geo,
                                   fake_roughness=fake_roughness, fake_specular=fake_specular)
    diff = (out["sg_rgb_values"] - out["idr_rgb_values"]).abs()
    if all_reduce is None:
        return diff.mean()
    num, den = all_reduce(torch.stack([(diff * valid[:, None]).sum(), valid.sum() * 3.0]))
    return torch.where(den > 0, num / den.clamp(min=1.0), torch.zeros_like(num))


PROFILE_STEPS = 3
# chrome-trace categories of device work: kernels, copies and sets
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_after_syncs(busy, sync_ends) -> float:
    """The idle time between the busy intervals `busy` (sorted, disjoint)
    spent in gaps that hold the host end of at least one host sync: the
    device drained its queue while the host waited, then waited for the
    next launch. A gap counts once however many syncs end in it."""
    ends = sorted(sync_ends)
    total = 0.0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        i = bisect.bisect_left(ends, g0)
        if i < len(ends) and ends[i] <= g1:
            total += g1 - g0
    return total


def profile_summary(events, on_device: bool) -> List[str]:
    """The summary lines of a chrome trace's complete events ("ph": "X"),
    a step's average of each. Device work is told from annotations by its
    category, so a span of any name is never counted as a kernel."""
    steps, dev_ops, spans, extents = [], [], {}, {}
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        t0, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev_ops.append((t0, t0 + dur, name))
        elif cat == "user_annotation":
            if name.startswith("ProfilerStep"):
                steps.append(dur)
            else:
                spans.setdefault(name, []).append((t0, t0 + dur))
        elif cat == "gpu_user_annotation":
            extents[name] = extents.get(name, 0.0) + dur
    n = max(len(steps), 1)
    wall = sum(steps) / 1e6
    busy = _union([(a, b) for a, b, _ in dev_ops])
    busy_s = sum(b - a for a, b in busy) / 1e6
    syncs = {k[len(telemetry.SYNC_PREFIX):]: v for k, v in spans.items()
             if k.startswith(telemetry.SYNC_PREFIX)}
    n_syncs = sum(len(v) for v in syncs.values())
    head = f"{n} steps: {wall / n:.3f} s wall a step, "
    if on_device and wall > 0:
        after = idle_after_syncs(busy, [b for v in syncs.values() for _, b in v]) / 1e6
        head += (f"device busy {busy_s / n:.3f} s a step, idle {100 * (1 - busy_s / wall):.1f}%, "
                 f"idle after a host sync {100 * after / wall:.1f}%")
    else:
        head += "no device (a CPU run)"
    lines = [head, f"host syncs: {n_syncs / n:g} a step"]
    for site, iv in sorted(syncs.items(), key=lambda kv: -len(kv[1]))[:10]:
        lines.append(f"host sync {site}: {len(iv) / n:g} a step")
    for name, iv in sorted(spans.items(), key=lambda kv: -sum(b - a for a, b in kv[1])):
        if name.startswith(telemetry.SYNC_PREFIX):
            continue
        lines.append(f"span {name}: {len(iv) / n:g} calls, host "
                     f"{sum(b - a for a, b in iv) / 1e6 / n:.3f} s, device timeline "
                     f"{extents.get(name, 0.0) / 1e6 / n:.3f} s a step")
    by_kernel = {}
    for a, b, name in dev_ops:
        c, t = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (c + 1, t + b - a)
    for name, (c, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]:
        lines.append(f"kernel {name[:90]}: {c / n:g} launches, {t / 1e6 / n:.3f} s a step")
    return lines


class StepProfiler:
    """torch.profiler over training steps: the first step warms up and is not
    recorded, the next PROFILE_STEPS are. Then it writes `trace.json` (chrome
    trace) and `summary.txt` into out_dir and prints the summary
    (`profile_summary`), a step's average of: the wall time (ProfilerStep,
    which ends in the step's synchronisation), the device's busy time (the
    union of its kernels, copies and sets), its idle share and the part of
    it in gaps after a host sync, the host syncs by site (the ten most
    frequent), each span's host time and extent on the device timeline, and
    the kernels by device time."""

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
        path = os.path.join(self.out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        lines = profile_summary(events, self.on_device)
        with open(os.path.join(self.out_dir, "summary.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        for line in lines:
            print("[profile]", line, flush=True)


class IDRTrainRunner:
    def __init__(self, **kwargs):
        conf = kwargs["conf"]
        self.conf = conf if isinstance(conf, ConfigTree) else ConfigFactory.parse_file(conf)
        if torch.device(kwargs.get("device", "cuda")).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
        # this process's rank and card in a multi-process run (dist.initialize)
        self.rank, self.world = dist.rank(), dist.process_count()
        self.is_main = dist.is_main()
        self.device = dist.world_device(kwargs.get("device", "cuda"))
        self.all_reduce = spmd.loss_all_reduce()
        if self.device.type == "cuda":
            from nefii_tpu_torch.ops.kernels import build

            dist.build_once(build.build_all)
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
        self.train_cameras = kwargs.get("train_cameras", False)
        self.freeze_geo = self.freeze_geometry or self.freeze_idr

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
        # hosts' clocks and directory listings may disagree: rank 0's stamp
        self.timestamp = timestamp = dist.broadcast_str(timestamp)
        self.rundir = os.path.join(self.expdir, timestamp)
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        self.plots_dir = os.path.join(self.rundir, "plots")
        if self.is_main:
            self._write_run_dir(kwargs["conf"], is_continue)
        dist.barrier()

        # ---- data -----------------------------------------------------------
        dataset_class = get_class(self.conf.get_string("train.dataset_class"))
        gamma, wo_mask = kwargs.get("gamma", 1.0), kwargs.get("wo_mask", False)
        subsample = kwargs.get("subsample", 1)
        self.train_dataset = dataset_class(gamma, kwargs["data_split_dir"], self.train_cameras,
                                           subsample, wo_mask=wo_mask)
        vis_sub = subsample * kwargs.get("vis_subsample", 1)
        self.plot_dataset = dataset_class(gamma, kwargs["data_split_dir"], self.train_cameras,
                                          vis_sub, wo_mask=wo_mask)
        test_dir = kwargs.get("data_split_dir_test") or kwargs["data_split_dir"]
        self.test_dataset = dataset_class(gamma, test_dir, False, vis_sub, wo_mask=wo_mask)

        # ---- model / loss ---------------------------------------------------
        model_class = get_class(self.conf.get_string("train.model_class"))
        self.model = model_class.from_conf(self.conf.get_config("model"), device=self.device,
                                           seed=self.seed)
        self.loss = IDRLoss(**self.conf.get_config("loss").as_plain_dict())
        if self.train_cameras and self.loss.view_diff_weight > 0:
            raise ValueError("view_diff loss and --train_cameras are mutually exclusive")

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
        # camera poses: a leaf beside the model, trained by its own Adam
        self.pose_vecs = None
        self.cam_optimizer = None
        if self.train_cameras:
            self.pose_vecs = torch.as_tensor(self.train_dataset.get_pose_init(),
                                             device=self.device).requires_grad_(True)
            self.cam_optimizer = RowAdam(
                [self.pose_vecs],
                multistep_lr(self.conf.get_float("train.learning_rate_cam", default=1e-3), [], 1.0))

        # ---- pretrained / partial loads ------------------------------------
        self.start_epoch = 0
        self.cur_iter = 0
        self._partial_loads(kwargs, is_continue)

        # ---- schedule/bookkeeping ------------------------------------------
        self.remat = self.conf.get_bool("train.remat", default=False)
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
        self.gen = torch.Generator(device=self.device).manual_seed(
            spmd.rank_seed(self.seed + 1, self.rank))
        # per training step: iteration, seconds, rays, loss, the seconds and
        # distilled hits of its secondary step (0 when none ran), the
        # view-diff pairing's seconds (0 without it) and its loss term
        self.step_stats: List[Dict] = []

    def _write_run_dir(self, conf, is_continue: bool) -> None:
        """The run directory: runconf.conf, the code backup, runcmd.txt."""
        for d in (self.rundir, self.checkpoints_path, self.plots_dir):
            utils.mkdir_ifnotexists(d)
        conf_path = conf if isinstance(conf, str) else None
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

    # ------------------------------------------------------------------
    def _partial_loads(self, kwargs, is_continue):
        """The JAX trainer's loads, on its conditions: a path that does not
        exist is skipped; a geometry is a torch `.pth` state dict or a
        JAX-layout checkpoint directory."""
        p = kwargs.get("pretrain_geometry_path")
        if p and os.path.exists(p):
            if p.endswith(".pth"):
                ckpt.import_torch_implicit(self.model, p)
            else:
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
                ckdir, kwargs.get("checkpoint", "latest"), self.model, self.pose_vecs)
            for name, group in self.optimizers.items():
                group.load_state_dict(states[name])
            if self.cam_optimizer is not None and "cam" in states:
                self.cam_optimizer.load_state_dict(states["cam"])

        g = kwargs.get("geometry", "")
        if g.endswith(".pth") and os.path.exists(g):
            ckpt.import_torch_implicit(self.model, g)
        elif g and os.path.isdir(g):
            ckpt.restore_subtree(self.model, g, "latest", "implicit_network")
        gn = kwargs.get("geometry_neus", "")
        if gn.endswith(".pth") and os.path.exists(gn):
            ckpt.import_torch_implicit(self.model, gn, module_prefix="",
                                       state_key="sdf_network_fine")

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
        """Rank 0 writes; the other ranks wait for it."""
        if self.is_main:
            states = {k: g.state_dict() for k, g in self.optimizers.items()}
            if self.cam_optimizer is not None:
                states["cam"] = self.cam_optimizer.state_dict()
            ckpt.save_all(self.checkpoints_path, epoch, self.model, states, self.cur_iter,
                          self.pose_vecs)
        dist.barrier()

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
        """The batch on the device; with --train_cameras it has no pose (the
        step gathers it from pose_vecs by `pose_indices`)."""
        out = {"uv": self._upload(model_input["uv"], np.float32),
               "object_mask": self._upload(model_input["object_mask"]),
               "intrinsics": self._upload(model_input["intrinsics"], np.float32)}
        if "pose" in model_input:
            out["pose"] = self._upload(model_input["pose"], np.float32)
        return out

    def _upload(self, x, dtype=None) -> torch.Tensor:
        """x on the device: a copy from pageable host memory, which waits
        for the device's queue."""
        with host_sync("inputs.upload"):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

    def _append_paired_view(self, batch, gt, indices):
        """Cross-view pairing for the view-diff loss: trace the batch's pixels
        (the mean of their rays), project them into each image's partner view
        (i + 3) % n, and append the partners as a second block of batch rows
        with their fetched rgb, masks and `gt["pixel_visible"]`; a multi-ray
        batch re-jitters the paired uv with the dataset's ray offsets."""
        ds = self.train_dataset
        uv = batch["uv"]
        query = {"intrinsics": batch["intrinsics"], "pose": batch["pose"],
                 "uv": uv if uv.dim() == 3 else uv.mean(2),
                 "object_mask": batch["object_mask"]}
        pair_id = [(int(i) + 3) % len(ds) for i in indices]
        paired = PixelPairGenerator(ds, self.model).find_paired_pixel(query, pair_id)
        p_uv = paired["uv"]
        if uv.dim() == 4:
            p_uv = torch.as_tensor(ds.batch_ray_sample(p_uv.cpu().numpy()), device=uv.device)
        batch = {"uv": torch.cat([uv, p_uv]),
                 "object_mask": torch.cat([batch["object_mask"], paired["object_mask"]]),
                 "intrinsics": torch.cat([batch["intrinsics"], paired["intrinsics"]]),
                 "pose": torch.cat([batch["pose"], paired["pose"]])}
        gt = {"rgb": torch.cat([gt["rgb"], paired["gt_rgb"]]),
              "pixel_visible": paired["pixel_visible"].reshape(len(pair_id), -1)}
        return batch, gt

    # ------------------------------------------------------------------
    def train_step(self, batch, gt, fake_r: bool, fake_s: bool, alpha: float,
                   distil: bool = False):
        """One training step: forward, loss, backward, both Adam updates and,
        with --train_cameras, the pose update (the batch's pose rows gathered
        from pose_vecs by batch["pose_indices"]). -> (loss dict, model
        outputs, finite). A non-finite loss updates nothing. With `distil`
        the outputs hold the secondary-hit pool as far as the secondary
        step's batch needs it. In a multi-process run `batch` and `gt` are
        this rank's slices; the loss is the whole batch's on every rank, so
        every rank skips a non-finite step together."""
        optimizers = list(self.optimizers.values())
        if self.cam_optimizer is not None:
            optimizers.append(self.cam_optimizer)
            batch = dict(batch)
            batch["pose"] = self.pose_vecs[batch.pop("pose_indices")]
        for group in optimizers:
            group.zero_grad()
        with span("train.forward"):
            out = self.model.forward_with_uv(
                batch, self.gen, training=True, freeze_geo=self.freeze_geo,
                fake_roughness=fake_r, fake_specular=fake_s,
                secondary_limit=self.secondary_batch_size if distil else 0, remat=self.remat,
                all_reduce=self.all_reduce)
        with span("train.loss"):
            ld = self.loss(out, gt, alpha=alpha, all_reduce=self.all_reduce)
        with host_sync("loss.finite"):
            finite = np.isfinite(float(ld["loss"].detach()))
        if not finite:
            return ld, out, False
        with span("train.backward"):
            ld["loss"].backward()
        with span("train.update"):
            for group in optimizers:
                spmd.all_reduce_grads(group.params)
                group.step()
        return ld, out, True

    def _train_with_secondary(self, out, fake_r, fake_s) -> int:
        """Secondary self-distillation on at most secondary_batch_size of the
        step's secondary hits, each seen along num_rays copies of its ray.
        -> the number of hits distilled (0: there was none, nothing ran). W
        processes select from their pools gathered along the ray axis, and
        each distils its slice of the rows (padded to a multiple of W)."""
        if self.world > 1:
            out = {k: dist.gather_along(out[k], 1) for k in POOL_KEYS if k in out}
        picked = secondary_batch(out, self.secondary_batch_size, self.num_rays, self.world)
        if picked is None:
            return 0
        batch, K, n_hit = picked
        valid = None
        if self.world > 1:
            valid = spmd.shard((torch.arange(batch["points"].shape[0], device=self.device)
                                < K).float())
            batch = spmd.shard_batch(batch)
        for group in self.optimizers.values():
            group.zero_grad()
        with span("train.secondary"):
            loss = distillation_loss(self.model, batch, self.gen, freeze_geo=self.freeze_geo,
                                     fake_roughness=fake_r, fake_specular=fake_s, valid=valid,
                                     all_reduce=self.all_reduce)
            loss.backward()
            for group in self.optimizers.values():
                spmd.all_reduce_grads(group.params)
                group.step()
        if self.is_main and self.cur_iter % 50 == 0:
            with host_sync("distil.log"):
                loss = float(loss.detach())
            print(f"\tsecondary_num={K}/{n_hit}, secondary_loss = {loss:.6f}")
        return K

    def _sync(self):
        if self.device.type == "cuda":
            with host_sync("step_end"):
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self):
        mse2psnr = lambda x: -10.0 * np.log(x + 1e-8) / np.log(10.0)
        n_images = len(self.train_dataset)
        prof = (StepProfiler(self.profile_dir, self.device)
                if self.profile_dir and self.is_main else None)

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

                syncs = telemetry.sync_total()
                indices, model_input, ground_truth = self.train_dataset.collate(
                    [self.train_dataset[int(i)] for i in img_ids])
                batch = self._device_inputs(model_input)
                gt = {"rgb": self._upload(ground_truth["rgb"], np.float32)}
                if self.train_cameras:
                    batch["pose_indices"] = self._upload(indices)
                pair_seconds = 0.0
                if self.loss.view_diff_weight > 0:
                    t0 = time.perf_counter()
                    with span("train.pairing"):
                        batch, gt = self._append_paired_view(batch, gt, indices)
                    self._sync()
                    pair_seconds = time.perf_counter() - t0
                # every rank pairs the whole batch, then takes its slice
                rays = int(batch["uv"].shape[:-1].numel())
                batch, gt = spmd.shard_batch(batch), spmd.shard_batch(gt)
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
                with host_sync("stats.loss"):
                    loss, view_diff_loss = torch.stack(
                        [loss_dict["loss"].detach(), loss_dict["view_diff_loss"].detach()]).tolist()
                self.step_stats.append(dict(
                    iter=self.cur_iter, seconds=seconds, rays=rays, loss=loss,
                    secondary_seconds=sec_seconds, secondary_points=n_distilled,
                    pairing_seconds=pair_seconds, view_diff_loss=view_diff_loss,
                    host_syncs=telemetry.sync_total() - syncs))
                self.cur_iter += 1
                if prof is not None:
                    prof.step()
        stop_profiler()
        self.save_checkpoints(self.nepochs)

    def log_scalars(self, epoch, loss_dict, mse2psnr, alpha):
        if not self.is_main:
            return
        it = self.cur_iter
        with host_sync("log.scalars"):
            vals = dict(zip(loss_dict, torch.stack(
                [v.detach() for v in loss_dict.values()]).tolist()))
        print(f"{self.expname} [{epoch}] ({it}): loss = {vals['loss']:.6f}, "
              f"idr_rgb = {vals['idr_rgb_loss']:.6f}, sg_rgb = {vals['sg_rgb_loss']:.6f}, "
              f"eikonal = {vals['eikonal_loss']:.6f}, mask = {vals['mask_loss']:.6f}, "
              f"alpha = {alpha:.1f}, idr_psnr = {mse2psnr(vals['idr_rgb_loss'] ** 2):.2f}, "
              f"sg_psnr = {mse2psnr(vals['sg_rgb_loss'] ** 2):.2f}", flush=True)

    # ------------------------------------------------------------------
    def vis(self, split: str, it: int, img_idx: int = 0):
        """Render a full view and write the panel PNG (gt|sg|idr,
        diffuse|specular|normal, albedo|roughness|specular, depth), the sg_rgb
        EXR and the current envmap EXR; on the train split also the SDF's
        zero-surface (the plain implicit net) as surface_<it>.obj. Every rank
        renders its share (render_image); rank 0 writes."""
        from nefii_tpu_torch.ops.sg import compute_envmap
        from nefii_tpu_torch.utils.plots import depth_map, export_surface
        from nefii_tpu_torch.utils.png import write_png

        dataset = self.plot_dataset if split == "train" else self.test_dataset
        out = self.render_image(dataset, img_idx)
        if not self.is_main:
            return
        H, W = dataset.img_res

        def im(key):
            v = out[key].reshape(H, W, -1)
            return np.clip(np.tile(v, (1, 1, 3)) if v.shape[-1] == 1 else v, 0, 1)

        depth = depth_map(np.asarray(out["points"]).reshape(-1, 3), dataset.pose_all[img_idx],
                          np.asarray(out["network_object_mask"]).reshape(-1).astype(bool), (H, W))
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
        with torch.no_grad():
            env = compute_envmap(em.get_lgtSGs(), 64, 128, coordinate_type=self.coordinate_type,
                                 envmap_type="sg" if em.light_type == "sg" else "constant")
        exr_io.write(os.path.join(self.plots_dir, f"{split}_{it}_envmap.exr"), env.cpu().numpy())
        if split == "train":
            export_surface(self.model.implicit_network.sdf,
                           os.path.join(self.plots_dir, f"surface_{it}.obj"),
                           resolution=self.conf.get_int("plot.surface_resolution", default=100),
                           device=self.device)

    @torch.no_grad()
    def render_image(self, dataset, img_idx: int = 0) -> Dict[str, np.ndarray]:
        """Chunked full-image eval render, one ray per pixel, each chunk
        through the sharded eval forward (every rank must call it)."""
        from nefii_tpu_torch.scripts.render import OUTPUT_KEYS

        saved = dataset.sampling_idx, dataset.sampling_rays
        dataset.sampling_idx = dataset.sampling_rays = None
        item = dataset[img_idx]
        dataset.sampling_idx, dataset.sampling_rays = saved
        _, model_input, ground_truth = dataset.collate([item])
        if "pose" not in model_input:
            # --train_cameras renders at the dataset's pose, not the learned one
            model_input["pose"] = dataset.pose_all[img_idx][None]
        total = dataset.total_pixels
        n_pix = min(utils.pixels_per_chunk(self.memory_capacity_level, 1, self.world),
                    total + (-total) % self.world)
        gen = torch.Generator(device=self.device).manual_seed(spmd.rank_seed(0, self.rank))

        def forward(chunk):
            out = spmd.eval_forward(self.model, self._device_inputs(chunk), gen, OUTPUT_KEYS)
            return {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}

        out = utils.chunked_forward(forward, model_input, total, n_pix)
        out["gt"] = np.asarray(ground_truth["rgb"][0])
        return out
