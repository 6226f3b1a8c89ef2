"""GeometryTrainRunner — Step 1, the SDF fit to a mesh (counterpart of
nefii_tpu/training/geometry_trainer.py).

It regresses the implicit net onto mesh SDF samples with an L1 loss: the
mean over the batch of |implicit(pts)[:, 0:1] - sdf|. One Adam over the
implicit and rendering nets (the material net is not trained) follows the
MultiStep schedule idr_learning_rate / idr_sched_milestones /
idr_sched_factor. The run directory holds runconf.conf, runcmd.txt,
checkpoints/ (the JAX package's .npz layout, tags <it> and `latest`, so both
packages' Step 2 read it with --geometry) and plots/ (geo_<it>.png, normals |
depth of one view traced through the current SDF).

The native sampler runs on a background thread that fills a queue of four
batches; ctypes releases the GIL in the native loops, so sampling overlaps
the device step. The main thread uploads each batch to the device.

Differences by design from the JAX runner:
  * One device. The JAX runner shards the point batch over a mesh with a
    psum'd (num, den) loss, which equals this loss on one device.
  * --is_continue restores the parameters of the newest run directory that
    holds the checkpoint, looked up before this run makes its own (the JAX
    runner looks after, in the directory it has just made, and finds none).
    Like the JAX runner it restarts the iteration count at 0 and the
    optimizer fresh.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import threading
import time
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch

from nefii_tpu_torch.config import ConfigFactory, ConfigTree, get_class
from nefii_tpu_torch.datasets.sdf_dataset import SDFDataset
from nefii_tpu_torch.training.trainer import AdamGroup, multistep_lr
from nefii_tpu_torch.utils import checkpoints as ckpt
from nefii_tpu_torch.utils import general as utils

TRAINED = ("implicit_network", "rendering_network")


class GeometryTrainRunner:
    def __init__(self, **kwargs):
        conf = kwargs["conf"]
        self.conf = conf if isinstance(conf, ConfigTree) else ConfigFactory.parse_file(conf)
        self.device = torch.device(kwargs.get("device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
        # full-fp32 matmuls (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.batch_points = kwargs.get("batch_points", 16384)
        self.max_niters = kwargs.get("max_niters", 800_000)
        self.exps_folder_name = kwargs.get("exps_folder_name", "exps")
        self.expname = kwargs.get("expname") or (
            self.conf.get_string("train.expname", default="geometry") + "_geometry")
        self.seed = kwargs.get("seed", 0)

        self.timestamp = kwargs.get("timestamp") or datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.expdir = os.path.join(self.exps_folder_name, self.expname)
        restore_from = (self._checkpoint_dir(kwargs.get("old_expdir") or self.expdir,
                                             kwargs.get("checkpoint", "latest"))
                        if kwargs.get("is_continue") else None)
        self.rundir = os.path.join(self.expdir, self.timestamp)
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        self.plots_dir = os.path.join(self.rundir, "plots")
        for d in (self.rundir, self.checkpoints_path, self.plots_dir):
            utils.mkdir_ifnotexists(d)
        conf_path = kwargs["conf"] if isinstance(kwargs["conf"], str) else None
        if conf_path and os.path.exists(conf_path):
            shutil.copy(conf_path, os.path.join(self.rundir, "runconf.conf"))
        with open(os.path.join(self.rundir, "runcmd.txt"), "a") as f:
            f.write(" ".join(sys.argv) + "\n")

        # data: mesh -> SDF sample stream
        self.dataset = SDFDataset(
            kwargs["mesh_path"], self.batch_points, self.max_niters,
            scale_to_unit=kwargs.get("scale_to_unit", True), seed=self.seed)

        # optional scene split for the vis renders
        self.plot_dataset = None
        if kwargs.get("data_split_dir"):
            from nefii_tpu_torch.datasets.scene_dataset import SceneDataset

            self.plot_dataset = SceneDataset(
                kwargs.get("gamma", 1.0), kwargs["data_split_dir"], False,
                kwargs.get("subsample", 1) * kwargs.get("vis_subsample", 1),
                wo_mask=kwargs.get("wo_mask", False))

        model_class = get_class(self.conf.get_string("train.model_class"))
        self.model = model_class.from_conf(self.conf.get_config("model"), device=self.device,
                                           seed=self.seed)
        params = [p for n, p in self.model.named_parameters() if n.split(".", 1)[0] in TRAINED]
        self.optimizer = AdamGroup(params, multistep_lr(
            self.conf.get_float("train.idr_learning_rate"),
            self.conf.get_list("train.idr_sched_milestones", default=[]),
            self.conf.get_float("train.idr_sched_factor", default=0.0)))

        if restore_from is not None:
            flat, _ = ckpt.load_collection(restore_from, ckpt.MODEL,
                                           kwargs.get("checkpoint", "latest"))
            ckpt.params_from_jax(self.model, flat)

        self.ckpt_freq = self.conf.get_int("train.ckpt_freq", default=2000)
        self.plot_freq = self.conf.get_int("train.plot_freq", default=2000)
        self.log_freq = kwargs.get("log_freq", 50)
        # per step: iteration, loss, the step's seconds (upload, forward,
        # backward, update, synchronised), the main loop's wait on the queue
        # and the producer's seconds to sample the batch
        self.step_stats: List[Dict] = []

    # ------------------------------------------------------------------
    @staticmethod
    def _checkpoint_dir(old_expdir: str, tag) -> str:
        """The checkpoints/ of the newest run under old_expdir that holds
        checkpoint `tag` (looked up before this run makes its own directory)."""
        stamps = sorted(s for s in (os.listdir(old_expdir) if os.path.isdir(old_expdir) else ())
                        if os.path.exists(os.path.join(old_expdir, s, "checkpoints", ckpt.MODEL,
                                                       f"{tag}.npz")))
        if not stamps:
            raise FileNotFoundError(f"--is_continue: no run under {old_expdir} holds a "
                                    f"{tag!r} checkpoint")
        return os.path.join(old_expdir, stamps[-1], "checkpoints")

    def save_checkpoints(self, it: int):
        params = ckpt.params_to_jax(self.model)
        for tag in (str(it), "latest"):
            ckpt.save_collection(self.checkpoints_path, ckpt.MODEL, tag, params, {"epoch": it})

    # ------------------------------------------------------------------
    def train_step(self, pts: torch.Tensor, sdf_gt: torch.Tensor) -> torch.Tensor:
        """One Adam step on the L1 loss of the points [P,3] against their
        SDF [P,1]. -> the loss before the update (detached)."""
        self.optimizer.zero_grad()
        pred = self.model.implicit_network(pts)[:, 0:1]
        loss = (pred - sdf_gt).abs().sum() / pred.numel()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _producer(self, q: "queue.Queue", n_iters: int, stop: threading.Event):
        """Put (points, sdf, seconds to sample) for each iteration, then None;
        an exception is put in place of the batch that raised it. Stops
        putting once `stop` is set."""
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            for i in range(n_iters):
                t0 = time.perf_counter()
                if not put((*self.dataset[i], time.perf_counter() - t0)):
                    return
        except Exception as e:  # handed to the main loop, which raises it
            put(e)
            return
        put(None)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n_iters: int = None):
        n_iters = n_iters or self.max_niters
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()
        t = threading.Thread(target=self._producer, args=(q, n_iters, stop), daemon=True)
        t.start()
        try:
            self._loop(q, n_iters)
        finally:
            stop.set()
            t.join(timeout=60)

    def _loop(self, q: "queue.Queue", n_iters: int):
        it = 0
        while True:
            t0 = time.perf_counter()
            item = q.get()
            wait = time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, Exception):
                raise RuntimeError("the SDF sampler failed") from item
            pts, sdf_gt, sample_seconds = item
            t1 = time.perf_counter()
            loss = self.train_step(torch.as_tensor(pts, device=self.device),
                                   torch.as_tensor(sdf_gt, device=self.device))
            self._sync()
            seconds = time.perf_counter() - t1
            lv = float(loss)
            self.step_stats.append(dict(iter=it, seconds=seconds, wait=wait,
                                        sample_seconds=sample_seconds, loss=lv))
            if it % self.ckpt_freq == 0:
                self.save_checkpoints(it)
            if self.plot_dataset is not None and it > 0 and it % self.plot_freq == 0:
                self.vis(it)
            if it % self.log_freq == 0:
                if not np.isfinite(lv):
                    print("[WARNING] NaN in geometry loss — checkpoint and exit")
                    self.save_checkpoints(it)
                    return
                print(f"geometry [{it}/{n_iters}]: l1 = {lv:.6f}", flush=True)
            it += 1
        self.save_checkpoints(it)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def vis(self, it: int, img_idx: int = 0):
        """Trace one view of the plot split through the current SDF (the
        plain implicit net) and write plots/geo_<it>.png: normals | depth."""
        from nefii_tpu_torch.utils.camera import get_camera_params
        from nefii_tpu_torch.utils.plots import depth_map
        from nefii_tpu_torch.utils.png import write_png

        ds = self.plot_dataset
        H, W = ds.img_res
        _, sample, _ = ds[img_idx]
        dev = self.device
        pose = np.asarray(sample.get("pose", ds.pose_all[img_idx]), np.float32)
        rays, cam = get_camera_params(
            torch.as_tensor(np.asarray(sample["uv"], np.float32)[None], device=dev),
            torch.as_tensor(pose[None], device=dev),
            torch.as_tensor(np.asarray(sample["intrinsics"], np.float32)[None], device=dev))
        imp = self.model.implicit_network
        res = self.model.ray_tracer(imp.sdf, cam, torch.as_tensor(sample["object_mask"],
                                                                  device=dev), rays)
        g = imp.gradient(res.points)
        normals = (g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-6)).cpu().numpy()
        hit = res.object_mask.cpu().numpy()

        normal_img = np.where(hit[:, None], (normals + 1) / 2, 1.0).reshape(H, W, 3)
        depth_img = depth_map(res.points.cpu().numpy(), pose, hit, (H, W))
        panel = np.concatenate([normal_img, depth_img], axis=1)
        write_png(os.path.join(self.plots_dir, f"geo_{it}.png"),
                  (np.clip(panel, 0, 1) * 255).astype(np.uint8))
