"""Novel-view rendering with the PyTorch + CUDA port (counterpart of
nefii_tpu/scripts/render.py).

Restores a checkpoint written in the JAX package's `.npz` layout, renders
the test split at full resolution with multi-ray anti-aliasing
(`--num_rays`), and writes per view the EXRs gt, rerender_rgb, diffuse_rgb,
specular_rgb, diffuse_albedo, roughness and specular_reflection, a stacked
preview PNG, and envmap.exr once. With `--export_mesh_resolution N` it also
writes surface_high_res.ply, the SDF's zero-surface (utils/plots.py
get_surface_high_res_mesh of the plain implicit net, N samples on the
shortest axis, within the tracer's bounding sphere).

    python -m nefii_tpu_torch.scripts.render --conf confs/conf.conf \
        --data_split_dir <scene_test> --old_expdir exps/robot \
        --timestamp latest --num_rays 256 [--device cuda]

Rays go through the model in chunks of pixels_per_chunk(memory_capacity_level,
num_rays, world size) pixels. Each view draws its Monte-Carlo samples from a
torch.Generator seeded with the view index (and the rank). TF32 is off for
matmuls and convolutions, so the plain MLPs run in full fp32.

Multi-GPU, as the trainer (training/exp_runner.py): under torchrun or with
--multihost --coordinator_address --num_processes --process_id, each
process renders its contiguous slice of every chunk on its card
(spmd.eval_forward), the chunk's outputs are gathered, and rank 0 writes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

OUTPUT_KEYS = (
    "idr_rgb_values", "sg_rgb_values", "normal_values", "sg_diffuse_rgb_values",
    "sg_diffuse_albedo_values", "sg_specular_rgb_values", "sg_roughness_values",
    "sg_specular_reflection_values", "network_object_mask", "points",
)


def add_argument(parser):
    from nefii_tpu_torch.training.exp_runner import add_argument as base_args

    parser = base_args(parser)
    parser.add_argument("--num_rays", type=int, default=64, help="anti-aliasing rays per pixel")
    parser.add_argument("--no_auto_budget", action="store_true",
                        help="accepted for compatibility; no effect: the port renders dense, "
                             "without compaction budgets")
    parser.add_argument("--out_dir", type=str, default="")
    parser.add_argument("--max_views", type=int, default=-1)
    parser.add_argument("--envmap_size", type=int, nargs=2, default=[256, 512])
    parser.add_argument("--export_mesh_resolution", type=int, default=0,
                        help="write surface_high_res.ply at this resolution (0: no mesh)")
    return parser


class RenderRunner:
    def __init__(self, **kwargs):
        from nefii_tpu_torch.config import ConfigFactory, ConfigTree, get_class
        from nefii_tpu_torch.ops.kernels import build
        from nefii_tpu_torch.parallel import dist
        from nefii_tpu_torch.utils import checkpoints as ckpt

        # full-fp32 matmuls and convolutions (no TF32) for the plain MLPs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.device(kwargs.get("device", "cuda")).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
        self.rank, self.world, self.is_main = dist.rank(), dist.process_count(), dist.is_main()
        self.device = dist.world_device(kwargs.get("device", "cuda"))
        if self.device.type == "cuda":
            dist.build_once(build.build_all)

        conf = kwargs["conf"]
        self.conf = conf if isinstance(conf, ConfigTree) else ConfigFactory.parse_file(conf)
        self.num_rays = kwargs.get("num_rays", 64)
        self.memory_capacity_level = kwargs.get("memory_capacity_level", 18)
        self.coordinate_type = kwargs.get("coordinate_type", "mitsuba")

        dataset_class = get_class(self.conf.get_string("train.dataset_class"))
        self.dataset = dataset_class(
            kwargs.get("gamma", 1.0), kwargs["data_split_dir"], False,
            kwargs.get("subsample", 1), wo_mask=kwargs.get("wo_mask", False))

        model_class = get_class(self.conf.get_string("train.model_class"))
        self.model = model_class.from_conf(self.conf.get_config("model"), device=self.device)
        self.model.eval()

        expdir = kwargs.get("old_expdir") or os.path.join(
            kwargs.get("exps_folder_name", "exps"),
            kwargs.get("expname") or self.conf.get_string("train.expname", default="default"))
        timestamp = kwargs.get("timestamp", "latest")
        if timestamp == "latest" and os.path.isdir(expdir):
            timestamp = sorted(os.listdir(expdir))[-1]
        timestamp = dist.broadcast_str(timestamp)
        ckdir = os.path.join(expdir, timestamp, "checkpoints")
        flat, _ = ckpt.load_collection(ckdir, ckpt.MODEL, kwargs.get("checkpoint", "latest"))
        ckpt.params_from_jax(self.model, flat)
        print(f"restored checkpoint from {ckdir}")

        self.out_dir = kwargs.get("out_dir") or os.path.join(expdir, timestamp, "renders")
        if self.is_main:
            os.makedirs(self.out_dir, exist_ok=True)
        self.envmap_size = tuple(kwargs.get("envmap_size", (256, 512)))
        self.max_views = kwargs.get("max_views", -1)
        self.export_mesh_resolution = kwargs.get("export_mesh_resolution", 0)
        # per view: seconds, pixels, rays, executed SDF evaluations, hit fraction
        self.stats = []

    # ------------------------------------------------------------------
    def render_view(self, img_idx: int):
        """Full-resolution render of one view with multi-ray AA (every rank
        renders its slice of each chunk and gets the whole view)."""
        from nefii_tpu_torch.parallel import spmd
        from nefii_tpu_torch.utils import general as utils

        ds = self.dataset
        ds.sampling_idx = None
        ds.change_sampling_rays(self.num_rays if self.num_rays > 1 else -1,
                                np.random.default_rng(img_idx))
        idx, model_input, ground_truth = ds[img_idx]
        _, model_input, ground_truth = ds.collate([(idx, model_input, ground_truth)])
        ds.change_sampling_rays(-1)

        total = ds.total_pixels
        rays_per_px = max(self.num_rays, 1)
        n_pix = max(min(utils.pixels_per_chunk(self.memory_capacity_level, rays_per_px,
                                               self.world), total), self.world)
        n_pix -= n_pix % self.world
        gen = torch.Generator(device=self.device).manual_seed(spmd.rank_seed(img_idx, self.rank))
        dev = self.device
        evals = []

        def forward(chunk):
            batch = {
                "uv": torch.as_tensor(np.asarray(chunk["uv"], np.float32), device=dev),
                "object_mask": torch.as_tensor(np.asarray(chunk["object_mask"]), device=dev),
                "intrinsics": torch.as_tensor(np.asarray(chunk["intrinsics"], np.float32),
                                              device=dev),
                "pose": torch.as_tensor(np.asarray(chunk["pose"], np.float32), device=dev),
            }
            out = spmd.eval_forward(self.model, batch, gen, OUTPUT_KEYS)
            evals.append(out["n_sdf_evals"])
            return {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}

        t0 = time.perf_counter()
        out = utils.chunked_forward(forward, model_input, total, n_pix)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        out["gt"] = np.asarray(ground_truth["rgb"][0])
        self.stats.append(dict(
            view=img_idx, seconds=seconds, pixels=total, rays=total * rays_per_px,
            sdf_evals=sum(evals), hit_fraction=float(out["network_object_mask"].mean())))
        return out

    def write_view(self, img_idx: int, out):
        from nefii_tpu_torch.utils import exr as exr_io
        from nefii_tpu_torch.utils.png import write_png

        H, W = self.dataset.img_res

        def img(key):
            v = out[key]
            if v.ndim == 1 or v.shape[-1] == 1:
                v = np.tile(v.reshape(H, W, 1), (1, 1, 3))
            return v.reshape(H, W, 3)

        panels = {
            "gt": img("gt"),
            "rerender_rgb": img("sg_rgb_values"),
            "diffuse_rgb": img("sg_diffuse_rgb_values"),
            "specular_rgb": img("sg_specular_rgb_values"),
            "diffuse_albedo": img("sg_diffuse_albedo_values"),
            "roughness": img("sg_roughness_values"),
            "specular_reflection": img("sg_specular_reflection_values"),
        }
        for name, data in panels.items():
            exr_io.write(os.path.join(self.out_dir, f"{name}_{img_idx:03d}.exr"), data)
        stack = np.concatenate(
            [np.clip(panels[k], 0, 1) for k in
             ("gt", "rerender_rgb", "diffuse_rgb", "specular_rgb", "diffuse_albedo",
              "roughness")], axis=1)
        write_png(os.path.join(self.out_dir, f"render_{img_idx:03d}.png"),
                  (stack * 255).astype(np.uint8))

    @torch.no_grad()
    def write_envmap(self):
        from nefii_tpu_torch.utils import exr as exr_io
        from nefii_tpu_torch.ops.sg import compute_envmap

        em = self.model.envmap_material_network
        env = compute_envmap(em.get_lgtSGs(), *self.envmap_size,
                             coordinate_type=self.coordinate_type,
                             envmap_type="sg" if em.light_type == "sg" else "constant")
        exr_io.write(os.path.join(self.out_dir, "envmap.exr"), env.cpu().numpy())

    def write_mesh(self):
        """The SDF's zero-surface at export_mesh_resolution, through the plain
        implicit net, as surface_high_res.ply."""
        from nefii_tpu_torch.utils.mesh_io import save_mesh
        from nefii_tpu_torch.utils.plots import get_surface_high_res_mesh

        verts, faces = get_surface_high_res_mesh(
            self.model.implicit_network.sdf, resolution=self.export_mesh_resolution,
            bound=self.model.ray_tracer.object_bounding_sphere, device=self.device)
        path = os.path.join(self.out_dir, "surface_high_res.ply")
        save_mesh(path, verts, faces)
        print(f"exported {len(verts)}-vertex mesh to {path}")

    def run(self):
        """Render the views on every rank; rank 0 writes them, the envmap
        and the mesh while the others wait."""
        from nefii_tpu_torch.parallel import dist

        n = len(self.dataset)
        if self.max_views > 0:
            n = min(n, self.max_views)
        for i in range(n):
            out = self.render_view(i)
            if not self.is_main:
                continue
            self.write_view(i, out)
            s = self.stats[-1]
            print(f"rendered view {i + 1}/{n}: {s['seconds']:.3f} s, "
                  f"{s['pixels'] / s['seconds']:.1f} px/s, {s['sdf_evals']} SDF evals, "
                  f"hit fraction {s['hit_fraction']:.3f}")
        if self.is_main:
            self.write_envmap()
            if self.export_mesh_resolution > 0:
                self.write_mesh()
            print("outputs in", self.out_dir)
        dist.barrier()


def main(argv=None):
    from nefii_tpu_torch.training.exp_runner import init_distributed

    parser = argparse.ArgumentParser()
    parser = add_argument(parser)
    opt = parser.parse_args(argv)
    init_distributed(opt)
    runner = RenderRunner(**vars(opt))
    runner.run()
    return runner


if __name__ == "__main__":
    main()
