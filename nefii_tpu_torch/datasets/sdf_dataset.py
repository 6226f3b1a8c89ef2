"""SDFDataset / SDFSampler — Step-1 geometry training data, mesh -> SDF
samples (counterpart of nefii_tpu/datasets/sdf_dataset.py).

The port's native runtime (nefii_tpu_torch/native) answers the BVH
signed-distance queries and samples the surface by area. ~94% of the points
are surface samples perturbed by two Gaussian scales (sigma 0.0025 and
0.00025 in unit-sphere coordinates), ~6% are uniform in the unit sphere;
points and SDF are rescaled to mesh coordinates by (center, scale).

Everything here is numpy on the host, in the JAX package's order of
operations (float64 perturbations, float32 casts, then the rescale), so a
seed gives the same points and SDF values as the JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from nefii_tpu_torch.native import MeshSDF
from nefii_tpu_torch.utils.mesh_io import load_mesh


def scale_to_unit_sphere(vertices: np.ndarray):
    """Center on the bounding-box centroid and scale max radius to 1."""
    lo, hi = vertices.min(0), vertices.max(0)
    center = (lo + hi) / 2.0
    v = vertices - center
    scale = np.linalg.norm(v, axis=1).max()
    return v / scale, center, scale


class SDFSampler:
    def __init__(
        self,
        mesh_path: str,
        number_of_points: int = 500_000,
        scale_to_unit: bool = True,
        seed: int = 0,
    ):
        self.number_of_points = number_of_points
        vertices, faces = load_mesh(mesh_path)
        if scale_to_unit:
            vertices, center, scale = scale_to_unit_sphere(vertices)
        else:
            center, scale = np.zeros(3), 1.0
        self.center = center
        self.scale = scale
        self.mesh = MeshSDF(vertices, faces)
        self._seed = seed

    def sample(self, seed: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """-> (points [n,3] float32, sdf [n,1] float32) for `seed` (the next
        seed of the sampler's own count when None)."""
        if seed is None:
            self._seed += 1
            seed = self._seed
        rng = np.random.default_rng(seed)
        n = self.number_of_points
        n_surface = int(n * 47 / 50)  # mesh_to_sdf's 94/6 split
        n_unit = n - n_surface
        half = n_surface // 2

        surf, _ = self.mesh.sample_surface(n_surface, seed=seed * 2654435761 % (2**63) + 1)
        pts = surf.astype(np.float64)
        pts[:half] += rng.normal(0.0, 0.0025, (half, 3))
        pts[half:n_surface] += rng.normal(0.0, 0.00025, (n_surface - half, 3))

        # uniform in the unit sphere
        u = rng.normal(size=(n_unit, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
        r = rng.random(n_unit) ** (1.0 / 3.0)
        pts = np.concatenate([pts, u * r[:, None]], axis=0)

        sdf = self.mesh.signed_distance(pts.astype(np.float32))

        pts = pts * self.scale + self.center
        sdf = sdf * self.scale
        return pts.astype(np.float32), sdf.reshape(-1, 1).astype(np.float32)


class SDFDataset:
    """A stream of (points, sdf) batches, one seed an index."""

    def __init__(self, mesh_path: str, sample_num: int, max_iter_num: int,
                 scale_to_unit: bool = True, seed: int = 0):
        self.sample_num = sample_num
        self.max_iter_num = max_iter_num
        self.sdf_sampler = SDFSampler(
            mesh_path, sample_num, scale_to_unit=scale_to_unit, seed=seed
        )

    def __len__(self) -> int:
        return self.max_iter_num

    def __getitem__(self, idx: int):
        return self.sdf_sampler.sample(seed=idx)

    @staticmethod
    def collate(batch_list):
        pts, sdf = zip(*batch_list)
        return np.concatenate(pts, 0), np.concatenate(sdf, 0)
