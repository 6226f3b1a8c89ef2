"""Visualisation and surface export helpers (counterpart of
nefii_tpu/utils/plots.py): image grids, depth maps, and the zero-surface of
an SDF through the port's native marching tetrahedra (`get_surface_trace`,
`get_surface_high_res_mesh`), written as OBJ/PLY by utils/mesh_io.

An SDF closure takes a float32 tensor [P,3] on `device` and returns [P]; it
is evaluated in chunks of 262,144 points under torch.no_grad(). Everything
else is numpy, scipy and the native runtime on the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

CHUNK = 262_144


def image_grid(images, cols: int = 4) -> np.ndarray:
    """Stack [N,H,W,3] float images into a grid image."""
    images = [np.clip(np.asarray(im), 0, 1) for im in images]
    H, W = images[0].shape[:2]
    rows = -(-len(images) // cols)
    grid = np.ones((rows * H, cols * W, 3), np.float32)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = im
    return grid


def depth_map(points: np.ndarray, pose: np.ndarray, mask: np.ndarray,
              img_res: Tuple[int, int]) -> np.ndarray:
    """Normalised depth of surface points [H*W,3] seen from c2w pose [4,4]
    where mask, white elsewhere -> [H,W,3] float32."""
    from nefii_tpu_torch.utils.camera import get_depth

    H, W = img_res
    depth = get_depth(torch.as_tensor(np.asarray(points, np.float32)[None]),
                      torch.as_tensor(np.asarray(pose, np.float32)[None]))[0, :, 0].numpy()
    depth = np.where(mask, depth, np.nan)
    if np.isfinite(depth).any():
        lo, hi = np.nanmin(depth), np.nanmax(depth)
        depth = (depth - lo) / max(hi - lo, 1e-8)
    img = np.where(np.isnan(depth), 1.0, depth)
    return np.tile(img.reshape(H, W, 1), (1, 1, 3)).astype(np.float32)


@torch.no_grad()
def eval_sdf(sdf_fn: Callable, pts: np.ndarray, device, chunk: int = CHUNK) -> np.ndarray:
    """sdf_fn over host points [P,3] in chunks on `device` -> float32 [P]."""
    out = np.empty(len(pts), np.float32)
    for i in range(0, len(pts), chunk):
        x = torch.as_tensor(pts[i : i + chunk], dtype=torch.float32, device=device)
        out[i : i + chunk] = sdf_fn(x).reshape(-1).float().cpu().numpy()
    return out


def sdf_grid(sdf_fn: Callable, resolution: int = 100, bound: float = 1.0, *,
             device, chunk: int = CHUNK) -> np.ndarray:
    """Evaluate an SDF closure on a dense [R,R,R] grid over [-bound, bound]^3."""
    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    return eval_sdf(sdf_fn, pts, device, chunk).reshape(resolution, resolution, resolution)


def _weld_triangles(tris: np.ndarray, cell: float) -> Tuple[np.ndarray, np.ndarray]:
    """Weld a triangle soup [T,3,3] into (vertices [V,3], faces [F,3]),
    merging vertices closer than ~1e-4 of a grid cell and dropping
    degenerate faces."""
    flat = tris.reshape(-1, 3)
    keys = np.round(flat / (cell * 1e-4)).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    verts = np.zeros((len(uniq), 3), np.float64)
    np.add.at(verts, inverse, flat)
    counts = np.bincount(inverse, minlength=len(uniq))
    verts /= counts[:, None]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[ok]


def _empty() -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)


def get_surface_trace(
    sdf_fn: Callable,
    resolution: int = 100,
    bound: float = 1.0,
    level: float = 0.0,
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the SDF's `level` surface over [-bound, bound]^3 ->
    (vertices [V,3], faces [F,3]): marching tetrahedra on a resolution^3
    grid, then vertex welding."""
    from nefii_tpu_torch.native import marching_tetrahedra

    grid = sdf_grid(sdf_fn, resolution, bound, device=device)
    tris = marching_tetrahedra(grid, level)  # [T,3,3] in grid coords
    if len(tris) == 0:
        return _empty()
    scale = 2.0 * bound / (resolution - 1)
    world = tris * scale - bound  # [T,3,3]
    return _weld_triangles(world, scale)


def export_surface(sdf_fn: Callable, path: str, resolution: int = 100,
                   bound: float = 1.0, *, device) -> None:
    from nefii_tpu_torch.utils.mesh_io import save_mesh

    verts, faces = get_surface_trace(sdf_fn, resolution, bound, device=device)
    save_mesh(path, verts, faces)


def _largest_component(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the connected component (over the face-shared vertex graph) with
    the largest surface area."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    adj = coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)),
        shape=(len(verts), len(verts)),
    )
    _, labels = connected_components(adj, directed=False)
    roots = labels[faces[:, 0]]

    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    best = np.argmax(np.bincount(roots, weights=area))
    keep_faces = faces[roots == best]

    used = np.unique(keep_faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[keep_faces].astype(np.int32)


def get_surface_high_res_mesh(
    sdf_fn: Callable,
    resolution: int = 100,
    bound: float = 1.0,
    coarse_resolution: int = 100,
    n_surface_samples: int = 10_000,
    eps: float = 0.2,
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-stage coarse-to-fine surface export: a coarse
    `coarse_resolution`^3 pass locates the surface, its largest-area
    connected component is sampled into a point cloud (the native area
    sampler, seed 0), the cloud is PCA-aligned, and a grid over the aligned
    bounding box (+/- `eps`) with `resolution` samples on its shortest axis
    is marched again for the final mesh in world coordinates. Returns
    (vertices [V,3], faces [F,3]); empty arrays when the SDF has no zero
    crossing."""
    from nefii_tpu_torch.native import MeshSDF, marching_tetrahedra

    verts, faces = get_surface_trace(sdf_fn, coarse_resolution, bound, device=device)
    if len(faces) == 0:
        return verts, faces
    verts, faces = _largest_component(verts, faces)

    pc = MeshSDF(verts, faces).sample_surface(n_surface_samples, seed=0)[0]
    pc = pc.astype(np.float64)

    # PCA alignment: rows of `vecs` are the principal axes, flipped to a
    # proper rotation when the eigenbasis reflects
    mean = pc.mean(0)
    cov = (pc - mean).T @ (pc - mean)
    _, eigvecs = np.linalg.eigh(cov)
    vecs = eigvecs.T
    if np.linalg.det(vecs) < 0:
        vecs = vecs[[0, 2, 1]]
    aligned = (pc - mean) @ vecs.T

    # aligned-space grid: the shortest bbox axis gets `resolution` samples,
    # the others extend at the same spacing
    lo = aligned.min(0) - eps
    hi = aligned.max(0) + eps
    shortest = int(np.argmin(hi - lo))
    axis_s = np.linspace(lo[shortest], hi[shortest], resolution)
    spacing = (axis_s[-1] - axis_s[0]) / (resolution - 1)
    axes = []
    for a in range(3):
        if a == shortest:
            axes.append(axis_s)
        else:
            axes.append(np.arange(lo[a], hi[a] + spacing, spacing))

    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    grid_aligned = np.stack([X, Y, Z], -1).reshape(-1, 3)
    grid_world = grid_aligned @ vecs + mean  # vecs.T @ p per point

    z = eval_sdf(sdf_fn, grid_world, device)
    if z.min() > 0 or z.max() < 0:
        return _empty()

    grid = z.reshape(len(axes[0]), len(axes[1]), len(axes[2]))
    tris = marching_tetrahedra(grid, 0.0)  # grid-index coords
    if len(tris) == 0:
        return _empty()
    tris_aligned = tris * spacing + lo  # uniform spacing on every axis
    tris_world = tris_aligned @ vecs + mean
    return _weld_triangles(tris_world, spacing)


def export_surface_high_res(sdf_fn: Callable, path: str, resolution: int = 300,
                            bound: float = 1.0, *, device) -> None:
    from nefii_tpu_torch.utils.mesh_io import save_mesh

    verts, faces = get_surface_high_res_mesh(sdf_fn, resolution, bound, device=device)
    save_mesh(path, verts, faces)
