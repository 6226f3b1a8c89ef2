"""A synthetic training scene: a lambertian sphere seen from a ring of
cameras, written in the SceneDataset layout (image/*.exr, mask/*.png,
cam_dict_norm.json) with the port's own EXR and PNG writers. The same scene
as the JAX package's tests/scene_factory.py, computed per image instead of
per pixel.

    write_sphere_scene(d, n_views=4, res=128)
"""

from __future__ import annotations

import json
import os

import numpy as np

from nefii_tpu_torch.utils import exr
from nefii_tpu_torch.utils.png import write_png


def write_sphere_scene(d: str, n_views: int = 3, res: int = 16, radius: float = 0.5,
                       distance: float = 2.0) -> str:
    """Write `n_views` res x res views of a sphere of `radius` at the origin,
    albedo (0.8, 0.5, 0.3), lit by one directional light plus 0.2 ambient,
    from cameras at `distance` on a ring, focal length 1.25 res. Returns d."""
    os.makedirs(os.path.join(d, "image"), exist_ok=True)
    os.makedirs(os.path.join(d, "mask"), exist_ok=True)
    f = res * 1.25
    light = np.array([0.5, 0.5, -0.7]) / np.linalg.norm([0.5, 0.5, -0.7])
    v, u = np.mgrid[0:res, 0:res].astype(np.float64)
    dir_cam = np.stack([(u - res / 2) / f, (v - res / 2) / f, np.ones_like(u)], -1)
    cams = {}
    for i in range(n_views):
        ang = 1.2 * i
        eye = distance * np.array([np.sin(ang), 0.0, -np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        C2W = np.eye(4)
        C2W[:3, 0], C2W[:3, 1], C2W[:3, 2], C2W[:3, 3] = right, up, fwd, eye
        K = np.eye(4)
        K[0, 0] = K[1, 1] = f
        K[0, 2] = K[1, 2] = res / 2

        dirs = dir_cam @ C2W[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        b = dirs @ eye
        disc = b * b - (eye @ eye - radius ** 2)
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        n = eye + t[..., None] * dirs
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        shade = np.clip(n @ light, 0.0, None)
        img = np.where(hit[..., None], np.array([0.8, 0.5, 0.3]) * (0.2 + 0.8 * shade[..., None]),
                       0.0).astype(np.float32)
        exr.write(os.path.join(d, "image", f"{i:03d}.exr"), img)
        write_png(os.path.join(d, "mask", f"{i:03d}.png"), (hit * 255).astype(np.uint8))
        cams[f"{i:03d}.exr"] = {"K": K.reshape(-1).tolist(),
                                "W2C": np.linalg.inv(C2W).reshape(-1).tolist()}
    with open(os.path.join(d, "cam_dict_norm.json"), "w") as fjson:
        json.dump(cams, fjson)
    return d
