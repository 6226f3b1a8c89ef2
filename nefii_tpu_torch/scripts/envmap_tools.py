"""Offline envmap utilities: constant-map fitting and SG rotation
(counterpart of nefii_tpu/scripts/envmap_tools.py).

`constant` resizes an envmap to an M x M constant light .npy (area
resampling, utils/resize.py, equal to the JAX package's cv2.INTER_AREA);
`rotate` turns the SG lobes by Euler angles. Both are numpy on the host;
`--preview` renders the rotated lobes to `<out>_envmap.png` through
ops/sg.compute_envmap on --device.

    python -m nefii_tpu_torch.scripts.envmap_tools constant --envmap e.exr --size 64
    python -m nefii_tpu_torch.scripts.envmap_tools rotate --sg sg_128.npy \
        --euler yxz --degrees 90 0 0 [--preview --device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nefii_tpu_torch.utils.resize import resize


def fit_envmap_constant(envmap: np.ndarray, size: int) -> np.ndarray:
    return resize(envmap, (size, size), "area")


def rotate_lightsg(lgtSGs: np.ndarray, rotation: np.ndarray) -> np.ndarray:
    """Rotate SG lobe directions by a 3x3 rotation matrix."""
    lobes = lgtSGs[:, :3] / (np.linalg.norm(lgtSGs[:, :3], axis=-1, keepdims=True) + 1e-8)
    lambdas = np.abs(lgtSGs[:, 3:4])
    mus = np.abs(lgtSGs[:, 4:])
    lobes_rot = lobes @ rotation.T
    return np.concatenate([lobes_rot, lambdas, mus], axis=-1).astype(np.float32)


def euler_rotation(order: str, degrees) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    return R.from_euler(order, degrees, degrees=True).as_matrix()


def envmap_png(path: str, lgtSGs: np.ndarray, H: int, W: int, device,
               coordinate_type: str = "mitsuba") -> None:
    """compute_envmap of the SGs on `device`, gamma 2.2, written as an 8-bit PNG."""
    import torch

    from nefii_tpu_torch.ops.sg import compute_envmap
    from nefii_tpu_torch.utils.png import write_png

    with torch.no_grad():
        env = compute_envmap(torch.as_tensor(lgtSGs, dtype=torch.float32, device=device), H, W,
                             coordinate_type=coordinate_type).cpu().numpy()
    im = np.clip(np.power(np.clip(env, 0, None), 1 / 2.2), 0, 1)
    write_png(path, (im * 255).astype(np.uint8))


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("constant")
    pc.add_argument("--envmap", required=True)
    pc.add_argument("--size", type=int, default=64)
    pc.add_argument("--out", default=None)

    pr = sub.add_parser("rotate")
    pr.add_argument("--sg", required=True, help=".npy of [M,7] SGs")
    pr.add_argument("--euler", default="yxz")
    pr.add_argument("--degrees", type=float, nargs=3, default=[90, 0, 0])
    pr.add_argument("--out", default=None)
    pr.add_argument("--preview", action="store_true")
    pr.add_argument("--device", default="cuda",
                    help="torch device of the preview (cuda raises if CUDA is absent)")

    args = p.parse_args(argv)

    if args.cmd == "constant":
        from nefii_tpu_torch.utils import exr as exr_io

        env = exr_io.read(args.envmap)[:, :, :3]
        const = fit_envmap_constant(env, args.size)
        out = args.out or os.path.splitext(args.envmap)[0] + f"_const{args.size}.npy"
        np.save(out, const)
        print("saved", out, const.shape)
    else:
        if args.preview:
            import torch

            if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
        lgt = np.load(args.sg)
        rot = euler_rotation(args.euler, args.degrees)
        lgt_rot = rotate_lightsg(lgt, rot)
        out = args.out or args.sg[:-4] + "_rot.npy"
        np.save(out, lgt_rot)
        print("saved", out)
        if args.preview:
            envmap_png(out[:-4] + "_envmap.png", lgt_rot, 256, 512, args.device)


if __name__ == "__main__":
    main()
