"""Dataset converters: NeuS/netease `cameras_sphere.npz` -> NeFII scene dirs
(counterpart of nefii_tpu/scripts/converters.py, numpy only).

neus2physg normalises K/W2C to the unit sphere through scale_mat, writes
`cam_dict_norm.json` and copies the image/mask dirs, for the train and the
test split; neus2neus restructures the scene and keeps the npz.

    python -m nefii_tpu_torch.scripts.converters neus2physg <undist_dir> <out_dir> [neus|netease]
    python -m nefii_tpu_torch.scripts.converters neus2neus  <undist_dir> <out_dir>
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

TYPE_NETEASE = "netease"
TYPE_NEUS = "neus"


def cameras_sphere_to_cam_dict(npz_path: str, src_type: str = TYPE_NETEASE) -> dict:
    npz = np.load(npz_path)
    item_len = 7 if src_type == TYPE_NETEASE else 6
    length = len(npz.files) // item_len

    scale_mat = npz["scale_mat_0"]
    center = scale_mat[:3, 3:]
    radius = scale_mat[0, 0]

    unify_mat_inv = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    unify_mat_inv[:3, 3:] = center

    result = {}
    for i in range(length):
        K4 = npz["camera_mat_%d" % i]
        fx, fy = float(K4[0, 0]), float(K4[1, 1])
        cx, cy = float(K4[0, 2]), float(K4[1, 2])
        W, H = int(cx * 2 + 1), int(cy * 2 + 1)

        if "camera_mat_inv_%d" % i in npz.files:
            K_inv = npz["camera_mat_inv_%d" % i]
        else:
            K_inv = np.linalg.inv(K4)
        world_mat = npz["world_mat_%d" % i]
        w2c = K_inv @ world_mat
        w2c_unified = w2c @ unify_mat_inv

        K = [fx, 0.0, cx, 0.0,
             0.0, fy, cy, 0.0,
             0.0, 0.0, 1.0, 0.0,
             0.0, 0.0, 0.0, 1.0]
        result["%06d" % i] = {
            "K": K,
            "W2C": [float(x) for x in w2c_unified.reshape(-1)],
            "img_size": (W, H),
        }
    return result


def _copy_imgs(src_dir: str, dst_dir: str) -> None:
    for f in sorted(os.listdir(src_dir)):
        shutil.copyfile(os.path.join(src_dir, f), os.path.join(dst_dir, f))


def neus2physg(undist_path: str, output_path: str, src_type: str = TYPE_NETEASE) -> None:
    npz_path = os.path.join(undist_path, "cameras_sphere.npz")
    cam_dict = cameras_sphere_to_cam_dict(npz_path, src_type)
    for tag in ("train", "test"):
        sub = os.path.join(output_path, tag)
        os.makedirs(os.path.join(sub, "image"), exist_ok=True)
        os.makedirs(os.path.join(sub, "mask"), exist_ok=True)
        with open(os.path.join(sub, "cam_dict_norm.json"), "w") as f:
            json.dump(cam_dict, f, indent=2)
        _copy_imgs(os.path.join(undist_path, "image"), os.path.join(sub, "image"))
        _copy_imgs(os.path.join(undist_path, "mask"), os.path.join(sub, "mask"))


def neus2neus(undist_path: str, output_path: str) -> None:
    os.makedirs(os.path.join(output_path, "image"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "mask"), exist_ok=True)
    _copy_imgs(os.path.join(undist_path, "image"), os.path.join(output_path, "image"))
    _copy_imgs(os.path.join(undist_path, "mask"), os.path.join(output_path, "mask"))
    shutil.copyfile(
        os.path.join(undist_path, "cameras_sphere.npz"),
        os.path.join(output_path, "cameras_sphere.npz"),
    )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print(__doc__)
        raise SystemExit(2)
    cmd, src, dst = argv[0], argv[1], argv[2]
    if cmd == "neus2physg":
        neus2physg(src, dst, argv[3] if len(argv) > 3 else TYPE_NETEASE)
    elif cmd == "neus2neus":
        neus2neus(src, dst)
    else:
        raise SystemExit(f"unknown subcommand {cmd!r}")


if __name__ == "__main__":
    main()
