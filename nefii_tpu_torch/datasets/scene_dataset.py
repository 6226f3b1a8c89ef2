"""SceneDataset — posed views + masks + cameras, host-side numpy (counterpart
of nefii_tpu/datasets/scene_dataset.py, which pulls in JAX through its
`rot_to_quat` import). With `train_cameras` an item has no pose: the trainer
takes the batch's pose rows from its learned camera parameters.

Reads `cam_dict_norm.json` (K, W2C per view), and `image/*` and `mask/*`
when they exist. Without images it builds a test split from the cameras
alone: resolution W = 2/K[0,0], H = 2/K[1,1], unit ground truth, full masks.
EXR images go through the port's utils/exr.py and PNG images through its
utils/png.py; only JPG inputs need imageio, imported when such a file is read.
Pixel and patch sampling take an explicit numpy Generator, as in the JAX
package, so both packages draw the same pixels from the same seed.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from nefii_tpu_torch.utils import exr as exr_io
from nefii_tpu_torch.utils.camera import rot_to_quat
from nefii_tpu_torch.utils.png import read_png

IMG_EXTENSIONS = ["png", "jpg", "jpeg", "JPG", "JPEG", "exr", "PNG", "EXR"]


def glob_imgs(path: str) -> List[str]:
    imgs: List[str] = []
    for ext in IMG_EXTENSIONS:
        imgs.extend(glob(os.path.join(path, f"*.{ext}")))
    return sorted(set(imgs))


def _imread(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        return read_png(path).astype(np.float32)
    import imageio.v2 as imageio  # only for JPG inputs

    return np.asarray(imageio.imread(path), np.float32)


def load_rgb(path: str) -> np.ndarray:
    """Load an image as float32 [H,W,3]; LDR images scaled to [0,1]."""
    if path.lower().endswith(".exr"):
        return np.asarray(exr_io.read(path)[:, :, :3], np.float32)
    return _imread(path)[:, :, :3] / 255.0


def load_mask(path: str) -> np.ndarray:
    alpha = _imread(path)
    if alpha.ndim == 3:
        alpha = alpha.mean(-1)
    return (alpha / 255.0) > 0.5


def read_cam_dict(cam_dict_file: str) -> Dict:
    with open(cam_dict_file) as fp:
        cam_dict = json.load(fp)
    for x in sorted(cam_dict.keys()):
        cam_dict[x]["K"] = np.array(cam_dict[x]["K"]).reshape(4, 4)
        cam_dict[x]["W2C"] = np.array(cam_dict[x]["W2C"]).reshape(4, 4)
        cam_dict[x]["C2W"] = np.linalg.inv(cam_dict[x]["W2C"])
    return cam_dict


class SceneDataset:
    def __init__(self, gamma: float, instance_dir: str, train_cameras: bool,
                 subsample: float = 1, wo_mask: bool = False):
        assert os.path.exists(instance_dir), f"Data directory is empty: {instance_dir}"
        if subsample not in (None, 1):
            raise NotImplementedError("subsample is not ported")
        self.instance_dir = instance_dir
        self.gamma = gamma
        self.train_cameras = train_cameras
        self.sampling_idx: Optional[np.ndarray] = None
        self.sampling_rays: Optional[np.ndarray] = None

        image_paths = glob_imgs(os.path.join(instance_dir, "image"))
        mask_paths = glob_imgs(os.path.join(instance_dir, "mask"))
        cam_dict = read_cam_dict(os.path.join(instance_dir, "cam_dict_norm.json"))
        self.n_cameras = len(cam_dict) if not image_paths else len(image_paths)
        self.image_paths = image_paths

        self.intrinsics_all = [cam_dict[x]["K"].astype(np.float32) for x in sorted(cam_dict)]
        self.pose_all = [cam_dict[x]["C2W"].astype(np.float32) for x in sorted(cam_dict)]

        if image_paths:
            self.has_groundtruth = True
            self.rgb_images = []
            for path in image_paths:
                rgb = load_rgb(path) ** self.gamma  # inverse gamma
                H, W = rgb.shape[:2]
                self.img_res = [H, W]
                self.total_pixels = H * W
                self.rgb_images.append(rgb.reshape(-1, 3))
        else:
            self.has_groundtruth = False
            K = self.intrinsics_all[0]
            W = int(2.0 / K[0, 0])
            H = int(2.0 / K[1, 1])
            self.img_res = [H, W]
            self.total_pixels = H * W
            self.rgb_images = [np.ones((self.total_pixels, 3), np.float32)] * self.n_cameras

        if mask_paths and not wo_mask:
            assert len(mask_paths) == self.n_cameras
            self.object_masks = [load_mask(p).reshape(-1) for p in mask_paths]
        else:
            self.object_masks = [np.ones((self.total_pixels,), bool)] * self.n_cameras

    def __len__(self) -> int:
        return self.n_cameras

    def _full_uv(self) -> np.ndarray:
        H, W = self.img_res
        v, u = np.mgrid[0:H, 0:W].astype(np.float32)
        return np.stack([u, v], -1).reshape(-1, 2)  # x (col) first

    def __getitem__(self, idx: int):
        uv = self._full_uv()
        sample = {"object_mask": self.object_masks[idx], "uv": uv,
                  "intrinsics": self.intrinsics_all[idx]}
        ground_truth = {"rgb": self.rgb_images[idx]}
        if self.sampling_idx is not None:
            ground_truth["rgb"] = self.rgb_images[idx][self.sampling_idx, :]
            sample["object_mask"] = self.object_masks[idx][self.sampling_idx]
            sample["uv"] = uv[self.sampling_idx, :]
        sample["uv"] = self.ray_sample(sample["uv"])
        if not self.train_cameras:
            sample["pose"] = self.pose_all[idx]
        return idx, sample, ground_truth

    def ray_sample(self, s_uv: np.ndarray) -> np.ndarray:
        """Add the multi-ray jitter offsets: [S,2] -> [S,R,2]."""
        if self.sampling_rays is None:
            return s_uv
        return s_uv[:, None, :] + self.sampling_rays[None, :, :]

    @staticmethod
    def collate(batch_list):
        idxs, samples, gts = zip(*batch_list)
        out_s = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        out_g = {k: np.stack([g[k] for g in gts]) for k in gts[0]}
        return np.asarray(idxs, np.int64), out_s, out_g

    def batch_ray_sample(self, s_uv_batch: np.ndarray) -> np.ndarray:
        B, S, _ = s_uv_batch.shape
        return self.ray_sample(s_uv_batch.reshape(B * S, 2)).reshape(B, S, -1, 2)

    def change_sampling_rays(self, sampling_size: int, rng: Optional[np.random.Generator] = None):
        if sampling_size == -1:
            self.sampling_rays = None
        else:
            rng = rng or np.random.default_rng()
            self.sampling_rays = rng.random((sampling_size, 2)).astype(np.float32) - 0.5

    def change_sampling_idx(self, sampling_size: int, rng: Optional[np.random.Generator] = None):
        if sampling_size == -1:
            self.sampling_idx = None
        else:
            rng = rng or np.random.default_rng()
            self.sampling_idx = rng.permutation(self.total_pixels)[:sampling_size]

    def change_sampling_idx_patch(self, N_patch: int, r_patch: int = 1,
                                  rng: Optional[np.random.Generator] = None):
        """N_patch square patches of (2 r_patch)^2 pixels, each patch's pixels
        consecutive in sampling_idx (the loss reshapes them back to patches)."""
        if N_patch == -1:
            self.sampling_idx = None
            return
        rng = rng or np.random.default_rng()
        H, W = self.img_res
        u, v = np.meshgrid(np.arange(-r_patch, r_patch), np.arange(-r_patch, r_patch))
        offsets = v.reshape(-1) * W + u.reshape(-1)
        u, v = np.meshgrid(np.arange(r_patch, W - r_patch), np.arange(r_patch, H - r_patch))
        u, v = u.reshape(-1), v.reshape(-1)
        sel = rng.choice(u.shape[0], size=(N_patch,), replace=False)
        centers = v[sel] * W + u[sel]
        self.sampling_idx = np.stack([centers + s for s in offsets], axis=1).reshape(-1)

    @staticmethod
    def write_camera_only_split(d: str, n_views: int, res: int, focal: float,
                                distance: float = 2.0) -> str:
        """Write a `cam_dict_norm.json`-only test split of `n_views` res x res
        cameras on a ring around the origin, looking at it, with `focal`
        pixels of focal length. The no-image split reads its resolution from
        K (W = 2/K[0,0]), so the focal length is carried by the scale of the
        pose's first two axes instead. Returns `d`."""
        os.makedirs(d, exist_ok=True)
        k = 2.0 / (res + 0.5)  # int(2/k) == res, robust to float rounding
        cams = {}
        for i in range(n_views):
            ang = 1.2 * i
            eye = distance * np.array([np.sin(ang), 0.0, -np.cos(ang)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross([0.0, 1.0, 0.0], fwd)
            right /= np.linalg.norm(right)
            up = np.cross(fwd, right)
            C2W = np.eye(4)
            C2W[:3, 0], C2W[:3, 1] = right * (k / focal), up * (k / focal)
            C2W[:3, 2], C2W[:3, 3] = fwd, eye
            K = np.eye(4)
            K[0, 0] = K[1, 1] = k
            K[0, 2] = K[1, 2] = res / 2.0
            cams[f"{i:03d}"] = {"K": K.reshape(-1).tolist(),
                                "W2C": np.linalg.inv(C2W).reshape(-1).tolist()}
        with open(os.path.join(d, "cam_dict_norm.json"), "w") as f:
            json.dump(cams, f)
        return d

    def get_pose_init(self) -> np.ndarray:
        """Quaternion + translation [n_views, 7] init for pose optimisation."""
        poses = np.stack(self.pose_all)
        return np.concatenate([rot_to_quat(poses[:, :3, :3]).numpy(), poses[:, :3, 3]],
                              axis=1).astype(np.float32)
