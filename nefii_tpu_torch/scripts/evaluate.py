"""Decomposition evaluation against ground-truth folders (counterpart of
nefii_tpu/scripts/evaluate.py).

Per view: PSNR / SSIM / MS-SSIM (and LPIPS-alex on the rgb rows, from the
weights of $NEFII_LPIPS_WEIGHTS; "unavailable" with its reason without them)
over rgb / diffuse / diffuse_align / sp_rgb, with the 1/2.2 tonemap, the
white mask fill and the per-channel median albedo alignment; the raw masked
MSE of diffuse and roughness. The means go to `results.txt` in the
prediction folder. LPIPS runs on --device; the rest is numpy on the host.

    python -m nefii_tpu_torch.scripts.evaluate <prediction_dir> <gt_dir> [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np

from nefii_tpu_torch.datasets.scene_dataset import load_mask, load_rgb
from nefii_tpu_torch.utils import metrics


def align_(rgb_gt, rgb_pre, mask, eps=1e-4):
    """Per-channel median scale alignment of rgb_pre to rgb_gt, in place."""
    m = mask[..., 0].astype(bool)
    for c in range(rgb_gt.shape[2]):
        gt_v = rgb_gt[..., c][m]
        pre_v = np.clip(rgb_pre[..., c][m], eps, None)
        scale = np.median(gt_v / pre_v)
        rgb_pre[..., c] *= scale


class LpipsMetric:
    """LPIPS-alex on `device` with the user's weights, loaded at the first
    call. A failure gives nan and keeps its reason for results.txt."""

    def __init__(self, device, weights_path: Optional[str] = None):
        self.device = device
        self.weights_path = weights_path
        self.net = None
        self.error = ""

    def __call__(self, pred: np.ndarray, gt: np.ndarray) -> float:
        from nefii_tpu_torch.utils import lpips as lpips_torch

        try:
            if self.net is None:
                self.net = lpips_torch.load_model(self.weights_path, device=self.device)
        except FileNotFoundError:
            self.error = ("LPIPS needs pretrained AlexNet weights: set $NEFII_LPIPS_WEIGHTS "
                          "(see utils/lpips.py)")
            return float("nan")
        except RuntimeError as e:
            self.error = str(e)
            return float("nan")
        try:
            return lpips_torch.lpips_distance(self.net, pred, gt)
        except Exception as e:  # reported in results.txt as the reason
            self.error = f"LPIPS computation failed: {e}"
            return float("nan")


def evaluate_rgb(pre_path, gt_path, mask_path, align=False, tonemap=True,
                 lpips_fn: Optional[Callable] = None) -> Dict[str, float]:
    rgb_pre = load_rgb(pre_path)
    rgb_gt = load_rgb(gt_path)
    mask = load_mask(mask_path)[:, :, None].astype(np.float32)

    if tonemap:
        rgb_pre = np.clip(np.power(np.clip(rgb_pre, 0, None), 1 / 2.2), 0, 1)
        rgb_gt = np.clip(np.power(np.clip(rgb_gt, 0, None), 1 / 2.2), 0, 1)

    if align:
        align_(rgb_gt, rgb_pre, mask)

    m3 = mask.astype(bool) & np.ones((1, 1, 3), bool)
    pre_masked = np.where(m3, rgb_pre * mask, 1.0)
    gt_masked = np.where(m3, rgb_gt * mask, 1.0)

    out = {
        "psnr": metrics.psnr(pre_masked, gt_masked, mask[..., 0]),
        "ssim": metrics.ssim(pre_masked, gt_masked),
        "ms_ssim": metrics.ms_ssim(pre_masked, gt_masked),
    }
    if lpips_fn is not None:
        out["lpips"] = lpips_fn(pre_masked, gt_masked)
    return out


def evaluate_raw(pre_path, gt_path, mask_path) -> Dict[str, float]:
    pre = load_rgb(pre_path)
    gt = load_rgb(gt_path)
    mask = load_mask(mask_path)[:, :, None].astype(np.float32)
    diff2 = ((pre * mask - gt * mask) ** 2)
    denom = max(mask.sum() * pre.shape[2], 1.0)
    return {"mse": float(diff2.sum() / denom)}


def _put(result, all_result, key):
    d = all_result.setdefault(key, {})
    for k, v in result.items():
        d.setdefault(k, []).append(v)


def _find(pred_dir, candidates):
    for c in candidates:
        p = os.path.join(pred_dir, c)
        if os.path.exists(p):
            return p
    return None


def main(prediction_dir: str, gt_path: str, out_path: Optional[str] = None, *,
         device="cuda"):
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
    # full-fp32 convolutions (no TF32) for LPIPS
    torch.backends.cudnn.allow_tf32 = False
    lpips_fn = LpipsMetric(device)

    gt_rgb = os.path.join(gt_path, "image")
    gt_diffuse = os.path.join(gt_path, "diffuse")
    gt_roughness = os.path.join(gt_path, "roughness")
    gt_sprgb = os.path.join(gt_path, "sp_rgb")
    mask_dir = os.path.join(gt_path, "mask")

    files = sorted(os.listdir(gt_rgb))
    all_result: Dict[str, Dict[str, list]] = {}

    for fname in files:
        index = int(fname.split(".")[0].split("_")[0])
        mask_f = _find(mask_dir, [f"{index:06d}.png", f"{index:03d}.png",
                                  fname.rsplit(".", 1)[0] + ".png"])
        if mask_f is None:
            continue

        pre = _find(prediction_dir, [f"rerender_rgb-{index:03d}.exr",
                                     f"rerender_rgb_{index:03d}.exr"])
        if pre:
            _put(evaluate_rgb(pre, os.path.join(gt_rgb, fname), mask_f, lpips_fn=lpips_fn),
                 all_result, "rgb")

        pre = _find(prediction_dir, [f"diffuse_albedo-{index:03d}.exr",
                                     f"diffuse_albedo_{index:03d}.exr"])
        gt_d = _find(gt_diffuse, [f"{index:06d}_diffuse.00.exr", f"{index:03d}.exr", fname])
        if pre and gt_d:
            r = evaluate_rgb(pre, gt_d, mask_f, tonemap=False)
            r.update(evaluate_raw(pre, gt_d, mask_f))
            _put(r, all_result, "diffuse")
            _put(evaluate_rgb(pre, gt_d, mask_f, align=True, tonemap=False),
                 all_result, "diffuse_align")

        pre = _find(prediction_dir, [f"roughness-{index:03d}.exr", f"roughness_{index:03d}.exr"])
        gt_r = _find(gt_roughness, [f"{index:06d}_roughness.00.exr", f"{index:03d}.exr"])
        if pre and gt_r:
            _put(evaluate_raw(pre, gt_r, mask_f), all_result, "roughness")

        pre = _find(prediction_dir, [f"specular_rgb-{index:03d}.exr",
                                     f"specular_rgb_{index:03d}.exr"])
        gt_s = _find(gt_sprgb, [f"{index:06d}_sp_rgb.00.exr", f"{index:03d}.exr"])
        if pre and gt_s:
            _put(evaluate_rgb(pre, gt_s, mask_f), all_result, "sp_rgb")

    lines = []
    for item, md in all_result.items():
        for metric, vals in md.items():
            mean = np.mean(vals)
            if metric == "lpips" and not np.isfinite(mean):
                lines.append(f"{item}.{metric}: unavailable ({lpips_fn.error})")
            else:
                lines.append(f"{item}.{metric}: {mean:.6f}")
    report = "\n".join(lines)
    print(report)

    out_path = out_path or os.path.join(prediction_dir, "results.txt")
    with open(out_path, "w") as f:
        f.write(report + "\n")
    return all_result


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("prediction_dir")
    parser.add_argument("gt_dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of LPIPS (cuda raises if CUDA is absent)")
    opt = parser.parse_args(argv)
    return main(opt.prediction_dir, opt.gt_dir, device=opt.device)


if __name__ == "__main__":
    cli()
