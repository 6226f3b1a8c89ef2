"""Single-image masked PSNR (counterpart of nefii_tpu/scripts/compute_psnr.py),
numpy on the host.

    python -m nefii_tpu_torch.scripts.compute_psnr <pred> <gt> [mask] [--tonemap]
"""

from __future__ import annotations

import argparse

import numpy as np

from nefii_tpu_torch.datasets.scene_dataset import load_mask, load_rgb
from nefii_tpu_torch.utils.metrics import psnr


def compute_psnr(pred_path: str, gt_path: str, mask_path: str = None,
                 tonemap: bool = False) -> float:
    pred = load_rgb(pred_path)
    gt = load_rgb(gt_path)
    if tonemap:
        pred = np.clip(np.power(np.clip(pred, 0, None), 1 / 2.2), 0, 1)
        gt = np.clip(np.power(np.clip(gt, 0, None), 1 / 2.2), 0, 1)
    mask = load_mask(mask_path) if mask_path else None
    return psnr(pred, gt, mask)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pred")
    p.add_argument("gt")
    p.add_argument("mask", nargs="?", default=None)
    p.add_argument("--tonemap", action="store_true")
    args = p.parse_args(argv)
    print(f"psnr: {compute_psnr(args.pred, args.gt, args.mask, args.tonemap):.4f}")


if __name__ == "__main__":
    main()
