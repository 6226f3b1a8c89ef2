"""Image quality metrics (counterpart of nefii_tpu/utils/metrics.py): PSNR,
SSIM and MS-SSIM in numpy/scipy (float64), and LPIPS-alex, which needs
AlexNet weights the user supplies (utils/lpips.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None,
         max_val: float = 1.0) -> float:
    """Masked PSNR (reference evaluate.py:36-44)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if mask is not None:
        m = mask.astype(bool)
        if m.ndim == pred.ndim - 1:
            m = m[..., None] & np.ones(pred.shape[-1:], bool)
        diff2 = ((pred - gt) ** 2)[m]
    else:
        diff2 = (pred - gt) ** 2
    mse = diff2.mean() if diff2.size else 0.0
    return float(10.0 * np.log10(max_val**2 / max(mse, 1e-12)))


def _gauss_win(size=11, sigma=1.5):
    c = np.arange(size) - size // 2
    g = np.exp(-(c**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2(img, win):
    """Separable valid-mode filter over the last two axes of [..., H, W]."""
    from scipy.ndimage import convolve1d

    out = convolve1d(img, win, axis=-2, mode="constant")
    out = convolve1d(out, win, axis=-1, mode="constant")
    k = len(win) // 2
    return out[..., k:-k, k:-k]


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5, K=(0.01, 0.03),
         return_cs: bool = False):
    """SSIM over [H,W,C] (or [C,H,W]-agnostic via channel mean)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 3 and pred.shape[-1] in (1, 3):
        pred = np.moveaxis(pred, -1, 0)
        gt = np.moveaxis(gt, -1, 0)
    # shrink the window for small images (e.g. coarse MS-SSIM levels)
    eff = min(win_size, pred.shape[-1], pred.shape[-2])
    if eff % 2 == 0:
        eff -= 1
    win = _gauss_win(eff, win_sigma)
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2

    mu1, mu2 = _filter2(pred, win), _filter2(gt, win)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = _filter2(pred * pred, win) - mu1_sq
    s2 = _filter2(gt * gt, win) - mu2_sq
    s12 = _filter2(pred * gt, win) - mu12

    cs_map = (2 * s12 + C2) / (s1 + s2 + C2)
    ssim_map = ((2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)) * cs_map
    if return_cs:
        return float(ssim_map.mean()), float(cs_map.mean())
    return float(ssim_map.mean())


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Multi-scale SSIM (Wang et al. 2003), matching pytorch_msssim defaults."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 3 and pred.shape[-1] in (1, 3):
        pred = np.moveaxis(pred, -1, 0)
        gt = np.moveaxis(gt, -1, 0)

    levels = len(_MSSSIM_WEIGHTS)
    vals = []
    p, g = pred, gt
    for i in range(levels):
        s, cs = ssim(
            np.moveaxis(p, 0, -1), np.moveaxis(g, 0, -1),
            data_range=data_range, return_cs=True,
        )
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            # 2x average-pool downsample
            H, W = p.shape[-2] // 2 * 2, p.shape[-1] // 2 * 2
            p = p[..., :H, :W].reshape(*p.shape[:-2], H // 2, 2, W // 2, 2).mean((-3, -1))
            g = g[..., :H, :W].reshape(*g.shape[:-2], H // 2, 2, W // 2, 2).mean((-3, -1))
    vals = np.clip(np.asarray(vals), 1e-6, None)
    return float(np.prod(vals ** np.asarray(_MSSSIM_WEIGHTS)))


def lpips(pred: np.ndarray, gt: np.ndarray, weights_path: Optional[str] = None, *,
          device) -> float:
    """LPIPS-alex between HWC images in [0, 1], on `device`, with the
    weights at `weights_path` or $NEFII_LPIPS_WEIGHTS. Pretrained AlexNet
    is not downloaded, so without weights it raises RuntimeError
    (callers report "unavailable")."""
    from nefii_tpu_torch.utils import lpips as lpips_torch

    try:
        return lpips_torch.lpips_from_path(pred, gt, weights_path, device=device)
    except FileNotFoundError:
        raise RuntimeError(
            "LPIPS needs pretrained AlexNet weights: pass weights_path or set "
            "$NEFII_LPIPS_WEIGHTS (see utils/lpips.py). PSNR/SSIM/MS-SSIM are "
            "reported instead.") from None
