"""IDRLoss — the Step-2 training loss (counterpart of nefii_tpu/models/loss.py).

Terms: idr_rgb and sg_rgb on hit-and-masked pixels, background SG-vs-gt on
miss-and-unmasked pixels, eikonal, mask BCE on -alpha*sdf (alpha scheduled
by the trainer), masked SSIM on (2r)x(2r) patches with mask erosion, and
the normal-smooth and roughness-smooth patch variances, and the view-diff
term: on a batch of 2B rows whose last B are the first B's partner views
(the trainer's cross-view pairing), the difference between a pixel and its
partner against the difference between their ground truths, where
`ground_truth["pixel_visible"]` and both rows' masks hold. torch.var's
unbiased (n-1) divisor is kept.

Every reduction is a masked mean carried as a (numerator, denominator)
pair and divided once. `all_reduce`, when given, sums each pair over the
processes before the division (a multi-GPU run passes a
torch.distributed all-reduce), so a sharded loss equals the single-device
one; without it the pair is divided as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

AllReduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _reduce(pair: torch.Tensor, all_reduce: AllReduce) -> torch.Tensor:
    return all_reduce(pair) if all_reduce is not None else pair


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, all_reduce: AllReduce = None) -> torch.Tensor:
    """Mean of x over the rows where mask (over every process with all_reduce)."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    num, den = _reduce(torch.stack([(x * m).sum(), (m * torch.ones_like(x)).sum()]), all_reduce)
    return torch.where(den > 0, num / den.clamp(min=1.0), torch.zeros_like(num))


def _img_loss(pred: torch.Tensor, gt: torch.Tensor, kind: str) -> torch.Tensor:
    d = pred - gt
    if kind == "L1":
        return d.abs()
    if kind == "L2":
        return d * d
    if kind == "L1_smooth":
        ad = d.abs()
        return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    raise ValueError(f"unknown loss_type {kind!r}")


def _var_unbiased(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    mu = x.mean(dim=dim, keepdim=True)
    return ((x - mu) ** 2).sum(dim=dim) / max(n - 1, 1)


# ---------------------------------------------------------------------------
# masked SSIM
# ---------------------------------------------------------------------------

def _gauss_kernel_1d(size: int, sigma: float, device) -> torch.Tensor:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return torch.as_tensor(g / g.sum(), dtype=torch.float32, device=device)


def _gaussian_filter(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode gaussian blur of [B,C,H,W]."""
    C, size = img.shape[1], win.shape[0]
    out = F.conv2d(img, win.reshape(1, 1, size, 1).expand(C, 1, size, 1), groups=C)
    return F.conv2d(out, win.reshape(1, 1, 1, size).expand(C, 1, 1, size), groups=C)


def _erode_mask(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Binary erosion of [B,1,H,W] by a size x size all-ones kernel, SAME
    padding with the border counted as inside."""
    outside = 1.0 - mask.float()
    return (1.0 - F.max_pool2d(outside, size, stride=1, padding=size // 2)) > 0.5


def ssim_loss_fn(X: torch.Tensor, Y: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 data_range: float = 1.0, win_size: int = 11, win_sigma: float = 1.5,
                 K=(0.01, 0.03), all_reduce: AllReduce = None) -> torch.Tensor:
    """1 - masked SSIM of [B,C,H,W] images. Patches smaller than win_size
    shrink the window."""
    _, _, H, W = X.shape
    eff = min(win_size, H, W)
    if eff % 2 == 0:
        eff -= 1
    win = _gauss_kernel_1d(eff, win_sigma, X.device)
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2

    mu1, mu2 = _gaussian_filter(X, win), _gaussian_filter(Y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _gaussian_filter(X * X, win) - mu1_sq
    sigma2_sq = _gaussian_filter(Y * Y, win) - mu2_sq
    sigma12 = _gaussian_filter(X * Y, win) - mu1_mu2
    cs = (2 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    ssim_map = (((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs).mean(dim=1, keepdim=True)

    if mask is None:
        return 1.0 - ssim_map.mean()
    m = _erode_mask(mask, eff)
    pad = (H - ssim_map.shape[2]) // 2
    ssim_full = F.pad(ssim_map, (pad, pad, pad, pad), value=1.0)
    val = 1.0 - _masked_mean(ssim_full, m, all_reduce)
    n_in = _reduce(m.sum().to(X.dtype).reshape(1), all_reduce)[0]
    return torch.where(n_in > 0, val, torch.zeros_like(val))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IDRLoss:
    idr_rgb_weight: float
    sg_rgb_weight: float
    eikonal_weight: float
    mask_weight: float
    alpha: float
    r_patch: int = -1
    normalsmooth_weight: float = 0.0
    loss_type: str = "L1"
    env_loss_type: str = "L1"
    idr_ssim_weight: float = 0.0
    sg_ssim_weight: float = 0.0
    view_diff_weight: float = 0.0
    roughnesssmooth_weight: float = 0.0
    background_rgb_weight: float = 0.0
    view_diff_full_rgb: bool = True
    sample_each_iter: bool = False

    def __post_init__(self):
        object.__setattr__(self, "r_patch", int(self.r_patch))

    # -- individual terms ---------------------------------------------------
    def get_rgb_loss(self, idr_rgb, sg_rgb, rgb_gt, net_mask, obj_mask, all_reduce=None):
        mask = net_mask & obj_mask
        gt = rgb_gt.reshape(-1, 3)
        return (_masked_mean(_img_loss(idr_rgb, gt, self.loss_type), mask, all_reduce),
                _masked_mean(_img_loss(sg_rgb, gt, self.loss_type), mask, all_reduce))

    def get_background_rgb_loss(self, sg_rgb, rgb_gt, net_mask, obj_mask, all_reduce=None):
        if self.background_rgb_weight <= 0:
            return sg_rgb.new_zeros(())
        mask = ~net_mask & ~obj_mask
        return _masked_mean(_img_loss(sg_rgb, rgb_gt.reshape(-1, 3), self.env_loss_type), mask,
                            all_reduce)

    def get_eikonal_loss(self, grad_theta, all_reduce=None):
        if grad_theta is None:
            return torch.zeros(())
        sq = (torch.linalg.norm(grad_theta, dim=1) - 1) ** 2
        num, den = _reduce(torch.stack([sq.sum(), sq.new_tensor(float(sq.numel()))]), all_reduce)
        return num / den

    def get_mask_loss(self, sdf_output, net_mask, obj_mask, alpha=None, all_reduce=None):
        a = self.alpha if alpha is None else alpha
        mask = ~(net_mask & obj_mask)
        x = -a * sdf_output[:, 0]
        z = obj_mask.to(x.dtype)
        # binary_cross_entropy_with_logits, summed over the masked set
        bce = torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
        total, n_total, n_mask = _reduce(torch.stack([
            (bce * mask.to(x.dtype)).sum(), x.new_tensor(float(obj_mask.shape[0])),
            mask.sum().to(x.dtype)]), all_reduce)
        val = (1.0 / a) * total / n_total
        return torch.where(n_mask > 0, val, torch.zeros_like(val))

    def get_ssim_loss(self, idr_rgb, sg_rgb, rgb_gt, net_mask, obj_mask, all_reduce=None):
        zero = idr_rgb.new_zeros(())
        if self.r_patch < 1 or (self.idr_ssim_weight == 0.0 and self.sg_ssim_weight == 0.0):
            return zero, zero
        mask = net_mask & obj_mask
        s = 2 * self.r_patch

        def to_img(x):
            return x.reshape(-1, s, s, 3).permute(0, 3, 1, 2)

        gt = to_img(rgb_gt.reshape(-1, 3))
        m = mask.reshape(-1, s, s, 1).permute(0, 3, 1, 2)
        idr = ssim_loss_fn(to_img(idr_rgb), gt, m, all_reduce=all_reduce)
        sg = ssim_loss_fn(to_img(sg_rgb), gt, m, all_reduce=all_reduce)
        any_mask = _reduce(mask.sum().to(idr.dtype).reshape(1), all_reduce)[0] > 0
        return torch.where(any_mask, idr, zero), torch.where(any_mask, sg, zero)

    def get_normalsmooth_loss(self, normal, net_mask, obj_mask, all_reduce=None):
        if self.r_patch < 1 or self.normalsmooth_weight == 0.0:
            return normal.new_zeros(())
        p = 4 * self.r_patch * self.r_patch
        mask = (net_mask & obj_mask).reshape(-1, p).all(dim=-1)
        return _masked_mean(_var_unbiased(normal.reshape(-1, p, 3), dim=1), mask, all_reduce)

    def get_roughnesssmooth_loss(self, roughness, normal, net_mask, obj_mask, all_reduce=None):
        if self.r_patch < 1 or self.roughnesssmooth_weight == 0.0:
            return roughness.new_zeros(())
        p = 4 * self.r_patch * self.r_patch
        mask = (net_mask & obj_mask).reshape(-1, p).all(dim=-1)
        rvar = _var_unbiased(roughness.reshape(-1, p, 1), dim=1)
        nvar = _var_unbiased(normal.detach().reshape(-1, p, 3), dim=1).mean(-1, keepdim=True)
        return _masked_mean(rvar * (4.0 - nvar), mask, all_reduce)

    def get_view_diff_loss(self, rgb, gt_rgb, net_mask, obj_mask, pixel_visible,
                           all_reduce=None):
        """rgb [2B*S,3] and gt_rgb [2B,S,3] of a batch whose rows B..2B-1 are
        the partner views of rows 0..B-1; pixel_visible [B,S]."""
        if self.view_diff_weight <= 0 or pixel_visible is None:
            return rgb.new_zeros(())
        B2, S, _ = gt_rgb.shape
        B = B2 // 2
        rgb = rgb.reshape(2, B, S, 3)
        gt = gt_rgb.reshape(2, B, S, 3)
        nm = net_mask.reshape(2, B, S)
        om = obj_mask.reshape(2, B, S)
        mask = pixel_visible & nm[0] & nm[1] & om[0] & om[1]
        diff = (rgb[0] - rgb[1]).reshape(-1, 3)
        gt_diff = (gt[0] - gt[1]).reshape(-1, 3)
        return _masked_mean(_img_loss(diff, gt_diff, self.loss_type), mask.reshape(-1),
                            all_reduce)

    # -- combined ------------------------------------------------------------
    def __call__(self, model_outputs: Dict, ground_truth: Dict, alpha: Optional[float] = None,
                 all_reduce: AllReduce = None) -> Dict[str, torch.Tensor]:
        rgb_gt = ground_truth["rgb"]
        net_mask = model_outputs["network_object_mask"]
        obj_mask = model_outputs["object_mask"]
        idr_rgb, sg_rgb = model_outputs["idr_rgb_values"], model_outputs["sg_rgb_values"]
        normals = model_outputs["normal_values"]

        idr_rgb_loss, sg_rgb_loss = self.get_rgb_loss(idr_rgb, sg_rgb, rgb_gt, net_mask, obj_mask,
                                                      all_reduce)
        terms = {
            "idr_rgb_loss": idr_rgb_loss,
            "sg_rgb_loss": sg_rgb_loss,
            "eikonal_loss": self.get_eikonal_loss(model_outputs["grad_theta"], all_reduce),
            "mask_loss": self.get_mask_loss(model_outputs["sdf_output"], net_mask, obj_mask,
                                            alpha, all_reduce),
            "normalsmooth_loss": self.get_normalsmooth_loss(normals, net_mask, obj_mask,
                                                            all_reduce),
            "roughnesssmooth_loss": self.get_roughnesssmooth_loss(
                model_outputs["sg_roughness_values"], normals, net_mask, obj_mask, all_reduce),
        }
        terms["idr_ssim_loss"], terms["sg_ssim_loss"] = self.get_ssim_loss(
            idr_rgb, sg_rgb, rgb_gt, net_mask, obj_mask, all_reduce)
        terms["view_diff_loss"] = self.get_view_diff_loss(
            sg_rgb if self.view_diff_full_rgb else model_outputs["sg_specular_rgb_values"],
            rgb_gt, net_mask, obj_mask, ground_truth.get("pixel_visible"), all_reduce)
        terms["background_rgb_loss"] = self.get_background_rgb_loss(sg_rgb, rgb_gt, net_mask,
                                                                    obj_mask, all_reduce)
        terms = {k: v.to(idr_rgb.device) for k, v in terms.items()}
        loss = (self.idr_rgb_weight * terms["idr_rgb_loss"]
                + self.sg_rgb_weight * terms["sg_rgb_loss"]
                + self.eikonal_weight * terms["eikonal_loss"]
                + self.mask_weight * terms["mask_loss"]
                + self.normalsmooth_weight * terms["normalsmooth_loss"]
                + self.roughnesssmooth_weight * terms["roughnesssmooth_loss"]
                + self.idr_ssim_weight * terms["idr_ssim_loss"]
                + self.sg_ssim_weight * terms["sg_ssim_loss"]
                + self.view_diff_weight * terms["view_diff_loss"]
                + self.background_rgb_weight * terms["background_rgb_loss"])
        return {"loss": loss, **terms}
