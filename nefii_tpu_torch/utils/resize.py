"""A resampler equal to `cv2.resize` on float32 images, for the calls the JAX
package makes (dataset `subsample`, the envmap tools), in numpy on the host.

    resize(img, (H_new, W_new), "area" | "linear")

Both modes are separable: each axis has an [n_out, n_in] weight matrix, and
the image is resampled as Wh @ img @ Ww.T in float64, then rounded to
float32. The weights follow OpenCV's resize.cpp, each rounded to float32 as
OpenCV stores them, with the axis's factor n_in / n_out taken from the sizes
as cv2 takes it from `dsize`:

  * "area" (INTER_AREA) when no axis grows: exact fractional box overlaps
    (computeResizeAreaTab), pieces under 1e-3 of a pixel dropped, each row
    divided by the cell width n_in / n_out. When an axis grows, cv2's
    INTER_AREA is a 2-tap filter instead (resize.cpp's area_mode), and so is
    this one.
  * "linear" (INTER_LINEAR): half-pixel centres, src = (dst + 0.5) n_in /
    n_out - 0.5, clamped to [0, n_in - 1], the border replicated.

torch.nn.functional.interpolate(mode="area") is not this: its adaptive
pooling bins differ from cv2's fractional overlaps when the factor is not
1 / an integer.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

MODES = ("area", "linear")


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """computeResizeAreaTab: [n_out, n_in] box overlaps for n_out <= n_in."""
    scale = 1.0 / (n_out / n_in)
    w = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[dx, s1 - 1] += np.float32((s1 - f1) / cell)
        w[dx, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[dx, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def _two_tap_weights(n_in: int, n_out: int, area: bool) -> np.ndarray:
    """[n_out, n_in] weights of cv2's 2-tap filter: INTER_LINEAR, or
    INTER_AREA where an axis grows (area_mode), with the border clamped."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    w = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        if area:
            sx = math.floor(dx * scale)
            fx = np.float32((dx + 1) - (sx + 1) * inv_scale)
            fx = np.float32(0.0) if fx <= 0 else np.float32(fx - math.floor(fx))
        else:
            fx = (dx + 0.5) * scale - 0.5
            sx = math.floor(fx)
            fx = np.float32(fx - sx)
        if sx < 0:
            sx, fx = 0, np.float32(0.0)
        if sx >= n_in - 1:
            sx, fx = n_in - 1, np.float32(0.0)
        w[dx, sx] += np.float32(1.0) - fx
        w[dx, min(sx + 1, n_in - 1)] += fx
    return w


def _weights(n_in: int, n_out: int, mode: str, shrink_all: bool) -> np.ndarray:
    """The [n_out, n_in] float64 weights of one axis. `shrink_all`: no axis of
    the image grows (cv2's INTER_AREA then takes the box path on every axis)."""
    if mode == "area" and shrink_all:
        return _area_weights(n_in, n_out)
    return _two_tap_weights(n_in, n_out, area=mode == "area")


def resize(img: np.ndarray, size: Tuple[int, int], mode: str) -> np.ndarray:
    """img [H, W] or [H, W, C] -> float32 [H_new, W_new(, C)], as
    cv2.resize(img, (W_new, H_new), interpolation=INTER_AREA / INTER_LINEAR)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    h, w = int(size[0]), int(size[1])
    if (h, w) == (H, W):
        return img.copy()
    shrink_all = h <= H and w <= W
    wh = _weights(H, h, mode, shrink_all)
    ww = _weights(W, w, mode, shrink_all)
    out = np.tensordot(wh, img.astype(np.float64), axes=(1, 0))   # [h, W, ...]
    out = np.tensordot(ww, out, axes=(1, 1))                       # [w, h, ...]
    return np.swapaxes(out, 0, 1).astype(np.float32)
