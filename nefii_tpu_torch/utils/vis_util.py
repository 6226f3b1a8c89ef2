"""Colormap/colorbar helpers (counterpart of nefii_tpu/utils/vis_util.py).

`jet`, the default and the only map a caller names, is built here from
matplotlib's segment data (its 256-entry lookup table, indexed as
matplotlib's Colormap.__call__ indexes it), so it needs no matplotlib. Any
other map name imports matplotlib at the call, as the JAX module does.
"""

from __future__ import annotations

import numpy as np

# matplotlib's _cm._jet_data: per channel (x, y below x, y above x)
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_N = 256


def _lookup_table(data, n: int = _N) -> np.ndarray:
    """matplotlib.colors._create_lookup_table at gamma 1: [n] float64."""
    adata = np.asarray(data, np.float64)
    x, y0, y1 = adata[:, 0], adata[:, 1], adata[:, 2]
    xind = np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


_JET_LUT = np.stack([_lookup_table(_JET_DATA[c]) for c in ("red", "green", "blue")], -1)


def _jet(norm: np.ndarray) -> np.ndarray:
    """norm in [0, 1] -> [..., 3]: entry clip(int(v * 256), 0, 255)."""
    idx = np.clip((norm * _N).astype(np.int64), 0, _N - 1)
    return _JET_LUT[idx]


def colormap(values: np.ndarray, cmap: str = "jet",
             vmin: float = None, vmax: float = None) -> np.ndarray:
    """Map scalar [H,W] (or flat) values to RGB float32."""
    v = np.asarray(values, np.float32)
    lo = np.nanmin(v) if vmin is None else vmin
    hi = np.nanmax(v) if vmax is None else vmax
    norm = np.clip((v - lo) / max(hi - lo, 1e-12), 0, 1)
    if cmap == "jet":
        return _jet(norm).astype(np.float32)
    import matplotlib

    return np.asarray(matplotlib.colormaps[cmap](norm))[..., :3].astype(np.float32)


def with_colorbar(img: np.ndarray, values: np.ndarray, cmap: str = "jet",
                  bar_width: int = 12) -> np.ndarray:
    """Append a vertical colorbar strip to an [H,W,3] image."""
    H = img.shape[0]
    ramp = np.linspace(1, 0, H, dtype=np.float32)[:, None].repeat(bar_width, 1)
    bar = colormap(ramp, cmap, vmin=0, vmax=1)
    return np.concatenate([img, np.ones((H, 2, 3), np.float32), bar], axis=1)
