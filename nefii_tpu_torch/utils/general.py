"""Ray chunking and small helpers (the port's copy of what the render and
the trainer use from nefii_tpu/utils/general.py).

`pixels_per_chunk` sizes a chunk as 2^level rays in flight divided by the
rays per pixel (reference utils/general.py:24-37). `chunked_forward` runs a
forward over fixed-size pixel chunks (the last one padded by repeating its
last pixel) and stitches the outputs on the host.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np


def mkdir_ifnotexists(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)


def chunk_count(total_pixels: int, num_pixels_per_chunk: int) -> int:
    return -(-total_pixels // num_pixels_per_chunk)


def pixels_per_chunk(memory_capacity_level: int, num_rays: int, world_size: int = 1) -> int:
    """2^level rays in flight across all devices, divided by rays per pixel."""
    rays = 2 ** memory_capacity_level
    n = max(rays // max(num_rays, 1), 1)
    return max(n // world_size * world_size, world_size)


def split_input(model_input: Dict[str, np.ndarray], total_pixels: int, n_pixels: int) -> List[Dict]:
    """Split the per-image input into fixed-size pixel chunks (padded)."""
    chunks = []
    for i in range(chunk_count(total_pixels, n_pixels)):
        lo = i * n_pixels
        hi = min(lo + n_pixels, total_pixels)
        pad = n_pixels - (hi - lo)
        data = {}
        for k, v in model_input.items():
            if k in ("uv", "object_mask"):
                sl = v[:, lo:hi]
                if pad:
                    sl = np.concatenate([sl, sl[:, -1:].repeat(pad, axis=1)], axis=1)
                data[k] = sl
            else:
                data[k] = v
        data["__valid__"] = hi - lo
        chunks.append(data)
    return chunks


def merge_output(res: List[Dict[str, np.ndarray]], total_pixels: int) -> Dict[str, np.ndarray]:
    """Concatenate chunked outputs and drop the padding."""
    out: Dict[str, np.ndarray] = {}
    for k in res[0]:
        if k == "__valid__":
            continue
        parts = [np.asarray(r[k])[: r["__valid__"]] for r in res]
        out[k] = np.concatenate(parts, axis=0)[:total_pixels]
    return out


def chunked_forward(forward_fn: Callable[[Dict], Dict], model_input: Dict[str, np.ndarray],
                    total_pixels: int, n_pixels: int) -> Dict[str, np.ndarray]:
    """Run a forward over fixed-size pixel chunks and merge."""
    results = []
    for chunk in split_input(model_input, total_pixels, n_pixels):
        valid = chunk.pop("__valid__")
        out = {k: np.asarray(v) for k, v in forward_fn(chunk).items()}
        out["__valid__"] = valid
        results.append(out)
    return merge_output(results, total_pixels)
