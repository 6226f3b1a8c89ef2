"""NeRF-style positional encoding (counterpart of nefii_tpu/models/embedder.py).

Layout [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], so feature
indices line up with the JAX package and the reference checkpoints.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def get_embedder(multires: int, input_dims: int = 3) -> Tuple[Callable, int]:
    """Return (embed_fn, out_dim). embed_fn maps [..., input_dims] -> [..., out_dim]."""
    if multires <= 0:
        return (lambda x: x), input_dims

    freq_bands = [float(f) for f in
                  np.asarray(2.0 ** np.linspace(0.0, multires - 1, multires), np.float32)]
    out_dim = input_dims * (1 + 2 * multires)

    def embed(x: torch.Tensor) -> torch.Tensor:
        parts = [x]
        for freq in freq_bands:
            parts.append(torch.sin(x * freq))
            parts.append(torch.cos(x * freq))
        return torch.cat(parts, dim=-1)

    return embed, out_dim
