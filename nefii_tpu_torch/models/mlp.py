"""Linear-layer primitives (counterpart of nefii_tpu/models/mlp.py).

`Linear` holds either a plain weight `w` [out, in] or the weight-norm pair
`v` [out, in], `g` [out, 1], plus a bias `b` [out] — the same leaves, under
the same names, as the JAX package's per-layer param dicts, so a flat JAX
checkpoint key `.../layers/3/v` maps to the port's `....layers.3.v`.
Initialisers take an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """y = x @ W.T + b, with W = g * v / ||v|| (row norm) when weight-normed."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.d_in, self.d_out, self.weight_norm = d_in, d_out, weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(d_out, d_in, device=device))
            self.g = nn.Parameter(torch.empty(d_out, 1, device=device))
        else:
            self.w = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.b = nn.Parameter(torch.empty(d_out, device=device))

    def set_weight(self, w: torch.Tensor, b: torch.Tensor) -> None:
        """Install a plain weight; weight-normed layers start with g = ||w||
        per row, so the effective weight equals `w` (torch weight_norm dim=0)."""
        with torch.no_grad():
            if self.weight_norm:
                self.v.copy_(w)
                self.g.copy_(torch.linalg.norm(w, dim=1, keepdim=True))
            else:
                self.w.copy_(w)
            self.b.copy_(b)

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            norm = torch.linalg.norm(self.v, dim=1, keepdim=True)
            return self.g * self.v / (norm + 1e-12)
        return self.w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.effective_weight().t() + self.b


def torch_default_init(gen: torch.Generator, d_in: int, d_out: int, device=None):
    """torch.nn.Linear default: U(-1/sqrt(d_in), 1/sqrt(d_in)) for w and b."""
    bound = 1.0 / np.sqrt(d_in)
    w = (torch.rand(d_out, d_in, generator=gen, device=device) * 2 - 1) * bound
    b = (torch.rand(d_out, generator=gen, device=device) * 2 - 1) * bound
    return w, b


def kaiming_uniform_relu(gen: torch.Generator, d_in: int, d_out: int, device=None):
    """kaiming_uniform_(mode='fan_in', nonlinearity='relu'): U(+-sqrt(6/d_in))."""
    bound = np.sqrt(6.0 / d_in)
    return (torch.rand(d_out, d_in, generator=gen, device=device) * 2 - 1) * bound


def xavier_uniform(gen: torch.Generator, d_in: int, d_out: int, gain: float = 1.0,
                   device=None):
    bound = gain * np.sqrt(6.0 / (d_in + d_out))
    return (torch.rand(d_out, d_in, generator=gen, device=device) * 2 - 1) * bound


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """nn.Softplus(beta) in the stable form max(t,0) + log1p(exp(-|t|)), t = beta x."""
    t = beta * x
    return (F.relu(t) + torch.log1p(torch.exp(-t.abs()))) / beta
