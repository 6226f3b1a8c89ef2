"""ImplicitNetwork — SDF + geometry-feature MLP (counterpart of
nefii_tpu/models/implicit.py).

softplus(beta=100) MLP with a skip connection (concat(h, x)/sqrt(2)),
geometric initialisation, weight norm, positional encoding and
`use_last_as_f` (the last hidden layer is the appearance feature).
Parameters are `layers.<i>.{v,g,b}` like the JAX tree `layers/<i>/{v,g,b}`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from nefii_tpu_torch.models.embedder import get_embedder
from nefii_tpu_torch.models.mlp import Linear, softplus_beta, torch_default_init


class ImplicitNetwork(nn.Module):
    def __init__(
        self,
        feature_vector_size: int,
        d_in: int = 3,
        d_out: int = 1,
        dims: Sequence[int] = (512,) * 8,
        geometric_init: bool = True,
        bias: float = 1.0,
        skip_in: Sequence[int] = (),
        weight_norm: bool = True,
        multires: int = 0,
        use_last_as_f: bool = False,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.feature_vector_size = feature_vector_size
        self.d_in, self.d_out = d_in, d_out
        self.dims = tuple(dims)
        self.geometric_init = geometric_init
        self.bias = bias
        self.skip_in = tuple(skip_in)
        self.weight_norm = weight_norm
        self.multires = multires
        self.use_last_as_f = use_last_as_f
        if use_last_as_f:
            assert feature_vector_size == self.dims[-1]
        dims_all, self.embed_fn = self._layer_dims()
        n = len(dims_all)
        self.layers = nn.ModuleList()
        for l in range(n - 1):
            out_dim = dims_all[l + 1] - dims_all[0] if (l + 1) in self.skip_in else dims_all[l + 1]
            self.layers.append(Linear(dims_all[l], out_dim, weight_norm, device))

    def _layer_dims(self):
        if not self.use_last_as_f:
            dims = [self.d_in] + list(self.dims) + [self.d_out + self.feature_vector_size]
        else:
            dims = [self.d_in] + list(self.dims) + [self.d_out]
        embed_fn, input_ch = get_embedder(self.multires, self.d_in)
        if self.multires > 0:
            dims[0] = input_ch
        return dims, embed_fn

    @property
    def num_layers(self) -> int:
        return len(self.layers) + 1

    # ---- init ------------------------------------------------------------
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Geometric init (a sphere of radius `bias`) or the torch default."""
        dims, _ = self._layer_dims()
        n = len(dims)
        for l, layer in enumerate(self.layers):
            out_dim, in_dim = layer.d_out, layer.d_in
            dev = layer.b.device

            def normal(*shape):
                return torch.randn(*shape, generator=gen, device=dev)

            if self.geometric_init:
                if l == n - 2:
                    w = np.sqrt(np.pi) / np.sqrt(dims[l]) + 1e-4 * normal(out_dim, in_dim)
                    b = torch.full((out_dim,), -self.bias, device=dev)
                elif self.multires > 0 and l == 0:
                    w = torch.zeros(out_dim, in_dim, device=dev)
                    w[:, : self.d_in] = np.sqrt(2.0 / out_dim) * normal(out_dim, self.d_in)
                    b = torch.zeros(out_dim, device=dev)
                elif self.multires > 0 and l in self.skip_in:
                    w = np.sqrt(2.0 / out_dim) * normal(out_dim, in_dim)
                    w[:, -(dims[0] - self.d_in):] = 0.0
                    b = torch.zeros(out_dim, device=dev)
                else:
                    w = np.sqrt(2.0 / out_dim) * normal(out_dim, in_dim)
                    b = torch.zeros(out_dim, device=dev)
            else:
                w, b = torch_default_init(gen, in_dim, out_dim, dev)
            layer.set_weight(w, b)

    # ---- forward -----------------------------------------------------------
    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        """pts [..., 3] -> [..., d_out + feature_vector_size] (sdf first)."""
        n = self.num_layers
        inp = self.embed_fn(pts) if self.multires > 0 else pts
        x = inp
        feature = None
        for l, layer in enumerate(self.layers):
            if self.use_last_as_f and l == n - 2:
                feature = x
            if l in self.skip_in:
                x = torch.cat([x, inp], dim=-1) / np.sqrt(2.0)
            x = layer(x)
            if l < n - 2:
                x = softplus_beta(x, 100.0)
        if self.use_last_as_f:
            x = torch.cat([x, feature], dim=-1)
        return x

    def sdf(self, pts: torch.Tensor) -> torch.Tensor:
        return self(pts)[..., 0]

    def sdf_feature_grad(self, pts: torch.Tensor):
        """(sdf [...], feature [..., F], grad [..., 3]) from one forward and one
        input-space backward of the sdf column. The returned values carry no
        graph (value-only: the render path)."""
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            out = self(p)
            (grad,) = torch.autograd.grad(out[..., 0].sum(), p)
        out = out.detach()
        return out[..., 0], out[..., 1:], grad

    def gradient(self, pts: torch.Tensor) -> torch.Tensor:
        """Per-point spatial gradient of the SDF: [..., 3] -> [..., 3]."""
        return self.sdf_feature_grad(pts)[2]
