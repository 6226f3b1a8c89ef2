"""RenderingNetwork — the IDR radiance cache (counterpart of
nefii_tpu/models/rendering.py).

ReLU MLP mapping (x, n, v, feature) -> RGB with positional encodings on the
view direction and the position, plus the output clipping modes. Parameters
are `layers.<i>.{v,g,b}` (or `w`), like the JAX tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nefii_tpu_torch.models.embedder import get_embedder
from nefii_tpu_torch.models.mlp import (
    Linear,
    kaiming_uniform_relu,
    torch_default_init,
    xavier_uniform,
)


class RenderingNetwork(nn.Module):
    def __init__(
        self,
        feature_vector_size: int,
        mode: str = "idr",
        d_in: int = 9,
        d_out: int = 3,
        dims: Sequence[int] = (512,) * 4,
        weight_norm: bool = True,
        weight_init: bool = False,
        multires_view: int = 0,
        multires_xyz: int = 0,
        normalize_output: bool = True,
        clip_output: bool = False,
        clip_method: str = "relu",
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.feature_vector_size = feature_vector_size
        self.mode = mode
        self.d_in, self.d_out = d_in, d_out
        self.dims = tuple(dims)
        self.weight_norm, self.weight_init = weight_norm, weight_init
        self.multires_view, self.multires_xyz = multires_view, multires_xyz
        self.normalize_output, self.clip_output = normalize_output, clip_output
        self.clip_method = clip_method
        dims_all, self.embedview_fn, self.embedxyz_fn = self._layer_dims()
        self.layers = nn.ModuleList(
            Linear(dims_all[l], dims_all[l + 1], weight_norm, device)
            for l in range(len(dims_all) - 1)
        )

    def _layer_dims(self):
        dims = [self.d_in + self.feature_vector_size] + list(self.dims) + [self.d_out]
        embedview_fn, view_ch = get_embedder(self.multires_view, 3)
        embedxyz_fn, xyz_ch = get_embedder(self.multires_xyz, 3)
        if self.multires_view > 0:
            dims[0] += view_ch - 3
        if self.multires_xyz > 0:
            dims[0] += xyz_ch - 3
        return dims, embedview_fn, embedxyz_fn

    def reset_parameters(self, gen: torch.Generator) -> None:
        n = len(self.layers) + 1
        for l, layer in enumerate(self.layers):
            dev = layer.b.device
            w, b = torch_default_init(gen, layer.d_in, layer.d_out, dev)
            if self.weight_init:
                if l < n - 2:
                    w = kaiming_uniform_relu(gen, layer.d_in, layer.d_out, dev)
                elif self.normalize_output:
                    w = xavier_uniform(gen, layer.d_in, layer.d_out, 5.0 / 3.0, dev)
                elif self.clip_method == "relu":
                    w = kaiming_uniform_relu(gen, layer.d_in, layer.d_out, dev)
                b = torch.zeros(layer.d_out, device=dev)
            layer.set_weight(w, b)

    def forward(
        self,
        points: torch.Tensor,
        normals: torch.Tensor,
        view_dirs: torch.Tensor,
        feature_vectors: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.multires_view > 0:
            view_dirs = self.embedview_fn(view_dirs)
        if self.multires_xyz > 0:
            points = self.embedxyz_fn(points)

        if self.mode == "idr":
            parts = [points, view_dirs, normals]
        elif self.mode == "no_view_dir":
            parts = [points, normals]
        elif self.mode == "no_normal":
            parts = [points, view_dirs]
        else:
            raise ValueError(f"unknown rendering mode {self.mode!r}")
        if feature_vectors is not None:
            parts.append(feature_vectors)
        x = torch.cat(parts, dim=-1)

        for l, layer in enumerate(self.layers):
            x = layer(x)
            if l < len(self.layers) - 1:
                x = F.relu(x)

        if self.normalize_output:
            return (torch.tanh(x) + 1.0) / 2.0
        if not self.clip_output:
            return x
        if self.clip_method == "relu":
            return F.relu(x)
        if self.clip_method == "abs":
            return x.abs()
        if self.clip_method == "relu_init":
            return F.relu(x) + 0.5
        if self.clip_method == "pow2":
            return x ** 2
        raise ValueError(f"unknown clip_method {self.clip_method!r}")
