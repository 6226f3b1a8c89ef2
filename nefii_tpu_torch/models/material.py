"""EnvmapMaterialNetwork — light SGs and spatially varying materials
(counterpart of nefii_tpu/models/material.py).

  * light: M spherical Gaussians `lgtSGs` [M,7] (lobe, lambda, mu) with the
    fibonacci-sphere lobe init and energy normalisation;
  * diffuse-albedo MLP (ELU) on the encoded position plus the geometry
    feature; `same_mlp` emits albedo + roughness (+ specular) from one head;
  * roughness / specular as global parameters or MLPs, the 0.089 roughness
    floor and the 0.16 s^2 specular remap; `fix_specular_albedo` keeps the
    specular value fixed (detached).

Parameter names follow the JAX tree: `diffuse_albedo_layers.<i>.{w,b}`,
`lgtSGs`, `specular_reflectance`, `roughness`, ...
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nefii_tpu_torch.models.embedder import get_embedder
from nefii_tpu_torch.models.mlp import Linear, torch_default_init

TINY_ROUGHNESS = 0.089


def fibonacci_sphere(samples: int) -> np.ndarray:
    """Evenly distribute `samples` points on the unit sphere (golden angle)."""
    phi = np.pi * (3.0 - np.sqrt(5.0))
    i = np.arange(samples, dtype=np.float64)
    y = 1 - (i / float(samples - 1)) * 2
    radius = np.sqrt(1 - y * y)
    theta = phi * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], axis=-1)


def compute_energy(lgtSGs: torch.Tensor) -> torch.Tensor:
    """Total energy of each SG lobe: mu * 2pi/lambda * (1 - exp(-2 lambda))."""
    lam = lgtSGs[:, 3:4].abs()
    mu = lgtSGs[:, 4:].abs()
    return mu * 2.0 * np.pi / lam * (1.0 - torch.exp(-2.0 * lam))


def _mlp(d_in: int, hidden: Sequence[int], d_out: int, device) -> nn.ModuleList:
    dims = [d_in] + list(hidden) + [d_out]
    return nn.ModuleList(Linear(dims[i], dims[i + 1], False, device) for i in range(len(dims) - 1))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor, final_activation=None) -> torch.Tensor:
    for l, layer in enumerate(layers):
        x = layer(x)
        if l < len(layers) - 1:
            x = F.elu(x)
    return final_activation(x) if final_activation is not None else x


class EnvmapMaterialNetwork(nn.Module):
    def __init__(
        self,
        multires: int = 0,
        dims: Sequence[int] = (256, 256, 256),
        white_specular: bool = False,
        white_light: bool = False,
        num_lgt_sgs: int = 32,
        num_base_materials: int = 2,
        upper_hemi: bool = False,
        fix_specular_albedo: bool = False,
        specular_albedo: Sequence[float] = (-1.0, -1.0, -1.0),
        init_specular_reflectance: float = -1.0,
        correct_normal: bool = False,
        roughness_mlp: bool = False,
        specular_mlp: bool = False,
        same_mlp: bool = False,
        dims_roughness: Sequence[int] = (256, 256, 256),
        dims_specular: Sequence[int] = (256, 256, 256),
        feature_vector_size: int = 0,
        use_normal: bool = False,
        light_type: str = "sg",
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.multires = multires
        self.white_specular, self.white_light = white_specular, white_light
        self.num_lgt_sgs = num_lgt_sgs
        self.num_base_materials = num_base_materials
        self.upper_hemi = upper_hemi
        self.fix_specular_albedo = fix_specular_albedo
        self.specular_albedo = tuple(specular_albedo)
        self.init_specular_reflectance = init_specular_reflectance
        self.correct_normal = correct_normal
        self.roughness_mlp, self.specular_mlp, self.same_mlp = roughness_mlp, specular_mlp, same_mlp
        self.feature_vector_size = feature_vector_size
        self.use_normal = use_normal
        self.light_type = light_type
        self.embed_fn, emb_dim = get_embedder(multires, 3)

        input_dim = emb_dim + feature_vector_size + (3 if use_normal else 0)
        dim_o = 3
        if roughness_mlp and same_mlp:
            dim_o += 1
        if not fix_specular_albedo and specular_mlp and same_mlp:
            dim_o += 1
        self.diffuse_albedo_layers = _mlp(input_dim, dims, dim_o, device)
        if correct_normal:
            self.delta_normal_layers = _mlp(input_dim, dims, 2, device)

        M, K = num_lgt_sgs, num_base_materials
        if light_type == "sg":
            self.lgtSGs = nn.Parameter(torch.empty(M, 5 if white_light else 7, device=device))
        else:
            self.lgtSGs = nn.Parameter(torch.empty(M, M, 3, device=device))

        if fix_specular_albedo:
            assert K == 1
            spec = torch.tensor(self.specular_albedo, dtype=torch.float32, device=device)
            assert bool(((spec > 0) & (spec < 1)).all())
            self.specular_reflectance = nn.Parameter(spec.reshape(K, 3), requires_grad=False)
        elif not specular_mlp:
            self.specular_reflectance = nn.Parameter(
                torch.empty(K, 1 if white_specular else 3, device=device))
        elif not same_mlp:
            self.specular_layers = _mlp(input_dim, dims_specular, 1 if white_specular else 3, device)

        if not roughness_mlp:
            self.roughness = nn.Parameter(torch.empty(K, 1, device=device))
        elif not same_mlp:
            self.roughness_layers = _mlp(input_dim, dims_roughness, 1, device)

        if K > 1:
            self.blending_weights_layers = _mlp(input_dim, (256, 256, 256), K, device)

    # ------------------------------------------------------------------
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, mod in self.named_children():
            if isinstance(mod, nn.ModuleList):
                for layer in mod:
                    layer.set_weight(*torch_default_init(
                        gen, layer.d_in, layer.d_out, layer.b.device))
        dev = self.lgtSGs.device
        with torch.no_grad():
            M = self.num_lgt_sgs
            if self.light_type == "sg":
                lgt = torch.randn(self.lgtSGs.shape, generator=gen, device=dev)
                if not self.white_light:
                    lgt[:, -2:] = lgt[:, -3:-2].repeat(1, 2)
                lgt[:, 3:4] = 20.0 + (lgt[:, 3:4] * 100.0).abs()
                lam = lgt[:, 3:4].abs()
                energy = lgt[:, 4:].abs() * 2.0 * np.pi / lam * (1.0 - torch.exp(-2.0 * lam))
                lgt[:, 4:] = lgt[:, 4:].abs() / energy.sum(0, keepdim=True) * 2.0 * np.pi
                lgt[:, :3] = torch.as_tensor(fibonacci_sphere(M), dtype=torch.float32, device=dev)
                if self.upper_hemi:
                    lgt = self._restrict_lobes_upper(lgt)
                self.lgtSGs.copy_(lgt)
            else:
                self.lgtSGs.copy_(torch.randn(self.lgtSGs.shape, generator=gen, device=dev).abs())
            if not self.fix_specular_albedo and not self.specular_mlp:
                spec = torch.randn(self.specular_reflectance.shape, generator=gen, device=dev).abs()
                if self.init_specular_reflectance > 0:
                    spec.fill_(float(np.log(1.0 / (1.0 - self.init_specular_reflectance) - 1.0)))
                self.specular_reflectance.copy_(spec)
            if not self.roughness_mlp:
                lo = -1.5 if self.num_base_materials > 1 else 1.5
                self.roughness.copy_(lo + (2.0 - lo) * torch.rand(
                    self.roughness.shape, generator=gen, device=dev))

    @staticmethod
    def _restrict_lobes_upper(lgtSGs: torch.Tensor) -> torch.Tensor:
        return torch.cat([lgtSGs[..., :1], lgtSGs[..., 1:2].abs(), lgtSGs[..., 2:]], dim=-1)

    def get_lgtSGs(self) -> torch.Tensor:
        lgt = self.lgtSGs
        if self.light_type == "sg":
            if lgt.shape[-1] == 5:  # white light stored as [M,5]
                lgt = torch.cat([lgt, lgt[..., -1:], lgt[..., -1:]], dim=-1)
            if self.upper_hemi:
                lgt = self._restrict_lobes_upper(lgt)
            return lgt
        return lgt.abs()

    def get_base_materials(self):
        """The detached global (roughness [K,1], specular [K,3]); zeros where a
        net predicts them per point."""
        dev = self.lgtSGs.device
        if not self.roughness_mlp:
            roughness = torch.sigmoid(self.roughness.detach())
        else:
            roughness = torch.zeros(1, 1, device=dev)
        if self.fix_specular_albedo:
            specular = self.specular_reflectance.detach()
        elif not self.specular_mlp:
            specular = torch.sigmoid(self.specular_reflectance.detach())
            if self.white_specular:
                specular = specular.expand(specular.shape[0], 3)
        else:
            specular = torch.zeros(1, 3, device=dev)
        return roughness, specular

    @staticmethod
    def specular_remap(s: torch.Tensor) -> torch.Tensor:
        """Filament f0 remap: f0 = 0.16 * reflectance^2."""
        return 0.16 * s ** 2

    # ------------------------------------------------------------------
    def _embed_input(self, points, feature_vector, normal):
        x = self.embed_fn(points) if self.multires > 0 else points
        if feature_vector is not None:
            x = torch.cat([x, feature_vector], dim=-1)
        if self.use_normal and normal is not None:
            x = torch.cat([x, normal], dim=-1)
        return x

    def apply_correct_normal(self, n: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """Delta-normal correction: rotate n by MLP-predicted angles."""
        if not self.correct_normal:
            return n
        x = self.embed_fn(points) if self.multires > 0 else points
        ang = _mlp_apply(self.delta_normal_layers, x)
        theta = torch.sigmoid(ang[..., 0:1]) * np.pi * 0.5
        phi = torch.tanh(ang[..., 1:2]) * np.pi
        xyz = torch.cat([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                         torch.cos(theta)], dim=-1)
        x_axis = torch.zeros_like(n)
        x_axis[..., 0] = 1.0
        y_axis = torch.zeros_like(n)
        y_axis[..., 1] = 1.0
        vup = torch.where(n[..., 0:1] > 0.9, y_axis, x_axis)
        t = torch.cross(vup, n, dim=-1)
        t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
        s = torch.cross(t, n, dim=-1)
        return xyz[..., :1] * t + xyz[..., 1:2] * s + xyz[..., 2:] * n

    def forward(self, points, feature_vector=None, normal=None,
                fake_roughness: bool = False, fake_specular: bool = False
                ) -> Dict[str, Optional[torch.Tensor]]:
        x = self._embed_input(points, feature_vector, normal)

        brdf = _mlp_apply(self.diffuse_albedo_layers, x)
        diffuse_albedo = torch.sigmoid(brdf[..., :3])
        offset = 3
        roughness = specular_reflectance = None
        if self.roughness_mlp and self.same_mlp:
            roughness = torch.sigmoid(brdf[..., offset:offset + 1])
            offset += 1
        if not self.fix_specular_albedo and self.specular_mlp and self.same_mlp:
            specular_reflectance = torch.sigmoid(brdf[..., offset:offset + 1])
            offset += 1

        blending_weights = None
        if self.num_base_materials > 1:
            blending_weights = torch.softmax(_mlp_apply(self.blending_weights_layers, x), dim=-1)

        if self.fix_specular_albedo:
            specular_reflectance = self.specular_reflectance.detach()
        else:
            if not self.specular_mlp:
                specular_reflectance = torch.sigmoid(self.specular_reflectance)
            elif not self.same_mlp:
                specular_reflectance = _mlp_apply(self.specular_layers, x, torch.sigmoid)
            if self.white_specular:
                specular_reflectance = specular_reflectance.expand(
                    *specular_reflectance.shape[:-1], 3)

        if not self.roughness_mlp:
            roughness = torch.sigmoid(self.roughness)
        elif not self.same_mlp:
            roughness = _mlp_apply(self.roughness_layers, x, torch.sigmoid)

        roughness = (1 - TINY_ROUGHNESS) * roughness + TINY_ROUGHNESS
        if fake_roughness:
            roughness = 0 * roughness + 0.5
        if fake_specular:
            specular_reflectance = 0 * specular_reflectance + 0.5
        specular_reflectance = self.specular_remap(specular_reflectance)

        return {
            "sg_lgtSGs": self.get_lgtSGs(),
            "sg_specular_reflectance": specular_reflectance,
            "sg_roughness": roughness,
            "sg_diffuse_albedo": diffuse_albedo,
            "sg_blending_weights": blending_weights,
        }
