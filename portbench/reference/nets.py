"""Plain-PyTorch networks of the Step-2 model, written from the NeFII / IDR
equations: the SDF net (softplus-100 MLP, skip at layer 4 as concat/sqrt(2),
positional encoding, weight norm), the IDR radiance net (ReLU MLP on x, v, n
and the geometry feature, pow2 output) and the material net (ELU MLP giving
albedo and roughness, the 0.089 roughness floor, the 0.16 s^2 specular
remap), and the SG light. Parameters are a flat dict keyed by the names the
port's modules give them (`implicit_network.layers.0.v`, ...), so the same
tensors can be loaded into the port and read here. Nothing here imports the
port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import math

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
TINY = 1e-6
TINY_ROUGHNESS = 0.089


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    if multires <= 0:
        return x
    parts = [x]
    for k in range(multires):
        f = 2.0 ** k
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def embed_dim(multires: int, d: int = 3) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def softplus100(x: torch.Tensor) -> torch.Tensor:
    t = 100.0 * x
    return (F.relu(t) + torch.log1p(torch.exp(-t.abs()))) / 100.0


class Layer:
    """One linear layer's leaves: weight-normed (v, g) or plain w, and b."""

    def __init__(self, prefix: str, weight_norm: bool):
        self.prefix, self.weight_norm = prefix, weight_norm

    def weight(self, p: Params) -> torch.Tensor:
        if self.weight_norm:
            v, g = p[self.prefix + ".v"], p[self.prefix + ".g"]
            return g * v / (torch.linalg.norm(v, dim=1, keepdim=True) + 1e-12)
        return p[self.prefix + ".w"]

    def __call__(self, p: Params, x: torch.Tensor, q=None) -> torch.Tensor:
        w = self.weight(p)
        if q is not None:
            x, w = q(x), q(w)
        return x @ w.t() + p[self.prefix + ".b"]

    def leaves(self) -> List[str]:
        return [self.prefix + s for s in ((".v", ".g", ".b") if self.weight_norm else (".w", ".b"))]


def layer_shapes(dims: List[int], skip_in=()) -> List[Tuple[int, int]]:
    """(d_in, d_out) of each layer of an MLP over dims, where a layer whose
    output feeds a skip concatenation leaves room for the embedded input."""
    out = []
    for l in range(len(dims) - 1):
        d_out = dims[l + 1] - dims[0] if (l + 1) in skip_in else dims[l + 1]
        out.append((dims[l], d_out))
    return out


class SDFNet:
    """conf["model"]["implicit_network"] -> sdf, feature and d sdf / d x."""

    def __init__(self, c: Dict, feature_size: int):
        self.multires = int(c.get("multires", 0))
        self.skip_in = tuple(c.get("skip_in", ()))
        self.use_last_as_f = bool(c.get("use_last_as_f", False))
        self.feature_size = feature_size
        d_in = embed_dim(self.multires)
        last = 1 if self.use_last_as_f else 1 + feature_size
        self.dims = [d_in] + list(c["dims"]) + [last]
        self.shapes = layer_shapes(self.dims, self.skip_in)
        self.layers = [Layer(f"implicit_network.layers.{l}", bool(c.get("weight_norm", True)))
                       for l in range(len(self.shapes))]

    def forward(self, p: Params, pts: torch.Tensor, q=None):
        """-> (sdf [N], feature [N,F]); `q` rounds every product's inputs to
        a lower precision (the control)."""
        inp = embed(pts, self.multires)
        x = inp
        n = len(self.layers)
        feature = None
        for l, layer in enumerate(self.layers):
            if self.use_last_as_f and l == n - 1:
                feature = x
            if l in self.skip_in:
                x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
            x = layer(p, x, q)
            if l < n - 1:
                x = softplus100(x)
        if self.use_last_as_f:
            return x[:, 0], feature
        return x[:, 0], x[:, 1:]

    def sdf(self, p: Params, pts: torch.Tensor, q=None) -> torch.Tensor:
        return self.forward(p, pts, q)[0]

    def sdf_feature_grad(self, p: Params, pts: torch.Tensor, q=None):
        """Values: sdf, feature and the gradient of sdf in pts, by autograd."""
        with torch.enable_grad():
            x = pts.detach().requires_grad_(True)
            pw = {k: v.detach() for k, v in p.items() if k.startswith("implicit_network.")}
            sdf, feat = self.forward(pw, x, q)
            (g,) = torch.autograd.grad(sdf.sum(), x)
        return sdf.detach(), feat.detach(), g.detach()

    def flops_per_point(self) -> Tuple[int, int]:
        """Multiply-adds x 2 of the hidden chain and of the sdf column."""
        hidden = sum(2 * a * b for a, b in self.shapes[:-1])
        return hidden, 2 * self.shapes[-1][0]


class RenderNet:
    """conf["model"]["rendering_network"] (mode idr)."""

    def __init__(self, c: Dict, feature_size: int):
        self.mv, self.mx = int(c.get("multires_view", 0)), int(c.get("multires_xyz", 0))
        d0 = int(c.get("d_in", 9)) + feature_size + embed_dim(self.mv) - 3 + embed_dim(self.mx) - 3
        self.dims = [d0] + list(c["dims"]) + [int(c.get("d_out", 3))]
        self.shapes = layer_shapes(self.dims)
        self.layers = [Layer(f"rendering_network.layers.{l}", bool(c.get("weight_norm", True)))
                       for l in range(len(self.shapes))]
        if c.get("mode", "idr") != "idr" or c.get("normalize_output", True) \
                or c.get("clip_method", "relu") != "pow2" or not c.get("clip_output", False):
            raise ValueError("the reference holds the idr mode with pow2 clipping only")

    def __call__(self, p: Params, pts, normals, view_dirs, feats, q=None):
        x = torch.cat([embed(pts, self.mx), embed(view_dirs, self.mv), normals, feats], dim=-1)
        for l, layer in enumerate(self.layers):
            x = layer(p, x, q)
            if l < len(self.layers) - 1:
                x = F.relu(x)
        return x ** 2


class MaterialNet:
    """conf["model"]["envmap_material_network"]: one MLP (same_mlp) giving
    albedo and roughness, a fixed specular albedo, an SG light."""

    def __init__(self, c: Dict, feature_size: int):
        self.multires = int(c.get("multires", 0))
        if not (c.get("same_mlp") and c.get("roughness_mlp") and c.get("fix_specular_albedo")) \
                or int(c.get("num_base_materials", 1)) != 1 or c.get("white_light") \
                or c.get("upper_hemi") or c.get("use_normal", False):
            raise ValueError("the reference holds the shipped material net only")
        self.dims = [embed_dim(self.multires) + feature_size] + list(c["dims"]) + [4]
        self.shapes = layer_shapes(self.dims)
        self.layers = [Layer(f"envmap_material_network.diffuse_albedo_layers.{l}", False)
                       for l in range(len(self.shapes))]
        self.num_lgt_sgs = int(c["num_lgt_sgs"])
        self.specular = torch.tensor([float(s) for s in c["specular_albedo"]])

    def __call__(self, p: Params, pts, feats, fake_roughness=False, q=None):
        x = torch.cat([embed(pts, self.multires), feats], dim=-1)
        for l, layer in enumerate(self.layers):
            x = layer(p, x, q)
            if l < len(self.layers) - 1:
                x = F.elu(x)
        albedo = torch.sigmoid(x[:, :3])
        rough = (1 - TINY_ROUGHNESS) * torch.sigmoid(x[:, 3:4]) + TINY_ROUGHNESS
        if fake_roughness:
            rough = 0 * rough + 0.5
        spec = 0.16 * self.specular.to(pts)[None] ** 2
        return albedo, rough, spec


def _rounded(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """r in the forward, x's gradient in the backward (rounding is taken as
    the identity there, as a lower-precision product's backward sees it)."""
    return x + (r - x).detach()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away), as
    the tensor cores take a float32 product's inputs with TF32 on."""
    i = x.detach().contiguous().view(torch.int32)
    return _rounded(x, ((i + 0x1000) & -0x2000).view(torch.float32))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3, each row scaled into the type's range first
    (a per-row scale, as fp8 products are fed)."""
    amax = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    s = 448.0 / amax
    return _rounded(x, (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s)


PRECISIONS = {"tf32": tf32, "fp8": fp8}


# ---- the SG light -------------------------------------------------------------

def split_sg(lgt: torch.Tensor):
    xis = lgt[:, :3] / (torch.linalg.norm(lgt[:, :3], dim=-1, keepdim=True) + TINY)
    return xis, lgt[:, 3].abs(), lgt[:, 4:].abs()


def sg_eval(wi: torch.Tensor, lgt: torch.Tensor) -> torch.Tensor:
    xis, lam, mu = split_sg(lgt)
    return torch.exp((wi @ xis.t() - 1.0) * lam[None, :]) @ mu


def fibonacci_sphere(n: int) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64)
    y = 1 - i / (n - 1) * 2
    r = torch.sqrt(1 - y * y)
    th = math.pi * (3.0 - math.sqrt(5.0)) * i
    return torch.stack([torch.cos(th) * r, y, torch.sin(th) * r], -1).float()


def leaf_names(conf_model: Dict) -> Dict[str, List[str]]:
    """The leaves of each network, in the order the port holds them."""
    fs = int(conf_model["feature_vector_size"])
    sdf = SDFNet(conf_model["implicit_network"], fs)
    rnd = RenderNet(conf_model["rendering_network"], fs)
    mat = MaterialNet(conf_model["envmap_material_network"], fs)
    return {"sdf": [n for L in sdf.layers for n in L.leaves()],
            "render": [n for L in rnd.layers for n in L.leaves()],
            "material": [n for L in mat.layers for n in L.leaves()]
            + ["envmap_material_network.lgtSGs"]}
