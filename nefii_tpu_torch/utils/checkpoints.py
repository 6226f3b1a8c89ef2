"""The weight bridge between the JAX package's checkpoints and port models
(counterpart of nefii_tpu/utils/checkpoints.py).

The JAX package stores each collection as a flat `.npz` keyed by pytree
paths, `<ckpt>/ModelParameters/<tag>.npz` with keys like
`implicit_network/layers/0/v` and `__extra__/epoch`. Port parameters carry
the same paths with dots (`implicit_network.layers.0.v`), so the mapping is
a key rewrite. numpy alone reads and writes the files. A port training
checkpoint adds the scheduler collections of the JAX layout and keeps the
Adam states, which have no JAX layout, in its own `TorchOptimizerParameters`
files.

The torch imports (`import_torch_implicit`, `import_torch_idr`) read the
reference implementation's state dicts (`lin<i>.weight_g/weight_v/bias` or
`lin<i>.weight/bias`, Sequential material MLPs, DDP's `module.` prefix, a
NeuS `sdf_network_fine`) into the same flat layout, in numpy, and load it
with params_from_jax.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

MODEL = "ModelParameters"
IDR_SCHED = "IDRSchedulerParameters"
SG_SCHED = "SGSchedulerParameters"
TORCH_OPT = "TorchOptimizerParameters"


def params_from_jax(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Load a JAX flat layout {"a/b/0/v": array} into `model` (strict: every
    parameter must be present with the same shape)."""
    state = {k.replace("/", "."): torch.from_numpy(np.array(v)) for k, v in flat.items()
             if not k.startswith("__extra__/")}
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"checkpoint/model mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {tuple(v.shape)} vs "
                             f"model {tuple(own[k].shape)}")
    model.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()})
    return model


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of params_from_jax: {"a/b/0/v": float32 array}."""
    return {k.replace(".", "/"): v.detach().cpu().numpy().astype(np.float32)
            for k, v in model.state_dict().items()}


def save_collection(ckpt_dir: str, collection: str, tag, flat: Dict[str, np.ndarray],
                    extra: Optional[Dict] = None) -> str:
    d = os.path.join(ckpt_dir, collection)
    os.makedirs(d, exist_ok=True)
    flat = dict(flat)
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    path = os.path.join(d, f"{tag}.npz")
    np.savez(path + ".tmp.npz", **flat)
    os.replace(path + ".tmp.npz", path)
    return path


def load_collection(ckpt_dir: str, collection: str, tag) -> Tuple[Dict[str, np.ndarray], Dict]:
    """-> (flat params, extras) of <ckpt_dir>/<collection>/<tag>.npz."""
    path = os.path.join(ckpt_dir, collection, f"{tag}.npz")
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    extra = {k.split("/", 1)[1]: flat.pop(k) for k in list(flat) if k.startswith("__extra__/")}
    return flat, extra


def restore_subtree(model: nn.Module, ckpt_dir: str, tag, subtree: str) -> nn.Module:
    """Load only the submodule at path `subtree` ("implicit_network",
    "envmap_material_network/diffuse_albedo_layers") from a JAX-layout
    checkpoint (the geometry-only `--geometry <dir>` load); strict within it."""
    flat, _ = load_collection(ckpt_dir, MODEL, tag)
    prefix = subtree + "/"
    sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if not sub:
        raise KeyError(f"{ckpt_dir}: no {subtree} parameters under tag {tag!r}")
    params_from_jax(model.get_submodule(subtree.replace("/", ".")), sub)
    return model


def save_all(ckpt_dir: str, epoch: int, model: nn.Module, optimizers: Dict, cur_iter: int) -> None:
    """Write a training checkpoint under the tags <epoch> and `latest`: the
    parameters and the scheduler counters in the JAX package's layout (both
    render CLIs and `load_collection` of either package read them), the
    optimizer states (`{name: state}`) in the port's own TORCH_OPT file."""
    params = params_to_jax(model)
    for tag in (str(epoch), "latest"):
        save_collection(ckpt_dir, MODEL, tag, params, {"epoch": epoch})
        for sched in (IDR_SCHED, SG_SCHED):
            save_collection(ckpt_dir, sched, tag, {}, {"epoch": epoch, "cur_iter": cur_iter})
        d = os.path.join(ckpt_dir, TORCH_OPT)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{tag}.pt")
        torch.save({"epoch": epoch, "cur_iter": cur_iter, "optimizers": optimizers},
                   path + ".tmp")
        os.replace(path + ".tmp", path)


def load_all(ckpt_dir: str, tag, model: nn.Module) -> Tuple[Dict, int, int]:
    """Restore what save_all wrote into `model` -> (optimizer states, epoch, cur_iter)."""
    flat, extra = load_collection(ckpt_dir, MODEL, tag)
    params_from_jax(model, flat)
    state = torch.load(os.path.join(ckpt_dir, TORCH_OPT, f"{tag}.pt"), map_location="cpu",
                       weights_only=True)
    return state["optimizers"], int(extra.get("epoch", state["epoch"])), int(state["cur_iter"])


# ---------------------------------------------------------------------------
# torch checkpoint imports: reference geometry and NeuS state dicts
# ---------------------------------------------------------------------------

def _as_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float32)


def _torch_linear_to_ours(prefix: str, state: Dict, weight_norm: bool) -> Dict[str, np.ndarray]:
    """One torch Linear of `state` at `prefix` -> the leaves of a port Linear:
    {g, v, b} from a weight-normed one (weight_g, weight_v) where the port's
    layer is weight-normed, else {w, b} from a plain `weight` (a layer whose
    leaves then differ from the model's fails params_from_jax's check)."""
    if weight_norm and (prefix + "weight_g") in state:
        return {"g": _as_np(state[prefix + "weight_g"]), "v": _as_np(state[prefix + "weight_v"]),
                "b": _as_np(state[prefix + "bias"])}
    return {"w": _as_np(state[prefix + "weight"]), "b": _as_np(state[prefix + "bias"])}


def _set_linears(flat: Dict[str, np.ndarray], head: str, layers: nn.ModuleList, state: Dict,
                 prefix: str) -> None:
    """Replace the leaves `<head>/<i>/*` of `layers` in `flat` by the torch
    Linears `<prefix>lin<i>.` of `state`."""
    for i, layer in enumerate(layers):
        for k in [k for k in flat if k.startswith(f"{head}/{i}/")]:
            del flat[k]
        for leaf, v in _torch_linear_to_ours(f"{prefix}lin{i}.", state, layer.weight_norm).items():
            flat[f"{head}/{i}/{leaf}"] = v


def import_torch_implicit(model: nn.Module, path: str, *,
                          module_prefix: str = "implicit_network.",
                          state_key: str = "model_state_dict") -> nn.Module:
    """Load a torch ImplicitNetwork's state dict from the `.pth` at `path` into
    model.implicit_network: the reference's geometry checkpoint (`state_key`
    "model_state_dict", `lin<i>` under "implicit_network.") or a NeuS one
    (`state_key` "sdf_network_fine", `module_prefix` ""). A file without
    `state_key` is the state dict itself."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt[state_key] if state_key and state_key in ckpt else ckpt
    imp = model.implicit_network
    for i in range(len(imp.layers)):
        prefix = f"{module_prefix}lin{i}."
        if prefix + "weight_v" not in state and prefix + "weight" not in state:
            raise KeyError(f"missing layer {prefix}* in torch checkpoint {path}")
    flat = {k.split("/", 1)[1]: v for k, v in params_to_jax(model).items()
            if k.startswith("implicit_network/")}
    _set_linears(flat, "layers", imp.layers, state, module_prefix)
    params_from_jax(imp, flat)
    return model


def import_torch_idr(model: nn.Module, state: Dict) -> nn.Module:
    """Load a whole reference IDRNetwork state dict (`model_state_dict`, or a
    model's state_dict(), with or without DDP's `module.` prefix) into
    `model`: the `lin<i>` stacks of the implicit and rendering nets, the
    material net's Sequential MLPs mapped positionally (a Sequential counts
    its activations, so its Linears sit at 0, 2, 4, ...) and its direct
    tensors (lgtSGs, specular_reflectance, roughness) where the state has
    them. What the state lacks keeps its value."""
    state = {k[7:] if k.startswith("module.") else k: v for k, v in state.items()}
    flat = params_to_jax(model)
    for net in ("implicit_network", "rendering_network"):
        _set_linears(flat, f"{net}/layers", getattr(model, net).layers, state, f"{net}.")
    em = model.envmap_material_network
    mprefix = "envmap_material_network."
    for key, mod in em.named_children():
        if not isinstance(mod, nn.ModuleList):
            continue
        head = f"{mprefix}{key}."
        idxs = sorted({int(k[len(head):].split(".")[0]) for k in state
                       if k.startswith(head) and k.endswith(".weight")})
        if len(idxs) != len(mod):
            raise KeyError(f"{mprefix}{key}: {len(idxs)} torch Linears vs {len(mod)} of ours")
        for n, j in enumerate(idxs):
            flat[f"envmap_material_network/{key}/{n}/w"] = _as_np(state[f"{head}{j}.weight"])
            flat[f"envmap_material_network/{key}/{n}/b"] = _as_np(state[f"{head}{j}.bias"])
    for key, _ in em.named_parameters(recurse=False):
        if mprefix + key in state:
            flat[f"envmap_material_network/{key}"] = _as_np(state[mprefix + key])
    return params_from_jax(model, flat)
