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
