"""The weight bridge between the JAX package's checkpoints and port models
(counterpart of nefii_tpu/utils/checkpoints.py).

The JAX package stores each collection as a flat `.npz` keyed by pytree
paths, `<ckpt>/ModelParameters/<tag>.npz` with keys like
`implicit_network/layers/0/v` and `__extra__/epoch`. Port parameters carry
the same paths with dots (`implicit_network.layers.0.v`), so the mapping is
a key rewrite. numpy alone reads and writes the files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

MODEL = "ModelParameters"


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
