"""Conf class resolution for the port (counterpart of
nefii_tpu/config/registry.py).

Confs name their classes by the reference's dotted paths
(`train.model_class = model.implicit_differentiable_renderer.IDRNetwork`).
This table maps them to the port's own classes.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

_ALIASES: Dict[str, str] = {
    "datasets.scene_dataset.SceneDataset": "nefii_tpu_torch.datasets.scene_dataset.SceneDataset",
    "datasets.sdf_dataset.SDFDataset": "nefii_tpu_torch.datasets.sdf_dataset.SDFDataset",
    "model.implicit_differentiable_renderer.IDRNetwork": "nefii_tpu_torch.models.idr.IDRNetwork",
    "model.loss.IDRLoss": "nefii_tpu_torch.models.loss.IDRLoss",
}


def get_class(kls: str) -> Any:
    """Resolve a conf's dotted class path (or one of its aliases) to a class of the port."""
    kls = _ALIASES.get(kls, kls)
    if not kls.startswith("nefii_tpu_torch."):
        raise ValueError(f"{kls!r} is not a class of the port")
    module_name, attr = kls.rsplit(".", 1)
    return getattr(importlib.import_module(module_name), attr)
