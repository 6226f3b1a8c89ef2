"""Value/gradient watch registry (counterpart of nefii_tpu/utils/debug_helper.py).

Off unless `set_debug(True)`. `watch_value` records a tensor's mean, absmax
and has_nan under "<name>/value"; `watch_gradient` returns the tensor
through an identity autograd.Function whose backward records the same
statistics of the incoming gradient under "<name>/grad" (the JAX module's
jax.debug.callback and custom_vjp). A NaN is also printed.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_DEBUG = False
_RECORDS: Dict[str, Any] = {}


def set_debug(state: bool) -> None:
    global _DEBUG
    _DEBUG = state


def get_records() -> Dict[str, Any]:
    return dict(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


def _record(name: str, kind: str, x: torch.Tensor) -> None:
    x = x.detach()
    # one transfer for the three statistics
    mean, amax, has_nan = torch.stack(
        [x.mean(), x.abs().max(), x.isnan().any().to(x.dtype)]).tolist()
    _RECORDS[f"{name}/{kind}"] = {"mean": float(mean), "absmax": float(amax),
                                  "has_nan": bool(has_nan)}
    if has_nan:
        print(f"[debug_helper] NaN detected in {kind} of {name!r}")


def watch_value(x: torch.Tensor, name: str) -> torch.Tensor:
    """Record value statistics (no-op unless debugging is on)."""
    if _DEBUG:
        _record(name, "value", x)
    return x


class _WatchGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.name, "grad", g)
        return g, None


def watch_gradient(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity whose backward pass records cotangent statistics."""
    if not _DEBUG:
        return x
    return _WatchGradient.apply(x, name)


# the reference's spelling
watch_gradiant = watch_gradient
