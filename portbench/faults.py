"""Faults planted in the program underneath the timed path, each of which the
check has to call not correct: a step that leaves the state unchanged, half
of the batch left out of the loss (its mean taken over the rest), and an
answer altered where it is produced (the radiance net's colour, the SDF
kernel's value, a rendered pixel). The benchmark's runs never plant one;
the tests and `control.py --fault` do."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def state_unchanged():
    from nefii_tpu_torch.training import trainer

    return _patched(trainer.AdamGroup, "step", lambda orig: lambda self: None)


def half_batch():
    from nefii_tpu_torch.models import loss

    def make(orig):
        def call(self, out, gt, alpha=None, all_reduce=None):
            n = gt["rgb"].shape[1] // 2
            keep = {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) and v.dim() > 0
                        and v.shape[0] == 2 * n else v) for k, v in out.items()}
            return orig(self, keep, {"rgb": gt["rgb"][:, :n]}, alpha, all_reduce)
        return call

    return _patched(loss.IDRLoss, "__call__", make)


def radiance_altered():
    from nefii_tpu_torch.models import rendering

    return _patched(rendering.RenderingNetwork, "forward",
                    lambda orig: lambda self, *a, **k: orig(self, *a, **k) * 1.01)


def sdf_altered():
    """K1's value shifted by 0.02 where it is produced."""
    from nefii_tpu_torch.ops.kernels import fused_mlp

    return _patched(fused_mlp, "fused_sdf_value", lambda orig: lambda x, fw: orig(x, fw) + 0.02)


def pixel_altered():
    from nefii_tpu_torch.parallel import spmd

    def make(orig):
        def ev(model, batch, gen, keys):
            out = orig(model, batch, gen, keys)
            out["sg_rgb_values"] = out["sg_rgb_values"].clone()
            out["sg_rgb_values"][0] += 0.05
            return out
        return ev

    return _patched(spmd, "eval_forward", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "radiance_altered": radiance_altered, "sdf_altered": sdf_altered,
          "pixel_altered": pixel_altered}
