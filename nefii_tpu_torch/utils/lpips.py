"""LPIPS-alex in PyTorch for offline evaluation (counterpart of
nefii_tpu/utils/lpips_jax.py).

LPIPS (Zhang et al., CVPR 2018) unit-normalises the five post-ReLU AlexNet
feature maps of both images, takes their squared difference, weighs it with
learned 1x1 per-layer weights, averages over space and sums over layers.
The pretrained weights cannot be downloaded offline, so they come from a
path the user supplies (or $NEFII_LPIPS_WEIGHTS), in any of the JAX
package's layouts:

  * a torch checkpoint of the full `lpips.LPIPS(net="alex")` module
    (`net.slice*` + `lin*.model.1.weight` keys),
  * a directory holding a torchvision `alexnet` state dict (`features.*`
    keys) plus the lpips linear-head file (`lin*.model.1.weight` keys),
  * or an `.npz` with the canonical keys `save_npz` writes.

The network runs on the given device through torch.nn.functional.conv2d
and max_pool2d. `python -m nefii_tpu_torch.utils.lpips --export-from-torch
out.npz [SRC...]` writes the canonical `.npz` (`_export_main`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Torchvision AlexNet feature stack (conv params: out_ch, kernel, stride, pad)
# with ReLU after every conv; 3x3/2 max-pools after conv1 and conv2. LPIPS
# taps the five post-ReLU feature maps.
_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # max-pool follows conv index 0 and 1
# lpips.ScalingLayer constants (inputs in [-1, 1])
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)
# torchvision layer indices of the convs inside `features`, used both by
# `features.{i}.weight` checkpoints and lpips `net.slice{k}.{i}.weight` keys
_TV_IDX = (0, 3, 6, 8, 10)


def _canon_from_torch_state(state) -> Dict[str, np.ndarray]:
    """Accepts a full-LPIPS, torchvision-alexnet, or lins-only state dict
    (tensors or arrays); returns whatever canonical entries it holds."""
    out: Dict[str, np.ndarray] = {}

    def to_np(v):
        return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32)

    for k, v in state.items():
        base = k.split("module.", 1)[-1]
        for ci, tv in enumerate(_TV_IDX):
            for attr in ("weight", "bias"):
                if base.endswith(f"slice{ci + 1}.{tv}.{attr}") or \
                        base == f"features.{tv}.{attr}":
                    out[f"conv{ci}_{attr[0]}"] = to_np(v)
        for li in range(5):
            if base == f"lin{li}.model.1.weight" or \
                    base.endswith(f"lins.{li}.model.1.weight"):
                out[f"lin{li}"] = to_np(v).reshape(-1)
    return out


def _missing_keys(canon: Dict[str, np.ndarray]) -> list:
    return [k for k in
            [f"conv{i}_{a}" for i in range(5) for a in "wb"]
            + [f"lin{i}" for i in range(5)]
            if k not in canon]


def _collect_partial(path: str) -> Dict[str, np.ndarray]:
    """The canonical entries of one file, or of every .pth/.pt/.npz file of a
    directory (a backbone and the lin heads may sit in separate files)."""
    canon: Dict[str, np.ndarray] = {}
    files = ([os.path.join(path, f) for f in sorted(os.listdir(path))
              if f.endswith((".pth", ".pt", ".npz"))]
             if os.path.isdir(path) else [path])
    for f in files:
        if f.endswith(".npz"):
            with np.load(f) as z:
                canon.update({k: np.asarray(z[k], np.float32) for k in z.files})
        else:
            state = torch.load(f, map_location="cpu", weights_only=True)
            if hasattr(state, "state_dict"):
                state = state.state_dict()
            canon.update(_canon_from_torch_state(state))
    return canon


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """Load LPIPS-alex weights from `path` (see module docstring)."""
    canon = _collect_partial(path)
    missing = _missing_keys(canon)
    if missing:
        raise ValueError(
            f"LPIPS weights at {path!r} are incomplete: missing {missing}. "
            "Provide a full lpips.LPIPS state dict, or a directory with a "
            "torchvision alexnet state dict plus the lpips lin-head file."
        )
    for i, (c_out, k, _, _) in enumerate(_CONVS):
        w = canon[f"conv{i}_w"]
        if w.shape[0] != c_out or w.shape[-1] != k:
            raise ValueError(
                f"conv{i} weight shape {w.shape} does not match AlexNet "
                f"({c_out} out-channels, {k}x{k} kernel)"
            )
    return canon


def save_npz(weights: Dict[str, np.ndarray], path: str) -> None:
    np.savez(path, **weights)


class LPIPS(nn.Module):
    """The AlexNet feature stack and the LPIPS head, with fixed weights."""

    def __init__(self, weights: Dict[str, np.ndarray], device=None):
        super().__init__()
        for k, v in weights.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32), device=device))
        self.register_buffer("shift", torch.as_tensor(_SHIFT, device=device))
        self.register_buffer("scale", torch.as_tensor(_SCALE, device=device))

    def features(self, x: torch.Tensor):
        """x: [N,3,H,W] in [-1,1] -> the 5 post-ReLU feature maps."""
        x = (x - self.shift[:, None, None]) / self.scale[:, None, None]
        feats = []
        for i, (_, _, stride, pad) in enumerate(_CONVS):
            x = F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                         stride=stride, padding=pad)
            x = torch.clamp_min(x, 0.0)
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: [N,3,H,W] in [-1,1] -> LPIPS distances [N]."""
        total = 0.0
        for i, (x, y) in enumerate(zip(self.features(a), self.features(b))):
            nx = x * ((x * x).sum(1, keepdim=True) ** 0.5 + 1e-10) ** -1
            ny = y * ((y * y).sum(1, keepdim=True) ** 0.5 + 1e-10) ** -1
            d = (nx - ny) ** 2
            lin = getattr(self, f"lin{i}")
            total = total + (d * lin[None, :, None, None]).sum(1).mean((-2, -1))
        return total


@torch.no_grad()
def lpips_distance(net: LPIPS, pred: np.ndarray, gt: np.ndarray) -> float:
    """LPIPS-alex distance between HWC float images in [0, 1], on net's device."""
    dev = net.shift.device
    a = torch.as_tensor(np.asarray(pred, np.float32), device=dev).permute(2, 0, 1)[None] * 2 - 1
    b = torch.as_tensor(np.asarray(gt, np.float32), device=dev).permute(2, 0, 1)[None] * 2 - 1
    return float(net(a, b)[0])


def load_model(weights_path: Optional[str], *, device) -> LPIPS:
    """The LPIPS net on `device` with the weights at weights_path or
    $NEFII_LPIPS_WEIGHTS. FileNotFoundError: no path was given at all;
    RuntimeError: the path given is missing or its weights do not load."""
    wp = weights_path or os.environ.get("NEFII_LPIPS_WEIGHTS")
    if not wp:
        raise FileNotFoundError("no LPIPS weights path given")
    try:
        weights = load_weights(wp)
    except FileNotFoundError as e:
        # a path the user gave that does not exist, not the no-path case above
        raise RuntimeError(f"LPIPS weights path not found: {wp}") from e
    except Exception as e:  # reported as the reason LPIPS is unavailable
        raise RuntimeError(f"LPIPS weights failed to load: {e}") from e
    return LPIPS(weights, device)


def lpips_from_path(pred: np.ndarray, gt: np.ndarray, weights_path: Optional[str], *,
                    device) -> float:
    net = load_model(weights_path, device=device)
    try:
        return lpips_distance(net, pred, gt)
    except Exception as e:  # reported as the reason LPIPS is unavailable
        raise RuntimeError(f"LPIPS computation failed: {e}") from e


def _export_main(argv) -> int:
    """Write the canonical LPIPS-alex `.npz`:

        python -m nefii_tpu_torch.utils.lpips --export-from-torch out.npz
        python -m nefii_tpu_torch.utils.lpips --export-from-torch out.npz SRC...

    With SRC paths (.pth/.pt/.npz files or a directory; e.g. a torchvision
    alexnet state dict plus the lpips repo's `weights/v0.1/alex.pth` lin
    heads) it merges and converts those. With none it exports the state dict
    of the installed `lpips` package's `LPIPS(net='alex')`, which downloads
    its weights on first use. Then point evaluate.py at the npz through
    --lpips_weights or NEFII_LPIPS_WEIGHTS.
    """
    import argparse

    ap = argparse.ArgumentParser(prog="nefii_tpu_torch.utils.lpips")
    ap.add_argument("--export-from-torch", metavar="OUT_NPZ", required=True)
    ap.add_argument("sources", nargs="*",
                    help=".pth/.pt/.npz file(s) or a directory; default: "
                         "the installed `lpips` package (needs egress on "
                         "first use)")
    ns = ap.parse_args(argv)

    if ns.sources:
        canon: Dict[str, np.ndarray] = {}
        for src in ns.sources:
            canon.update(_collect_partial(src))
        weights = _finalize(canon)
    else:
        try:
            import lpips  # type: ignore
        except ImportError:
            print("error: the `lpips` package is not installed and no "
                  "source paths were given.\n  pip install lpips   # then "
                  "re-run (downloads AlexNet + lin weights on first use)")
            return 2
        model = lpips.LPIPS(net="alex")
        weights = _finalize(_canon_from_torch_state(model.state_dict()))

    save_npz(weights, ns.export_from_torch)
    # the export loads through the same gate evaluate.py uses
    load_weights(ns.export_from_torch)
    print(f"wrote {ns.export_from_torch} "
          f"({sum(v.size for v in weights.values())} params, verified "
          "loadable). Use: evaluate.py --lpips_weights "
          f"{ns.export_from_torch}  (or NEFII_LPIPS_WEIGHTS=...)")
    return 0


def _finalize(canon: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    missing = _missing_keys(canon)
    if missing:
        raise SystemExit(f"export incomplete: missing {missing} — supply a "
                         "full lpips.LPIPS state dict, or a torchvision "
                         "alexnet checkpoint plus the lin-head file")
    return canon


if __name__ == "__main__":
    import sys

    raise SystemExit(_export_main(sys.argv[1:]))
