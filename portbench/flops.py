"""Operations, bytes and peaks: the yardstick of the rooflines and of mfu.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (dense): FP32
outside the tensor cores, bf16 on the tensor cores, HBM3. A kernel's bound is
the larger of its operations over the peak of their type and the bytes it
must move over the memory rate; every input byte read once, every output
byte written once, the weights once a launch.

`KernelRows` counts the rows each launch of the port's K1 and K2 entries was
given (a wrapper around the Python entry points, on while a traced stretch
runs); the rooflines sum each launch's bound over its rows.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    """The least seconds for `flops` operations of `kind` and `nbytes` bytes."""
    return max(flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES)


def chain_flops(shapes: List[Tuple[int, int]]) -> Tuple[int, int]:
    """Operations per point (2 per multiply-add) of an SDF net's hidden
    chain, its layers (d_in, d_out) but the last, at their real widths, and
    of its sdf column."""
    hidden = sum(2 * a * b for a, b in shapes[:-1])
    return hidden, 2 * shapes[-1][0]


def mlp_flops(shapes: List[Tuple[int, int]]) -> int:
    return sum(2 * a * b for a, b in shapes)


def k1_bf16_bound_s(rows: int, shapes, sdf_entry: bool = True) -> float:
    """K1 in bf16: the hidden chain (and the sdf column in the sdf entry),
    the embedded points read in bf16, sdf [rows] fp32 or h [rows, width]
    bf16 written, the chain's weights in bf16."""
    hidden, col = chain_flops(shapes)
    emb, width = shapes[0][0], shapes[-1][0]
    weights = sum(a * b for a, b in shapes[:-1]) * 2
    if sdf_entry:
        return bound_s(rows * (hidden + col), rows * (emb * 2 + 4) + weights, "bf16")
    return bound_s(rows * hidden, rows * (emb + width) * 2 + weights, "bf16")


def k2_bound_s(rows: int, shapes) -> float:
    """K2 in split bf16: the forward chain and the input-gradient chain,
    three bf16 products a multiply-add; the embedded points read and h and
    d sdf / dx written in fp32, the weights' two bf16 halves of both passes."""
    hidden, _ = chain_flops(shapes)
    emb, width = shapes[0][0], shapes[-1][0]
    weights = sum(a * b for a, b in shapes[:-1]) * 2 * 2 * 2
    return bound_s(rows * 2 * hidden * 3, rows * (2 * emb + width) * 4 + weights, "bf16")


class KernelRows:
    """Wraps fused_mlp's K1 and K2 entries while installed; records, for
    each call that launches a kernel, (entry, rows, dtype)."""

    ENTRIES = ("fused_sdf_value", "fused_hidden", "fused_fwd_bwd")

    def __init__(self, fused_mlp_module):
        self.fm = fused_mlp_module
        self.calls: List[Tuple[str, int, str]] = []
        self._orig: Dict[str, object] = {}

    def __enter__(self):
        for name in self.ENTRIES:
            orig = getattr(self.fm, name)
            self._orig[name] = orig

            def wrapped(x, fw, _orig=orig, _name=name):
                if x.device.type == "cuda" and x.shape[0] > 0:
                    self.calls.append((_name, int(x.shape[0]), str(fw.dtype).split(".")[-1]))
                return _orig(x, fw)

            setattr(self.fm, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.fm, name, orig)
        self._orig.clear()
        return False

    def bound_s(self, kernel: str, shapes) -> Tuple[float, int]:
        """(summed bound seconds, launches) of "k1_bf16" or "k2"."""
        total, n = 0.0, 0
        for name, rows, dtype in self.calls:
            if kernel == "k1_bf16" and name != "fused_fwd_bwd" and dtype == "bfloat16":
                total += k1_bf16_bound_s(rows, shapes, name == "fused_sdf_value")
            elif kernel == "k2" and name == "fused_fwd_bwd":
                total += k2_bound_s(rows, shapes)
            else:
                continue
            n += 1
        return total, n
