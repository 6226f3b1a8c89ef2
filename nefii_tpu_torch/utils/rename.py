"""Batch-rename ground-truth decomposition files (counterpart of
nefii_tpu/utils/rename.py).

Normalises filenames like `000123_sp_rgb.01.exr` to the `.00.` suffix the
evaluator expects.

    python -m nefii_tpu_torch.utils.rename <dir> [--suffix 00] [--apply]
"""

from __future__ import annotations

import argparse
import os


def rename_suffix(path: str, suffix: str = "00", apply: bool = False):
    ops = []
    for f in sorted(os.listdir(path)):
        parts = f.split(".")
        if len(parts) < 3:
            continue
        parts[-2] = suffix
        new = ".".join(parts)
        if new != f:
            ops.append((f, new))
            if apply:
                os.rename(os.path.join(path, f), os.path.join(path, new))
    return ops


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--suffix", default="00")
    p.add_argument("--apply", action="store_true", help="actually rename (default: dry run)")
    args = p.parse_args(argv)
    for old, new in rename_suffix(args.path, args.suffix, args.apply):
        print(f"{'mv' if args.apply else 'would mv'} {old} -> {new}")


if __name__ == "__main__":
    main()
