"""Dataset index samplers (counterpart of nefii_tpu/utils/sampler.py).

Host-side index generators: `SamplerGivenSeq` (fixed test ids),
`SamplerRandomChoice` (seeded vis picks, numpy default_rng(seed + epoch) as
in the JAX package, so both draw the same ids), `SamplerFixIndex` (always
the same index — the infinite SDF stream).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class SamplerGivenSeq:
    def __init__(self, seq: Sequence[int]):
        self.seq = list(seq)

    def __iter__(self) -> Iterator[int]:
        return iter(self.seq)

    def __len__(self) -> int:
        return len(self.seq)


class SamplerRandomChoice:
    def __init__(self, dataset, num: int, seed: int = 0):
        self.n = len(dataset)
        self.num = num
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self._epoch)
        return iter(rng.choice(self.n, size=self.num, replace=False).tolist())

    def __len__(self) -> int:
        return self.num


class SamplerFixIndex:
    def __init__(self, length: int, index: int = 0):
        self.length = length
        self.index = index

    def __iter__(self) -> Iterator[int]:
        return iter([self.index] * self.length)

    def __len__(self) -> int:
        return self.length
