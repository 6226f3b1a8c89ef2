"""Spans and host-sync counters of the port's hot path, on the one
torch.profiler timeline.

`span(name)` marks a stretch of host code as a `record_function` span while
a profiler records, and otherwise costs one check of the profiler's flag: an
idle `record_function` still costs an operator call. `host_sync(site)` wraps
one host read of a device value (`nonzero`, `.item()` and the casts that
call it, `.tolist()`, a copy to the host) or one copy from pageable host
memory to the device, which waits for the device's queue just as a read
does. It always adds one to the site's count in this process, and while a
profiler records it also opens the span `host_sync.<site>`, so that the
trace shows where the host waited and the device idled after it.

Sites are named `<module>.<what>` (`tracer.live_any`, `pool.count`), and
`step_end` is the synchronise that ends a training step. `sync_counts()` is
a copy of the counts by site; the difference of two copies is what ran
between them.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import record_function

SYNC_PREFIX = "host_sync."

_profiling = torch._C._autograd._profiler_enabled
_counts: Dict[str, int] = defaultdict(int)
# the shared context of every span while no profiler records
_IDLE = contextlib.nullcontext()


def span(name: str):
    """The span `name` while a profiler records, else a shared no-op."""
    return record_function(name) if _profiling() else _IDLE


def host_sync(site: str):
    """Count one host sync at `site`; while a profiler records, also the
    span `host_sync.<site>` around it."""
    _counts[site] += 1
    return record_function(SYNC_PREFIX + site) if _profiling() else _IDLE


def sync_counts() -> Dict[str, int]:
    """A copy of this process's host syncs by site."""
    return dict(_counts)


def reset_sync_counts() -> None:
    _counts.clear()


def sync_total() -> int:
    """This process's host syncs at every site."""
    return sum(_counts.values())
