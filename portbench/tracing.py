"""The traced stretch: torch.profiler over a bounded part of the window,
read from its chrome trace.

Device work is every kernel, copy and set on the device timeline. The busy
time is the union of their intervals (overlapping work counted once); a
span's device time is, for each time the program entered the span on the
host, the extent from the first to the last device operation launched
inside it, summed.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.wall_s = 0.0

    def start(self, sync) -> None:
        import torch

        sync()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, sync) -> "Timeline":
        sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return Timeline(events, self.wall_s)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Timeline:
    """Device operations and host spans of one traced stretch (times in us)."""

    def __init__(self, events: List[Dict], wall_s: float):
        self.wall_s = wall_s
        self.ops: List[Tuple[float, float, str, int]] = []  # start, end, name, correlation
        self.launch_ts: Dict[int, float] = {}  # correlation -> host time of the launch
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0)), float(e.get("dur", 0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.ops.append((ts, ts + dur, e.get("name", ""), int(args.get("correlation", -1))))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                if "correlation" in args:
                    self.launch_ts[int(args["correlation"])] = ts
            elif cat == "user_annotation":
                self.spans[e.get("name", "")].append((ts, ts + dur))
        self.busy = _union([(a, b) for a, b, _, _ in self.ops])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_s(self, substring: str) -> Tuple[float, int]:
        """(device seconds, count) of the operations whose name holds `substring`."""
        sel = [b - a for a, b, n, _ in self.ops if substring in n]
        return sum(sel) / 1e6, len(sel)

    def span_device_s(self, name: str) -> Optional[float]:
        """The span's device time: for each of its host intervals, the
        extent of the device operations launched inside it."""
        iv = self.spans.get(name)
        if not iv:
            return None
        launched = sorted((self.launch_ts[c], a, b) for a, b, _, c in self.ops
                          if c in self.launch_ts)
        keys = [x[0] for x in launched]
        total, seen = 0.0, False
        for h0, h1 in _union(iv):
            lo, hi = bisect.bisect_left(keys, h0), bisect.bisect_right(keys, h1)
            if hi > lo:
                seen = True
                total += max(x[2] for x in launched[lo:hi]) - min(x[1] for x in launched[lo:hi])
        return total / 1e6 if seen else None

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps
        between device work summed by the innermost host span open at the
        gap's middle."""
        by_op: Dict[str, float] = defaultdict(float)
        for a, b, n, _ in self.ops:
            by_op[n[:96]] += (b - a) / 1e6
        flat = sorted((a, b, n) for n, iv in self.spans.items() for a, b in iv)
        gaps: Dict[str, float] = defaultdict(float)
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            mid = (e0 + s1) / 2
            inner = [(b - a, n) for a, b, n in flat if a <= mid <= b]
            gaps[min(inner)[1] if inner else "outside any span"] += (s1 - e0) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top]}
