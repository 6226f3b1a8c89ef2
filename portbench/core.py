"""The harness's common parts: finding a cell, its configuration, its traffic
driver and the readers of its per-layer metrics by the names that
BENCHMARK.json gives them, the check that no JAX module was loaded, the
device line and the result line.

A cell is workloads/<cell>.json: its configuration, its traffic driver
(traffic/<driver>.py), the driver's parameters, its chips and the limits
of its check. A configuration is configs/<config>.json. A per-layer metric
is read by metrics/<metric>.py, or, for a name with a suffix after its
first dot (`trace_ms.render`), by metrics/<name before the dot>.py given
the suffix. New cells, configurations and metrics are new files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nefii_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: str
    params: Dict
    chips: int
    limits: Dict[str, float]


def cell(name: str, here: str = HERE) -> Cell:
    w = load_json(os.path.join(here, "workloads", f"{name}.json"))
    c = load_json(os.path.join(here, "configs", f"{w['config']}.json"))
    return Cell(name, c, w["traffic"], w.get("params", {}), int(w.get("chips", 1)),
                w.get("limits", {}))


def driver(traffic: str, here: str = HERE):
    return load_module(os.path.join(here, "traffic", f"{traffic}.py"), f"portbench_traffic_{traffic}")


def reader(metric: str, here: str = HERE) -> Tuple[Callable, str]:
    """-> (read(reading, suffix) -> value or None, suffix)."""
    path = os.path.join(here, "metrics", f"{metric}.py")
    suffix = ""
    if not os.path.exists(path):
        base, _, suffix = metric.partition(".")
        path = os.path.join(here, "metrics", f"{base}.py")
    mod = load_module(path, "portbench_metric_" + metric.replace(".", "_"))
    return mod.read, suffix


def metrics_for(bench: Dict, cell_name: str, trace: bool, reported_e2e: List[str]) -> List[Dict]:
    """The metrics a run of this cell reports: its end-to-end metrics, or,
    traced, the per-layer metrics that list it (or, listing no cells, move
    an end-to-end metric it reports)."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported_e2e)]


def loaded_forbidden() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """One run of a cell, as the command line gives it."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    tiny: Optional[Dict] = None  # sizes for a CPU rehearsal (tests only)
    t0: float = 0.0
    # the control: the reference in these precisions in the program's place
    control: Optional[Dict] = None


@dataclass
class Outcome:
    """What a traffic driver hands back."""
    e2e: Dict[str, float] = field(default_factory=dict)
    reading: Any = None           # the per-layer readers' input (traced runs)
    numbers: Dict[str, Tuple[float, float]] = field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None
    program_numbers: Optional[Dict[str, Tuple[float, float]]] = None  # a control run's


def device_line(run: Run, out: Outcome) -> Dict:
    import torch

    d = {"platform": "gpu" if run.device == "cuda" else "cpu",
         "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
         "count": run.cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if run.trace:
        d["busy_s"], d["window_s"] = out.busy_s, out.window_s
    return d


def correct(numbers: Dict[str, Tuple[float, float]]) -> bool:
    """Every number at or under its limit (a number that is not finite fails)."""
    return bool(numbers) and all(v == v and v <= lim for v, lim in numbers.values())
