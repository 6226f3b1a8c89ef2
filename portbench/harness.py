"""Set-up shared by the traffic drivers: the configuration as the program
runs it, the seeds, the scene and the weights, and handing the weights to
the program's model."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import core, scene
from portbench.reference import nets as N

# The SDF net is fitted to the scene from this seed in every run: the
# geometry is the scene's, so the run's seed does not change how much
# tracing a run does.
FIT_SEED = 20261017
# Training: the iterations the reference follows, from the first of the run
# (a distillation iteration), and the distillation periods in the traced stretch.
CHECK_STEPS = 3
TRACE_PERIODS = 1


def workdir(cell_name: str) -> str:
    """The run's scratch directory under TMPDIR, at a fixed path."""
    d = os.path.join(tempfile.gettempdir(), "portbench", cell_name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def conf(run: core.Run):
    """The conf the configuration names, parsed by the program, with a CPU
    rehearsal's sizes put over it."""
    from nefii_tpu_torch.config import ConfigFactory

    c = ConfigFactory.parse_file(os.path.join(core.ROOT, run.cell.config["conf"]))
    for k, v in (run.tiny or {}).get("conf", {}).items():
        c.put(k, v)
    return c


def seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds drawn from the run's seed."""
    ss = np.random.SeedSequence(seed % (1 << 128))
    return [int(x) for x in ss.generate_state(n, np.uint64) & np.uint64((1 << 63) - 1)]


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_weights(conf_model: Dict, seed: int, p: Dict, device):
    """The weights: the radiance and material nets and the light at their
    initialisation drawn from the run's seed; the SDF net from its geometric
    initialisation fitted to the scene, both drawn from FIT_SEED."""
    P = scene.init_weights(conf_model, generator(device, seeds(seed, 1)[0]), device)
    g_fit = generator(device, FIT_SEED)
    geo = scene.init_weights(conf_model, g_fit, device)
    P.update({k: v for k, v in geo.items() if k.startswith("implicit_network.")})
    err = scene.fit_sdf(conf_model, P, g_fit, p["fit_steps"], p["fit_batch"], device)
    return P, err


def load_into(model, P: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's parameters; every
    leaf the reference knows must exist there with the same shape."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in P.items():
            if k not in params or params[k].shape != v.shape:
                raise RuntimeError(f"the program has no parameter {k} of shape {tuple(v.shape)}")
            params[k].copy_(v)


def images_as_loaded(split: Dict, gamma: float, device) -> List[torch.Tensor]:
    """The images as the dataset holds them: uint8 / 255, to the gamma."""
    return [torch.as_tensor((img.astype(np.float32) / 255.0) ** gamma, device=device)
            for img in split["images"]]


def moved(obj, device):
    """obj (tensors in dicts, lists and tuples) with every tensor on `device`:
    what the check keeps is held on the host while the window runs, so that
    it neither adds to the window's peak memory nor takes the card's."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(moved(v, device) for v in obj)
    return obj


def release() -> None:
    """Return the memory of what the caller deleted to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def clock() -> float:
    return time.perf_counter()


class Phases:
    """Set-up's parts on standard error, each with the seconds since the
    process started (where set-up goes; not a metric)."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"portbench set-up: {name} {now - self.last:.3f} s (at {now - self.t0:.3f} s)",
              file=sys.stderr, flush=True)
        self.last = now


def groups_of(runner, names: Dict[str, torch.nn.Parameter]) -> Dict[str, List[str]]:
    """The program's Adam groups as lists of parameter names."""
    by_id = {id(p): n for n, p in names.items()}
    return {g: [by_id[id(p)] for p in opt.params] for g, opt in runner.optimizers.items()}


def check_leaves(conf_model: Dict, groups: Dict[str, List[str]]) -> None:
    known = set(sum(N.leaf_names(conf_model).values(), []))
    for g, names in groups.items():
        for n in names:
            if n not in known:
                raise RuntimeError(f"the program trains {n}, which the reference does not hold")
