"""Profile Step-2 training of the port at the full width of a conf.

Writes a synthetic 4-view 128x128 sphere scene (datasets/synthetic.py) and a
checkpoint of the conf's seeded geometric init in the JAX layout, then trains
four steps through nefii_tpu_torch.training.exp_runner.main with
--freeze_geometry and a distillation step after each. Steps 1-3 run under
torch.profiler: StepProfiler (training/trainer.py) prints the device's busy
time and idle share, the idle after host syncs, the host syncs by site, the
spans and the kernels, and writes summary.txt and trace.json into --out. The last line is a JSON summary of the timed steps.

    python -m nefii_tpu_torch.scripts.profile_train --out profile_out
    python -m nefii_tpu_torch.scripts.profile_train --out profile_k1 --no_fused_trace

The conf's use_fused_trace is switched on (K3) unless --no_fused_trace is
given, and its plot and validation passes are switched off.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from nefii_tpu_torch.config import parse_string
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.training import exp_runner
from nefii_tpu_torch.utils import checkpoints as ckpt

VIEWS, RES, MAX_NITER = 4, 128, 3


def conf_text(path: str, fused_trace: bool) -> str:
    with open(path) as f:
        text = f.read()
    replace = [("plot_freq = 1000", "plot_freq = 0"), ("val_freq = 1000", "val_freq = 0")]
    if fused_trace:
        replace.append(("use_fused_sdf = True", "use_fused_sdf = True\n    use_fused_trace = True"))
    for old, new in replace:
        if old not in text:
            raise RuntimeError(f"{path} does not hold {old!r}")
        text = text.replace(old, new, 1)
    return text


def card_name(device: str) -> str:
    """The card's `name, power.limit` as nvidia-smi prints them, printed on a
    line of its own ("" on the CPU)."""
    if device != "cuda":
        return ""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", default="confs/conf.conf")
    parser.add_argument("--out", required=True, help="directory for summary.txt and trace.json")
    parser.add_argument("--no_fused_trace", action="store_true",
                        help="trace through the gathered tracer (K1) instead of K3")
    parser.add_argument("--device", default="cuda")
    opt = parser.parse_args(argv)
    card = card_name(opt.device)

    text = conf_text(opt.conf, not opt.no_fused_trace)
    with tempfile.TemporaryDirectory() as d:
        conf_path = os.path.join(d, "train.conf")
        with open(conf_path, "w") as f:
            f.write(text)
        scene = write_sphere_scene(os.path.join(d, "scene"), VIEWS, RES)
        geo_dir = os.path.join(d, "geometry", "checkpoints")
        model = IDRNetwork.from_conf(parse_string(text).get_config("model"), device=opt.device,
                                     seed=0)
        ckpt.save_collection(geo_dir, ckpt.MODEL, "latest", ckpt.params_to_jax(model),
                             {"epoch": 0})
        del model
        runner = exp_runner.main([
            "--conf", conf_path, "--data_split_dir", scene, "--freeze_geometry",
            "--geometry", geo_dir, "--exps_folder_name", os.path.join(d, "exps"),
            "--roughness_warmup", "2", "--secondary_train_interval", "1",
            "--secondary_batch_size", "1024", "--max_niter", str(MAX_NITER),
            "--profile_dir", os.path.abspath(opt.out), "--device", opt.device])
    timed = runner.step_stats[1:]
    summary = dict(
        use_fused_trace=not opt.no_fused_trace, card=card,
        s_per_step=[s["seconds"] for s in timed],
        secondary_s=[s["secondary_seconds"] for s in timed],
        rays_per_step=timed[0]["rays"],
        mean_s_per_step=float(np.mean([s["seconds"] for s in timed])),
        mean_secondary_s=float(np.mean([s["secondary_seconds"] for s in timed])),
        max_memory_allocated=(torch.cuda.max_memory_allocated()
                              if opt.device == "cuda" else None))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
