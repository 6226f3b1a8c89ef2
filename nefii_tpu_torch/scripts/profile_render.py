"""Profile the port's novel-view render at the full width of a conf.

Writes a cam_dict_norm.json-only split of 1 + PROFILE_STEPS views
(SceneDataset.write_camera_only_split) and a checkpoint of the conf's seeded
geometric init in the JAX layout, then renders each view through
RenderRunner.render_view, without the EXR and PNG writes. The first view
warms up; the next PROFILE_STEPS run under torch.profiler: StepProfiler
(training/trainer.py) prints the device's busy time and idle share, the idle
after host syncs, the host syncs by site, the spans and the kernels a view,
and writes summary.txt and trace.json into --out. The
last line is a JSON summary of the profiled views.

    python -m nefii_tpu_torch.scripts.profile_render --out profile_render
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from nefii_tpu_torch.config import ConfigFactory
from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.scripts import render
from nefii_tpu_torch.scripts.profile_train import card_name
from nefii_tpu_torch.training.trainer import PROFILE_STEPS, StepProfiler
from nefii_tpu_torch.utils import checkpoints as ckpt


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", default="confs/conf.conf")
    parser.add_argument("--out", required=True, help="directory for summary.txt and trace.json")
    parser.add_argument("--res", type=int, default=128, help="pixels on a side of a view")
    parser.add_argument("--num_rays", type=int, default=16, help="anti-aliasing rays per pixel")
    parser.add_argument("--memory_capacity_level", type=int, default=18)
    parser.add_argument("--device", default="cuda")
    opt = parser.parse_args(argv)
    card = card_name(opt.device)

    n_views = 1 + PROFILE_STEPS
    with tempfile.TemporaryDirectory() as d:
        exp = os.path.join(d, "exp")
        model = IDRNetwork.from_conf(ConfigFactory.parse_file(opt.conf).get_config("model"),
                                     device=opt.device, seed=0)
        ckpt.save_collection(os.path.join(exp, "seed0", "checkpoints"), ckpt.MODEL, "latest",
                             ckpt.params_to_jax(model), {"epoch": 0})
        del model
        # the framing of chip_smoke.py's render: focal 160 px at 128 px
        scene = SceneDataset.write_camera_only_split(os.path.join(d, "scene"), n_views, opt.res,
                                                     focal=1.25 * opt.res)
        runner = render.RenderRunner(
            conf=opt.conf, data_split_dir=scene, old_expdir=exp, num_rays=opt.num_rays,
            memory_capacity_level=opt.memory_capacity_level, out_dir=os.path.join(d, "renders"),
            device=opt.device)
        prof = StepProfiler(os.path.abspath(opt.out), torch.device(opt.device))
        for i in range(n_views):
            runner.render_view(i)
            prof.step()
        prof.stop()
    timed = runner.stats[1:]
    summary = dict(
        card=card, res=opt.res, num_rays=opt.num_rays,
        s_per_view=[s["seconds"] for s in timed],
        mean_s_per_view=float(np.mean([s["seconds"] for s in timed])),
        sdf_evals=[s["sdf_evals"] for s in timed],
        hit_fraction=[s["hit_fraction"] for s in timed])
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
