"""Faults for the cells of live geometry, planted in the program underneath
the timed path, each of which the check has to call not correct: the eikonal
term dropped from the loss, and the SDF net's input gradient (the normals,
the eikonal term and IDR eq. 3's denominator) scaled by 1.01 where it is
produced; with faults.py's state left unchanged and half the batch.

    python3 portbench/faults_live.py --workload physg.train --fault eikonal_dropped \\
        --seed 1 --seed 2 --seed 3

For each seed, one set-up and the iterations the check follows (no measured
window), then one JSON line: the numbers, each beside its limit, and whether
they are correct. The benchmark's own runs never plant a fault.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults  # noqa: E402


def eikonal_dropped():
    from nefii_tpu_torch.models import loss

    return faults._patched(loss.IDRLoss, "get_eikonal_loss",
                           lambda orig: lambda self, g, all_reduce=None:
                           0.0 * orig(self, g, all_reduce))


def sdf_grad_scaled():
    from nefii_tpu_torch.models import implicit

    return faults._patched(implicit.ImplicitNetwork, "_sdf_input_grad",
                           lambda orig: lambda self, *a: orig(self, *a) * 1.01)


FAULTS = {"state_unchanged": faults.state_unchanged, "half_batch": faults.half_batch,
          "eikonal_dropped": eikonal_dropped, "sdf_grad_scaled": sdf_grad_scaled}


def fault_run(run, fault: str):
    from portbench import core

    out = core.driver(run.cell.traffic).run(run, fault=fault)
    return {"seed": run.seed, "workload": run.cell.name, "fault": fault,
            "numbers": {k: [v, lim] for k, (v, lim) in out.numbers.items()},
            "correct": core.correct(out.numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args = ap.parse_args(argv)

    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    import torch

    torch.set_num_threads(1)
    from portbench import core

    cell = core.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"faults_live: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    for seed in args.seed:
        run = core.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device="cuda",
                       t0=time.perf_counter())
        print(json.dumps(fault_run(run, args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
