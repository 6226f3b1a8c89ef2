"""The control of the check: the plain reference, computed in the nearest
precision below the one the configuration states, put in the program's
place. The configuration states bf16 for the SDF trace (fused_sdf_dtype)
and fp32 with TF32 off for the rest, so the control traces with the SDF
net's products in fp8 (e4m3, a scale a row) and shades, takes the loss,
the gradients and the updates with every product's inputs rounded to TF32.
The check has to call the control not correct.

    python3 portbench/control.py --workload nefii.train --seed 1 --seed 2 --seed 3

For each seed, one set-up and the steps or chunks a run follows (no
measured window), then one JSON line: the program's numbers and the
control's, each beside its limit. With --fault NAME (faults.FAULTS) the
program runs with that fault planted underneath the timed path instead, and
the line gives its numbers. The benchmark's own runs do not run it.
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

CONTROL = {"q": "tf32", "trace_q": "fp8"}


def fault_run(run, fault: str):
    from portbench import core
    from portbench.faults import FAULTS

    with FAULTS[fault]():
        out = core.driver(run.cell.traffic).run(run)
    return {"seed": run.seed, "workload": run.cell.name, "fault": fault,
            "numbers": {k: [v, lim] for k, (v, lim) in out.numbers.items()},
            "correct": core.correct(out.numbers)}


def control_run(run):
    from portbench import core
    from portbench.reference import nets as N

    run.control = {k: N.PRECISIONS[v] for k, v in CONTROL.items()}
    out = core.driver(run.cell.traffic).run(run)
    return {"seed": run.seed, "workload": run.cell.name,
            "program": {k: [v, lim] for k, (v, lim) in out.program_numbers.items()},
            "program_correct": core.correct(out.program_numbers),
            "control": {k: [v, lim] for k, (v, lim) in out.numbers.items()},
            "control_correct": core.correct(out.numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    import torch

    torch.set_num_threads(1)
    from portbench import core

    cell = core.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    for seed in args.seed:
        run = core.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device="cuda",
                       t0=time.perf_counter())
        line = fault_run(run, args.fault) if args.fault else control_run(run)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
