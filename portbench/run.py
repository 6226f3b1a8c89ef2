"""Run one cell of the benchmark of nefii_tpu_torch once and print its result.

    python3 portbench/run.py --workload nefii.train --seed 12345 --seconds 30 --trace 0

Loads and warms up (set-up), measures for --seconds, checks what the timed
path produced against the plain reference in portbench/reference/, and
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device (and with --trace 1 breakdown), and
last `check`, each compared number beside its limit. The same numbers end
standard error. It needs as many CUDA cards as the cell asks for, and exits
with another code than 0, printing no result, without them, or when a JAX
module was loaded.
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
# a library that would load JAX by itself must not (transformers' flax path)
os.environ.setdefault("USE_FLAX", "0")


def run_cell(run, bench=None):
    """Drive the cell's traffic and build the result line -> (result, stderr lines)."""
    from portbench import core

    out = core.driver(run.cell.traffic).run(run)
    bench = bench or core.benchmark()
    if run.trace:
        metrics = {}
        for m in core.metrics_for(bench, run.cell.name, True, list(out.e2e)):
            read, suffix = core.reader(m["name"])
            v = read(out.reading, suffix)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in core.metrics_for(bench, run.cell.name, False, list(out.e2e))}
    result = {"correct": core.correct(out.numbers), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": core.device_line(run, out)}
    if run.trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.numbers.items()}
    lines = [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in out.numbers.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with one host thread a pool: the program's host work is one
    # Python thread, and idle pools of every core only add to the noise
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    import torch

    torch.set_num_threads(1)
    from portbench import core

    cell = core.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    run = core.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t0=T0)
    result, lines = run_cell(run)
    found = core.loaded_forbidden()
    if found:
        print(f"portbench: JAX modules loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
