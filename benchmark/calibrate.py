"""Readings that set a cell's limits, in one process: for each seed the
cell's set-up and a window at the cell's own size and load, then the
numbers its check compares, of the program and, for the seeds asked, of
the control (the reference one precision lower in the program's place).
Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control 1,2] [--fault half_batch] --seconds 8

One JSON line a seed on standard output: {"seed", "program": {...},
"control": {...}}; with ``--fault`` the program runs with that fault of
``harness/faults.py`` planted underneath. Needs the card.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from benchmark import run as entry

    entry._caches()
    import torch

    from benchmark.harness import cells, faults, runner

    cell = cells.workload(args.workload)
    kind, smi = runner.card(cell["chips"])
    print(f"[card] {kind}; {smi}", file=sys.stderr, flush=True)
    drv = cells.driver(cell["driver"])
    controls = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        patch = faults.Patcher()
        if args.fault:
            faults.for_driver(cell["driver"])[args.fault](patch)
        t = time.time()
        run = drv.setup(cell, seed, "cuda")
        setup_s = time.time() - t
        e2e = run.window(args.seconds)
        run.release()
        patch.undo()
        out = {"seed": seed, "fault": args.fault, "setup_s": setup_s,
               "window": e2e, "program": run.readings()}
        if seed in controls:
            out["control"] = run.readings(control=True)
        print(json.dumps(out), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
