"""Find a serving cell's knee once: in one process, the cell's set-up,
then its open loop at each rate asked for, one after another. For each
rate: the requests due and delivered, the p50 and p95 latency from due
time, and the backlog (requests due but not yet delivered) at a third, two
thirds and the end of the window: a backlog that grows through the window
means the rate is above what the server sustains. Not part of a run.

    python3 benchmark/sweep.py --workload <cell> --rates 20,30,40 --seconds 20
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from benchmark import run as entry

    entry._caches()
    import numpy as np

    from benchmark.harness import cells, runner
    from benchmark.harness.window import percentile_with_missing

    cell = cells.workload(args.workload)
    kind, smi = runner.card(cell["chips"])
    print(f"[card] {kind}; {smi}", file=sys.stderr, flush=True)
    run = cells.driver(cell["driver"]).setup(cell, args.seed, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        got = run._open_loop(args.seconds, rate)
        due, at = got["due"], got["delivered_at"]
        backlog = [int(np.sum(due <= t)) - sum(1 for v in at.values() if v <= t)
                   for t in (args.seconds / 3, 2 * args.seconds / 3,
                             args.seconds)]
        print(json.dumps({
            "rate": rate, "due": len(due), "delivered": len(at),
            "failed": run.failed,
            "p50_ms": 1e3 * percentile_with_missing(got["latencies"], 50),
            "p95_ms": 1e3 * percentile_with_missing(got["latencies"], 95),
            "backlog_at_thirds": backlog, "batches": got["batches"],
            "occupancy": got["occupancy"], "late_ms": 1e3 * got["late_s"]}),
            flush=True)
    run.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
