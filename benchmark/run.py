"""Run one cell of the benchmark of ``sdvar_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``: its configuration
(``benchmark/configs/<config>.json``), its driver (``benchmark/drivers/
<driver>.py``) and its traffic. Set-up makes the weights on the card from
``--seed``, warms the cell's own shapes and counts as ``setup_s``; the
window then drives the port for ``--seconds``. With ``--trace 1`` a
fixed amount of the cell's work runs under ``torch.profiler`` and the
per-layer metrics of ``benchmark/metrics/`` are reported instead of the
end-to-end ones. After the window the outputs are compared with the plain
reference of ``benchmark/reference/``; every number compared is printed
with its limit, as the last lines on standard error and under ``checks``
in the result. The last line of standard output is one JSON object.

Exits non-zero, with no result, without a CUDA card (or with fewer than
the cell asks for), without the port beside this folder, or when JAX or
the JAX package was loaded in this process.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _caches() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a cell's first run there builds (the port's nvcc
    libraries go to ``build/kernels/`` on their own); and keep libraries
    that could load JAX from doing so."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT)]
    from benchmark.harness import runner

    return runner.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
