"""One run of one cell: the card check, the driver's set-up and window, the
per-layer readers on a traced run, the correctness check after the window,
the isolation check, and the result line."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Dict, List, Tuple

from benchmark.harness import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "sdvar_tpu")


def card(chips: int) -> Tuple[str, str]:
    """The card's name from torch and its name and power limit from
    nvidia-smi; raises SystemExit without the cards the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the benchmark measures the port on "
                         "the card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"(nvidia-smi: {e})"
    return torch.cuda.get_device_name(0), smi


def loaded_forbidden() -> List[str]:
    """Modules of JAX or the JAX package in this process, compared by
    their whole top-level name (``sdvar_tpu_torch`` is not ``sdvar_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for mod in cells.metric_modules():
        if ctx["driver"] not in mod.DRIVERS:
            continue
        value = mod.read(ctx)
        if value is not None:
            out[mod.NAME] = {"value": value, "unit": mod.UNIT}
    return out


def report_checks(checks: List[Tuple[str, float, float]]) -> Dict:
    """Print each number compared beside its limit on standard error and
    return them for the result line."""
    for name, value, limit in checks:
        print(f"[check] {name} = {value!r} (limit {limit!r}): "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr,
              flush=True)
    return {name: {"value": value, "limit": limit}
            for name, value, limit in checks}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float) -> int:
    return run_loaded(cells.workload(name), seed, seconds, trace, t_start)


def run_loaded(cell: Dict, seed: int, seconds: float, trace: bool,
               t_start: float, require_card: bool = True,
               device: str = "cuda") -> int:
    """``run_cell`` on a loaded cell; tests skip the look for a card and
    run on the CPU."""
    if require_card:
        kind, smi = card(cell["chips"])
        print(f"[card] {kind}; nvidia-smi name, power.limit: {smi}",
              file=sys.stderr, flush=True)
    else:
        kind = "cpu"
    import torch

    drv = cells.driver(cell["driver"])
    run = drv.setup(cell, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    print(f"[setup] {setup_s:.3f} s: {run.setup_parts()}", file=sys.stderr,
          flush=True)
    if trace:
        ctx = run.traced_window()
        ctx["driver"] = cell["driver"]
        ctx["model"] = cell["model"]
        ctx["traffic"] = cell["traffic"]
        metrics = per_layer(ctx)
    else:
        metrics = run.window(seconds)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    summary = run.summary()
    checks = run.check()
    bad = loaded_forbidden()
    if bad:
        print(f"[isolation] loaded in this process: {bad}", file=sys.stderr,
              flush=True)
        return 3
    correct = bool(checks) and all(v <= lim for _, v, lim in checks) \
        and summary["failed"] == 0
    checked = report_checks(checks)
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": summary["attempted"],
              "failed": summary["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx["trace"].busy_s
        dev["window_s"] = ctx["trace"].window_s
        result["breakdown"] = {
            "device_ops": ctx["trace"].device_ops(),
            "idle_gaps": [[n[:160], s] for n, s in ctx["trace"].idle_gaps]}
    result["checks"] = checked
    print(json.dumps(result), flush=True)
    return 0
