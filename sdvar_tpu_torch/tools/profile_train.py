"""Where one VAR training step on the token path spends its device time
(the counterpart of the repository's ``tools/profile_train.py``).

    python -m sdvar_tpu_torch.tools.profile_train [depth] [batch] [--device cpu]

The step of ``tools/adjudicate_mfu.py`` (VAR-d16 B=32 by default: f32
master weights, ``train_step(pretokenized=True)`` with remat, bf16
compute, AdamW; the quantizer's parameters only, ids and labels zero):
one untimed step, one timed step (host clock around a synchronisation;
its MFU with ``adjudicate_mfu.step_flops`` against 989 TFLOP/s, the H100
SXM data-sheet bf16 dense peak), then one step under
``utils.profiling.trace`` (torch.profiler, a Chrome trace in
``--logdir``). The device time of the kernels is sorted into the JAX
tool's five categories, named for CUDA kernels (the substrings of
``tools/profile_decode.py``'s categories where they fit): GEMM (cuBLAS,
CUTLASS), the attention kernel (row 1), reduce / softmax, copy /
transpose, other; then the 40 kernels with the most device time, the
step's busy share (the profiled step's device time over the unprofiled
step's time: one stream, the kernels do not overlap; the profiler slows
the host, so its own wall time is printed beside), kernel row 1's
launches in the profiled
step (32 at depth 16: remat runs each forward twice), and the attention
backward on a line of its own: the device time under
``AttentionFnBackward`` (``ops/attention.py:AttentionFn``: the plain
composition recomputed and its VJP's einsums). On the CPU the same lines
read the CPU's operator times.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.ops.kernels.attention import attention_kernel
from sdvar_tpu_torch.tools.adjudicate_mfu import (
    PEAK_BF16,
    PEAK_NAME,
    step_flops,
    token_step,
)
from sdvar_tpu_torch.tools.profile_decode import _CATEGORIES as DECODE
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize
from sdvar_tpu_torch.utils.profiling import trace

TOP = 40
ATTN_BWD = "AttentionFnBackward"
_DECODE = dict(DECODE)
CATEGORIES = (  # (category, lower-case substrings), first match wins
    ("attention kernel (row 1)", _DECODE["port attention kernel"]),
    ("GEMM (cuBLAS / CUTLASS)", _DECODE["matmul (cuBLAS)"] + (
        "sm90_", "aten::mm", "aten::bmm", "aten::addmm", "aten::matmul")),
    ("reduce / softmax", _DECODE["reduction"] + ("softmax", "reduce", "norm")),
    ("copy / transpose", _DECODE["copy / cast"] + ("transpose", "catarray", "aten::cat")),
)


def category(name: str) -> str:
    n = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in n for k in keys):
            return cat
    return "other"


def _kernel_events(prof, cuda: bool):
    """(name, ms, count) of the card's kernels, or of the CPU's operators
    without a card."""
    out = []
    for e in prof.key_averages():
        if cuda and e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.key, e.self_device_time_total / 1e3, e.count))
        elif not cuda and e.device_type == torch.autograd.DeviceType.CPU \
                and e.key.startswith("aten::"):
            out.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    return out


def _attention_backward_ms(prof, cuda: bool) -> float:
    """The time under AttentionFn's backward nodes (their kernels and
    their children's)."""
    total = 0.0
    for e in prof.events():
        if e.name == ATTN_BWD:
            total += (e.device_time_total if cuda else e.cpu_time_total) / 1e3
    return total


def run(depth: int = 16, batch: int = 32, logdir: Optional[str] = None,
        device="cuda") -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    card = card_name(dev)
    print(f"[prof] card: {card}", flush=True)
    cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    state, step = token_step(cfg, vae_cfg, batch, dev)
    print("[prof] warm-up step (kernel load)...", flush=True)
    state, m = step(state)
    float(m["loss"])
    synchronize(dev)
    t0 = time.perf_counter()
    state, m = step(state)
    float(m["loss"])
    synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    mfu = sum(step_flops(cfg, batch)) / (step_ms / 1e3) / PEAK_BF16
    print(f"[prof] steady-state step: {step_ms:.1f} ms ({mfu * 100:.1f}% MFU "
          f"of {PEAK_NAME})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        n0 = attention_kernel.launches
        t0 = time.perf_counter()
        with trace(logdir or tmp) as prof:
            state, m = step(state)
            float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = attention_kernel.launches - n0
    events = _kernel_events(prof, cuda)
    total = sum(ms for _, ms, _ in events)
    what = "device kernel" if cuda else "CPU operator"
    busy = total / step_ms
    print(f"[prof] total {what} time: {total:.1f} ms in "
          f"{sum(n for _, _, n in events)} calls; busy share {busy:.3f} of "
          f"the unprofiled step ({total / wall_ms:.3f} of the profiled wall, "
          f"{wall_ms:.1f} ms: the profiler slows the host)")
    cats = defaultdict(float)
    for name, ms, _ in events:
        cats[category(name)] += ms
    for k, v in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[prof] {k:28s} {v:8.1f} ms ({v / max(total, 1e-9) * 100:.0f}%)")
    bwd_ms = _attention_backward_ms(prof, cuda)
    print(f"[prof] attention backward ({ATTN_BWD}: the plain composition "
          f"recomputed and its VJP's einsums) {bwd_ms:.1f} ms "
          f"({bwd_ms / max(total, 1e-9) * 100:.1f}% of the step's {what} "
          f"time); row-1 kernel launches in the step: {launches}")
    print(f"\n{'ms':>10}  {'n':>5}  kernel")
    top = sorted(events, key=lambda ev: -ev[1])[:TOP]
    for name, ms, n in top:
        print(f"{ms:10.2f}  {n:5d}  {name[:110]}")
    return {"card": card, "step_ms": step_ms, "mfu": mfu, "wall_ms": wall_ms,
            "total_ms": total, "busy_share": busy,
            "categories": dict(cats), "attention_backward_ms": bwd_ms,
            "attention_launches": launches, "top": top}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("depth", type=int, nargs="?", default=16)
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("--logdir", type=str, default=None,
                    help="where the Chrome trace goes (default: a temporary "
                         "directory)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    run(a.depth, a.batch, a.logdir, device=a.device)


if __name__ == "__main__":
    main()
