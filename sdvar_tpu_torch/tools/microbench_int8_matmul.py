"""Microbenchmark of the int8 matmul formulations at the VAR-d30 decode's
GEMM shapes (B=32 requests, CFG doubled to 64 rows per token), on the card:
the counterpart of the repository's ``tools/microbench_int8_matmul.py``.

Modes, for x (B, L, K) bf16, int8 weights wq (K, N) stored K-major and
per-column f32 scales ws (0.01):
  bf16        ``torch.matmul`` of x and the dequantized bf16 weight
  int8_int32  ``torch._int_mm`` of x cast to int8 and wq (no quantization)
  w8a8        the convert form: per-token quantization of x, int-valued bf16
              operands with an f32 sum (``torch.mm(..., out_dtype=f32)``),
              then ``acc * xs * ws``
  w8a8_s8     the port's ``w8a8_matmul``: the act-quant kernel, the exact
              s8 x s8 -> s32 product (``torch._int_mm``), the epilogue
  pl_s8       the fused CUDA kernel ``ops/kernels/w8a8_fused`` (s8 form)
  pl_bf16     the same kernel's int-valued bf16 form
Each mode is timed with CUDA events over ``ITERS`` launches after one
warm-up launch (eager PyTorch needs no data dependency between them).

    python -m sdvar_tpu_torch.tools.microbench_int8_matmul

prints ms and TFLOP/s per mode and shape, and one JSON line per shape with
the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from sdvar_tpu_torch.ops.kernels.w8a8_fused import w8a8_fused
from sdvar_tpu_torch.ops.quantization import (
    as_w8a8,
    k_major,
    quantize_activation,
    w8a8_matmul,
)
from sdvar_tpu_torch.utils.device import resolve_device

ITERS = 100
B, C = 32, 1920
# (L, K, N, tag): the d30 decode's GEMMs at scales 9, 8 and 5, as the JAX
# tool lists them
SHAPES = ((256, C, 4 * C, "fc1 s9"), (256, 4 * C, C, "fc2 s9"),
          (256, C, 3 * C, "qkv s9"), (192, 4 * C, C, "fc2 s8"),
          (64, C, 4 * C, "fc1 s5"), (256, C, 4096, "head s9"))
MODES = ("bf16", "int8_int32", "w8a8", "w8a8_s8", "pl_s8", "pl_bf16")


def operands(L: int, K: int, N: int, device, seed: int = 0):
    """x (B, L, K) bf16 normal, wq (K, N) int8 uniform in [-127, 127]
    stored K-major, ws (N,) = 0.01, and the dequantized bf16 weight."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, L, K, device=device, generator=g).to(torch.bfloat16)
    wq = k_major(torch.randint(-127, 128, (K, N), device=device, generator=g,
                               dtype=torch.int8))
    ws = torch.full((N,), 0.01, device=device)
    return x, wq, ws, (wq.float() * ws).to(torch.bfloat16)


def mode_fn(mode: str, x, wq, ws, w_bf):
    """The zero-argument call that one launch of ``mode`` times."""
    K, N = wq.shape
    if mode == "bf16":
        return lambda: torch.matmul(x, w_bf)
    if mode == "int8_int32":
        x8 = x.reshape(-1, K).to(torch.int8)
        return lambda: torch._int_mm(x8, wq)
    if mode == "w8a8":
        wb = wq.to(torch.bfloat16)

        def convert():
            xq, xs = quantize_activation(x.reshape(-1, K))
            acc = torch.mm(xq.to(torch.bfloat16), wb, out_dtype=torch.float32)
            return (acc * xs * ws).to(torch.bfloat16)
        return convert
    if mode == "w8a8_s8":
        qw = as_w8a8(wq, ws)
        return lambda: w8a8_matmul(x, qw, torch.bfloat16)
    if mode in ("pl_s8", "pl_bf16"):
        s8 = mode == "pl_s8"
        return lambda: w8a8_fused(x, wq, ws, s8=s8)
    raise ValueError(f"mode {mode!r} ({' | '.join(MODES)})")


def time_ms(fn, iters: int) -> float:
    """Mean ms per launch: CUDA events around ``iters`` launches, after one
    warm-up launch."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run():
    """Time every mode at every shape on the card; print a row and a JSON
    line per shape and return the JSON rows."""
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rows = []
    for L, K, N, tag in SHAPES:
        x, wq, ws, w_bf = operands(L, K, N, dev)
        flops = 2 * B * L * K * N
        row = {"shape": tag, "B": B, "L": L, "K": K, "N": N, "iters": ITERS,
               "card": card}
        text = f"{tag:8s} L={L:4d} K={K:5d} N={N:5d}:"
        for mode in MODES:
            ms = time_ms(mode_fn(mode, x, wq, ws, w_bf), ITERS)
            row[mode] = {"ms": ms, "tflops": flops / ms / 1e9}
            text += f"  {mode} {ms:6.3f}ms({flops / ms / 1e9:5.1f}T)"
        print(text, flush=True)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, wq, ws, w_bf
    return rows


if __name__ == "__main__":
    run()
