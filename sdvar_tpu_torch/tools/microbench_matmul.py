"""Microbenchmark: a batched bf16 product's time against its token count,
at the VAR-d30 decode's scale-8 fc2 shape (the counterpart of the
repository's ``tools/microbench_matmul.py``).

    python -m sdvar_tpu_torch.tools.microbench_matmul

x (B=32, L, K=7680) bf16 times w (K, N=1920) bf16, an f32 sum cast to
bf16, through ``torch.matmul`` (cuBLAS): a plain product outside any
kernel of the port, so the library is its counterpart. L in (169, 176,
192, 256, 100, 128): the scale's 13x13 tokens, padded to 176 and 192 (the
JAX decode pads to a multiple of 64), 256, and two smaller ones. Each: the
mean of CUDA-event-timed launches after a warm-up, and TFLOP/s at
2 B L K N operations.
"""

from __future__ import annotations

import time

import torch

from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

B, K, N = 32, 7680, 1920
LS = (169, 176, 192, 256, 100, 128)


def _ms(fn, iters: int, dev) -> float:
    """Mean ms a call: CUDA events on the card, the host clock on the CPU."""
    fn()
    synchronize(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(Ls=LS, b: int = B, k: int = K, n: int = N, iters: int = 50,
        device="cuda") -> dict:
    """{L: {ms, tflops}} of ``torch.matmul`` at each token count."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(k, n, device=dev, generator=g).to(torch.bfloat16)
    card = card_name(dev)
    out = {}
    for L in Ls:
        x = torch.randn(b, L, k, device=dev, generator=g).to(torch.bfloat16)
        ms = _ms(lambda: torch.matmul(x, w), iters, dev)
        fl = 2 * b * L * k * n
        out[L] = {"ms": ms, "tflops": fl / ms / 1e9}
        print(f"L={L:4d}: {ms:7.3f} ms  {fl / ms / 1e9:6.1f} TFLOP/s "
              f"(B={b} K={k} N={n}; card: {card})", flush=True)
    return out


if __name__ == "__main__":
    run()
