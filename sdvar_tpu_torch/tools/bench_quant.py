"""Decode time per quantization mode on the card (the counterpart of the
repository's ``tools/bench_quant.py``).

    python -m sdvar_tpu_torch.tools.bench_quant [depth] [batch] [modes...]

(default: 30 16 bf16 w8a8 w8a8+kv8; 256px, random weights from fixed
seeds). Modes: ``bf16``, ``w8`` (int8 weights, bf16 activations), ``w8a8``
(W8A8 block matmuls, the head weight-only int8) and ``w8a8_head`` (the head
W8A8 too: ``quantize_var_params(..., act_head=True)``), each optionally
``+kv8`` (an INT8 KV cache). Every mode's weights are built first; the
bf16 weights go when no mode needs them. One warm-up decode a mode, then
the best of four.
"""

from __future__ import annotations

import sys
import time

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

BASES = ("bf16", "w8", "w8a8", "w8a8_head")
SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)


def _prepare(params, base: str):
    if base == "bf16":
        return params
    if base == "w8a8_head":
        return quantize_var_params(params, mode="w8a8", act_head=True)
    return quantize_var_params(params, mode=base)


def run(depth: int = 30, batch: int = 16,
        modes=("bf16", "w8a8", "w8a8+kv8"), iters: int = 4,
        device="cuda") -> dict:
    """{mode: {ms, img_per_s, times_ms}} of the best-of-``iters`` decodes."""
    dev = resolve_device(device)
    parsed = []
    for mode in modes:
        base, _, kv = mode.partition("+")
        if base not in BASES or kv not in ("", "kv8"):
            raise ValueError(f"unknown mode {mode!r} ({' | '.join(BASES)}, "
                             f"each optionally +kv8)")
        parsed.append((mode, base, "int8" if kv else "bf16"))
    var_cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    print(f"[q] init VAR-d{depth}...", flush=True)
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    quant = init_vqvae_params(vae_cfg, seed=1, device=dev)["quant"]
    prepared = {}
    for _, base, _ in parsed:
        if base not in prepared:
            prepared[base] = _prepare(params, base)
    del params  # the bf16 weights live on only in a bf16 mode's tree
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    synchronize(dev)
    print(f"[q] init done {time.time() - t0:.0f} s", flush=True)
    card = card_name(dev)
    labels = torch.arange(batch) % 1000
    out = {}
    for mode, base, kv_mode in parsed:
        def decode(seed):
            decode_all_scales(var_cfg, vae_cfg, prepared[base], quant, labels,
                              seed, SAMP, torch.bfloat16, kv_mode=kv_mode,
                              device=dev)
            synchronize(dev)

        t0 = time.time()
        decode(2)
        print(f"[q] {mode}: first run {time.time() - t0:.1f} s", flush=True)
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            decode(3 + i)
            times.append(time.perf_counter() - t0)
        best = min(times)
        out[mode] = {"ms": best * 1e3, "img_per_s": batch / best,
                     "times_ms": [t * 1e3 for t in times]}
        print(f"[q] {mode}: {best * 1e3:.1f} ms/batch, {batch / best:.2f} "
              f"img/s (d{depth} B={batch}; card: {card})", flush=True)
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 30,
        int(sys.argv[2]) if len(sys.argv) > 2 else 16,
        tuple(sys.argv[3:]) or ("bf16", "w8a8", "w8a8+kv8"))
