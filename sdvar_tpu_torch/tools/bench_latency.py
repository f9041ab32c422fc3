"""Small-batch latency on the card: sequential against speculative decode
at B = 1, 2 and 4 (the counterpart of the repository's
``tools/bench_latency.py``).

    python -m sdvar_tpu_torch.tools.bench_latency [target_depth] [reps] [quant]

(default 30 20 int8; quant ``int8``: W8A8 weights and an INT8 KV cache,
or ``bf16``). 256px, random weights from fixed seeds, per-request seeds
7, 8, ... For each batch size, per image wall time (min, p50 and p90 over
``reps`` runs after one warm-up) of:
  seq         the target alone (``decode_all_scales``, its cache reused)
  spec-floor  d16 draft -> target, gamma 3 (``SpeculativeEngine``): with
              random weights every window is rejected, the acceptance
              floor
  spec-ceil   the same with ``force_accept_all``: the ceiling
and the speedups of both over seq at p50.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from sdvar_tpu_torch.config import (
    PATCH_NUMS_256,
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
DRAFT_DEPTH = 16


def run(depth: int = 30, reps: int = 20, quant: str = "int8",
        batches=(1, 2, 4), device="cuda") -> dict:
    """{(B, name): {min_ms, p50_ms, p90_ms, img_per_s}} plus
    {(B, "speedup"): {floor, ceiling}}."""
    if quant not in ("int8", "bf16"):
        raise ValueError(f"unknown quant {quant!r} (int8 | bf16)")
    dev = resolve_device(device)
    kv_mode = "int8" if quant == "int8" else "bf16"
    vae_cfg = VQVAEConfig(patch_nums=PATCH_NUMS_256)
    tgt_cfg = VARConfig(depth=depth, patch_nums=PATCH_NUMS_256)
    drf_cfg = VARConfig(depth=DRAFT_DEPTH, patch_nums=PATCH_NUMS_256)
    vae = init_vqvae_params(vae_cfg, seed=0, device=dev)
    tgt = init_var_params(tgt_cfg, seed=1, device=dev, dtype=torch.bfloat16)
    drf = init_var_params(drf_cfg, seed=2, device=dev, dtype=torch.bfloat16)
    if quant == "int8":
        tgt = quantize_var_params(tgt, mode="w8a8")
        drf = quantize_var_params(drf, mode="w8a8")
    card = card_name(dev)
    print(f"[latency] d{DRAFT_DEPTH} draft + d{depth} target, {quant} "
          f"(kv={kv_mode}), reps={reps}; card: {card}", flush=True)
    engine = SpeculativeEngine(vae_cfg, drf_cfg, tgt_cfg, vae, drf, tgt,
                               dtype=torch.bfloat16, kv_mode=kv_mode,
                               device=dev)
    out = {}
    for B in batches:
        labels = torch.arange(B) * 37 % 1000
        seeds = [7 + i for i in range(B)]
        cache = None

        def run_seq():
            nonlocal cache
            _, cache = decode_all_scales(
                tgt_cfg, vae_cfg, tgt, vae["quant"], labels, seeds, SAMP,
                torch.bfloat16, kv_mode=kv_mode, cache=cache,
                return_cache=True, device=dev)

        def spec(force):
            sc = SpeculativeConfig(gamma=3, force_accept_all=force)
            return lambda: engine.generate_speculative(labels, seeds, sc, SAMP)

        for name, fn in (("seq", run_seq), ("spec-floor", spec(False)),
                         ("spec-ceil", spec(True))):
            t0 = time.time()
            fn()
            synchronize(dev)
            warm = time.time() - t0
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                synchronize(dev)
                times.append(time.perf_counter() - t0)
            ts = np.asarray(times) * 1e3
            row = {"min_ms": float(ts.min()),
                   "p50_ms": float(np.percentile(ts, 50)),
                   "p90_ms": float(np.percentile(ts, 90))}
            row["img_per_s"] = B / (row["p50_ms"] / 1e3)
            out[(B, name)] = row
            print(f"[latency] B={B} {name:10s}: min {row['min_ms']:7.1f} ms  "
                  f"p50 {row['p50_ms']:7.1f}  p90 {row['p90_ms']:7.1f}  "
                  f"({row['img_per_s']:5.2f} img/s at p50; warm {warm:.1f} s)",
                  flush=True)
        s = out[(B, "seq")]["p50_ms"]
        out[(B, "speedup")] = {
            "floor": s / out[(B, "spec-floor")]["p50_ms"],
            "ceiling": s / out[(B, "spec-ceil")]["p50_ms"]}
        print(f"[latency] B={B} speedup vs seq: floor "
              f"{out[(B, 'speedup')]['floor']:.2f}x  ceiling "
              f"{out[(B, 'speedup')]['ceiling']:.2f}x", flush=True)
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 30,
        int(sys.argv[2]) if len(sys.argv) > 2 else 20,
        sys.argv[3] if len(sys.argv) > 3 else "int8")
