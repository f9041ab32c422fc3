"""One-line throughput figure of the port on the card (the counterpart of
the repository's ``bench.py``):

    python -m sdvar_tpu_torch.bench

prints exactly one JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline"}``. The headline is VAR-d30 256px class-conditional images per
second of the latent decode (``decode_all_scales``: labels -> 10 scales ->
f_hat, no pixel decode) with W8A8 weights and an INT8 KV cache at B=32, the
JAX package's headline configuration: one reused cache, one warm-up
decode, best of ``iters``. The d30 B=16 bf16 decode, the card's name and
power limit, and every run's time go to stderr.

There is no fallback: on an 80 GB card an out-of-memory error or a failing
kernel is an error, not a reason to report another configuration.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models.quantizer import init_quantizer_params
from sdvar_tpu_torch.models.var import KVCache, init_var_params
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache, quantize_var_params
from sdvar_tpu_torch.utils.device import resolve_device

# The A100 figure ``vs_baseline`` divides by is ESTIMATED, NOT MEASURED: the
# reference stack as it is (eager PyTorch, a per-scale Python loop, no CUDA
# graphs) at about 2 img/s for VAR-d30, derived from the model zoo's relative
# costs (d30 1.0 against d16 0.4) and public A100 runs of eager VAR-d16 at
# about 5 img/s. It is the same estimate as the repository's bench.py uses.
A100_D30_IMGS_PER_SEC = 2.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_decode(depth: int, batch: int, iters: int = 4,
                 dtype=torch.bfloat16, w8a8: bool = False,
                 kv_mode: str = "bf16", device="cuda") -> float:
    """Images per second of the best of ``iters`` latent decodes of VAR
    ``depth`` at ``batch`` (labels 0, cfg 1.5, top_k 900, top_p 0.96), after
    one warm-up decode, with one KV cache reused across them; random
    weights from seed 0."""
    dev = resolve_device(device)
    var_cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=dtype)
    quant = init_quantizer_params(vae_cfg, torch.Generator(device=dev).manual_seed(0),
                                  dev, eini=1.0)
    if w8a8:  # the float tree goes as it is dropped
        params = quantize_var_params(params, mode="w8a8")
    log(f"[bench] VAR-d{depth} parameters made in {time.time() - t0:.1f} s")
    labels = torch.zeros(batch, dtype=torch.long)
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    if kv_mode == "int8":
        cache = QuantizedKVCache.create(var_cfg, 2 * batch, device=dev)
    else:
        cache = KVCache.create(var_cfg, 2 * batch, dtype=dtype, device=dev)

    def decode(seed):
        nonlocal cache
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        _, cache = decode_all_scales(var_cfg, vae_cfg, params, quant, labels,
                                     seed, samp, dtype, kv_mode=kv_mode,
                                     cache=cache, return_cache=True, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time() - t0

    log(f"[bench] d{depth} first decode (warm-up): {decode(1):.1f} s")
    times = [decode(2 + i) for i in range(iters)]
    ips = batch / min(times)
    mode = ("w8a8" if w8a8 else str(dtype)[6:]) + (
        f"+kv_{kv_mode}" if kv_mode != "bf16" else "")
    log(f"[bench] d{depth} B={batch} {mode}: {min(times) * 1e3:.1f} ms/batch, "
        f"{ips:.3f} img/s (times {[f'{t:.3f}' for t in times]})")
    return ips


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[bench] card: {smi}")
    ips = bench_decode(30, 32, w8a8=True, kv_mode="int8")
    ips_bf16 = bench_decode(30, 16)
    log(f"[bench] secondary: d30 B=16 bf16 {ips_bf16:.3f} img/s "
        f"({ips_bf16 / A100_D30_IMGS_PER_SEC:.2f}x the estimated A100 figure)")
    print(json.dumps({
        "metric": "VAR-d30 256px images/sec (W8A8 + INT8-KV latent decode, "
                  "B=32; vs_baseline against an A100 estimate, estimated, "
                  "not measured)",
        "value": round(ips, 3),
        "unit": "images/sec/card",
        "vs_baseline": round(ips / A100_D30_IMGS_PER_SEC, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
