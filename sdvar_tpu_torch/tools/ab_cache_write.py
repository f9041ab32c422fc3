"""A/B of the fused cache-write attention (``set_cache_kernel``: kernel
rows 7 and 8 write the layer's new keys and values into the stacked cache
and attend in one launch) against the unfused path (a copy into the cache,
then kernel row 1 or 2), and of the weight storage (bf16, w8, fp8): the
counterpart of the repository's ``tools/ab_cache_write.py``.

    python -m sdvar_tpu_torch.tools.ab_cache_write --kv bf16 --cache-kernel 0
    python -m sdvar_tpu_torch.tools.ab_cache_write --kv int8 --w8a8 --cache-kernel 1
    python -m sdvar_tpu_torch.tools.ab_cache_write --weights fp8

The switch is read at each call (no trace to go stale), so ``run`` sets it
for the run and sets it back after. One decode with the cache allocated
(kept and reused), then the best of ``--iters``; the result line goes to
stdout, the rest to stderr.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from sdvar_tpu_torch.config import (
    SamplingConfig,
    VARConfig,
    VQVAEConfig,
    patch_nums_for_reso,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.attention import set_cache_kernel, use_cache_kernel
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--kv", choices=["bf16", "int8"], default="bf16")
    ap.add_argument("--w8a8", action="store_true")
    ap.add_argument("--weights", choices=["bf16", "w8", "fp8"], default="bf16")
    ap.add_argument("--cache-kernel", type=int, default=0)
    ap.add_argument("--reso", type=int, default=256,
                    help="patch_nums preset: 256 (L=680), 512 (L=2240), "
                         "1024 (L=9451)")
    return ap.parse_args(argv)


def run(depth: int = 30, batch: int = 16, iters: int = 4, kv: str = "bf16",
        w8a8: bool = False, weights: str = "bf16", cache_kernel: bool = False,
        reso: int = 256, device="cuda") -> dict:
    """Best-of-``iters`` decode in this configuration: ms, img/s, times."""
    dev = resolve_device(device)
    pns = patch_nums_for_reso(reso)
    var_cfg = VARConfig(depth=depth, patch_nums=pns)
    vae_cfg = VQVAEConfig(patch_nums=pns)
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    quant = init_vqvae_params(vae_cfg, seed=1, device=dev, eini=1.0)["quant"]
    if w8a8 or weights in ("w8", "fp8"):
        params = quantize_var_params(params, mode="w8a8" if w8a8 else weights)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    labels = torch.zeros(batch, dtype=torch.long)
    before = use_cache_kernel()
    set_cache_kernel(bool(cache_kernel))
    try:
        def decode(seed, cache=None):
            f_hat, cache = decode_all_scales(
                var_cfg, vae_cfg, params, quant, labels, seed, SAMP,
                torch.bfloat16, kv_mode=kv, cache=cache, return_cache=True,
                device=dev)
            synchronize(dev)
            return cache

        t0 = time.time()
        cache = decode(1)
        log(f"[ab] first: {time.time() - t0:.1f} s")
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            cache = decode(2 + i, cache)
            times.append(time.perf_counter() - t0)
    finally:
        set_cache_kernel(before)
    best = min(times)
    tag = (f"d{depth} reso={reso} (L={var_cfg.L}) B={batch} kv={kv} "
           f"weights={'w8a8' if w8a8 else weights} "
           f"cache_kernel={bool(cache_kernel)}")
    out = {"tag": tag, "ms": best * 1e3, "img_per_s": batch / best,
           "times_ms": [t * 1e3 for t in times], "card": card_name(dev)}
    print(f"[ab] {tag}: {out['ms']:.1f} ms/batch, {out['img_per_s']:.2f} "
          f"img/s (times={['%.1f' % t for t in out['times_ms']]}; card: "
          f"{out['card']})", flush=True)
    return out


def main(argv=None) -> dict:
    a = parse_args(argv)
    return run(a.depth, a.batch, a.iters, a.kv, a.w8a8, a.weights,
               bool(a.cache_kernel), a.reso)


if __name__ == "__main__":
    main()
