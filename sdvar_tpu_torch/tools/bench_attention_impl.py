"""Time the VAR decode under a chosen attention backend (the counterpart
of the repository's ``tools/bench_attention_impl.py``).

    python -m sdvar_tpu_torch.tools.bench_attention_impl {auto|plain|kernel} [depth] [batch]

(default depth 30, batch 16, 256px, bf16 weights and KV cache, random
weights from fixed seeds). The backend is set with
``ops.attention.set_attention_impl`` for the run and set back after it:
``kernel`` is the CUDA attention kernel, ``plain`` its plain PyTorch
version (the counterpart of the JAX tool's ``xla``), ``auto`` the default
(the kernel on the card). One warm-up decode, then the best of four, and
the attention launches one decode made.
"""

from __future__ import annotations

import sys
import time

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.attention import get_attention_impl, set_attention_impl
from sdvar_tpu_torch.ops.kernels.attention import attention_kernel
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)


def run(impl: str, depth: int = 30, batch: int = 16, iters: int = 4,
        device="cuda") -> dict:
    """Best-of-``iters`` decode under ``impl``; returns ms, img/s and the
    kernel's launches in the last decode."""
    dev = resolve_device(device)
    var_cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    qp = init_vqvae_params(vae_cfg, seed=1, device=dev)["quant"]
    synchronize(dev)
    print(f"[bench] init {time.time() - t0:.1f} s", flush=True)
    labels = torch.arange(batch) % 1000
    before = get_attention_impl()
    set_attention_impl(impl)
    try:
        def decode():
            decode_all_scales(var_cfg, vae_cfg, params, qp, labels, 0, SAMP,
                              device=dev)
            synchronize(dev)

        t0 = time.time()
        decode()
        print(f"[bench] warm-up {time.time() - t0:.1f} s", flush=True)
        times = []
        for _ in range(iters):
            n0 = attention_kernel.launches
            t0 = time.perf_counter()
            decode()
            times.append(time.perf_counter() - t0)
        launches = attention_kernel.launches - n0
    finally:
        set_attention_impl(before)
    best = min(times)
    out = {"impl": impl, "depth": depth, "batch": batch, "ms": best * 1e3,
           "img_per_s": batch / best, "times_ms": [t * 1e3 for t in times],
           "kernel_launches_per_decode": launches, "card": card_name(dev)}
    print(f"[bench] impl={impl} d{depth} B={batch}: {out['ms']:.1f} ms/batch, "
          f"{out['img_per_s']:.2f} img/s ({launches} attention kernel "
          f"launches a decode; card: {out['card']})", flush=True)
    return out


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 30,
        int(sys.argv[3]) if len(sys.argv) > 3 else 16)
