"""Where one VAR-d30 256px B=16 generation spends its device time.

    python3 -m sdvar_tpu_torch.tools.profile_decode [--mode bf16|w8a8|w8]

``--mode``: bf16 weights and KV cache (the default), or the weights
quantized by ``quantize_var_params(mode=...)`` with an INT8 KV cache. Warms
up with one ``generate_images``, then profiles the latent decode
(``decode_all_scales``) and the three pixel decoders (the f32 golden
``fhat_to_img``, the channels-last bf16 ``fhat_to_img_nhwc`` and the W8A8
``fhat_to_img_nhwc_w8a8_static`` with sites calibrated on two B=8 decodes,
``alpha=0.75, min_w=256``, each after a warm-up call) in
``torch.profiler`` windows (CPU + CUDA activities). For each window it
prints the host wall time, the summed device time and launch count of all
kernels, the device time's share of the wall time (the device's busy
share: the kernels run on one stream and do not overlap), the device time
by kernel category, and the kernels with the most device time. Needs a
CUDA card; random weights from a seed.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales, generate_images
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import (
    calibrate_decoder_w8a8,
    fhat_to_img,
    fhat_to_img_nhwc,
    fhat_to_img_nhwc_w8a8_static,
    init_vqvae_params,
)
from sdvar_tpu_torch.ops.quantization import quantize_var_params

BATCH = 16  # requests per batch (2B = 32 rows under CFG)
TOP = 16    # kernels listed per window

_CATEGORIES = (  # (category, substrings of the kernel name), first match wins
    ("port attention kernel", ("attention_mma_kernel", "attention_f32_kernel")),
    ("port sampler kernel", ("fused_sample_kernel",)),
    ("port int8 matmul kernel", ("int8_matmul_wgmma_kernel",)),
    ("port act-quant kernel", ("act_quantize_kernel",)),
    ("port int8 conv kernel", ("conv3x3_s8_kernel",)),
    ("int8 GEMM (cuBLASLt, _int_mm)", ("s8", "i8", "imma", "int8")),
    ("convolution", ("fprop", "fft", "conv", "dgrad")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reduction", ("reduce_kernel",)),
    ("copy / cast", ("copy",)),
)


def _category(name: str) -> str:
    for cat, keys in _CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other elementwise"


def _report(title: str, fn, top: int):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    print(f"== {title}: wall {wall_ms:.1f} ms (profiled), device kernels "
          f"{dev_ms:.1f} ms in {n_launch} launches, busy share "
          f"{dev_ms / wall_ms:.3f}")
    by_cat = {}
    for e in events:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"   {cat:<24} {ms:9.2f} ms  {ms / dev_ms:.3f}")
    print(f"   {'device ms':>10} {'calls':>6}  kernel")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"   {e.self_device_time_total / 1e3:10.2f} {e.count:6d}  "
              f"{e.key[:100]}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bf16", "w8a8", "w8"), default="bf16")
    mode = ap.parse_args().mode
    kv_mode = "bf16" if mode == "bf16" else "int8"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; weights {mode}, KV cache {kv_mode}")
    var_cfg, vae_cfg = VARConfig(depth=30), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    params = init_var_params(var_cfg, seed=0, dtype=torch.bfloat16)
    if mode != "bf16":
        params = quantize_var_params(params, mode=mode)
    vae = init_vqvae_params(vae_cfg, seed=1, eini=1.0)
    labels = torch.arange(BATCH) % 1000
    generate_images(var_cfg, vae_cfg, params, vae, labels, 0, samp,
                    kv_mode=kv_mode)
    torch.cuda.synchronize()

    f_hat = _report("latent decode (decode_all_scales)", lambda: decode_all_scales(
        var_cfg, vae_cfg, params, vae["quant"], labels, 1, samp,
        kv_mode=kv_mode), TOP)
    cal = [decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                             torch.arange(8) + 100 * i, 40 + i, samp,
                             kv_mode=kv_mode) for i in range(2)]
    sites = calibrate_decoder_w8a8(vae_cfg, vae, cal, alpha=0.75, min_w=256)
    pixels = {
        "fhat_to_img": lambda: fhat_to_img(vae_cfg, vae, f_hat),
        "fhat_to_img_nhwc": lambda: fhat_to_img_nhwc(vae_cfg, vae, f_hat),
        "fhat_to_img_nhwc_w8a8_static": lambda: fhat_to_img_nhwc_w8a8_static(
            vae_cfg, vae, f_hat, sites),
    }
    with torch.inference_mode():
        for name, fn in pixels.items():
            fn()
            _report(f"pixel decode ({name})", fn, TOP)


if __name__ == "__main__":
    main()
