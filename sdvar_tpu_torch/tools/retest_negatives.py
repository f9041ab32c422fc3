"""Re-test the JAX package's negative results on this card (the
counterpart of the repository's ``tools/retest_negatives.py``).

    python -m sdvar_tpu_torch.tools.retest_negatives [depth] [batch]

(default 30 16). Prints one line a result:
  1. the fused cache-write attention against the unfused path, on the
     W8A8 + INT8-KV decode (``ab_cache_write.run`` with the switch off,
     then on; a negative on the TPU in the JAX package's rounds 2-4);
  2. the pixel decoder's precision modes (``bench_pixels.run``): f32 with
     TF32 off (``precision="highest"``), f32 with TF32 on
     (``precision="high"``), bf16, and the two W8A8 decoders. cuDNN has no
     three-pass bf16 mode like XLA's ``BF16_BF16_F32_X3``, which the JAX
     tool tests here: TF32 is the card's reduced-precision f32, of another
     error class (about 1e-3 relative, against about 1e-6), and the mean
     |d| printed beside each says which;
  3. the fused act-quant's ``MIN_FUSED_ROWS`` gate has no counterpart: it
     is a TPU tuning gate of the JAX package's XLA path, and the port's
     act-quant kernel runs at every scale. One line says so.
"""

from __future__ import annotations

import sys

from sdvar_tpu_torch.tools import ab_cache_write, bench_pixels

PIXEL_VARIANTS = ("nhwc-f32", "nhwc-f32-3x", "nhwc-bf16", "nhwc-w8a8",
                  "nhwc-w8a8-calib")


def run(depth: int = 30, batch: int = 16, iters: int = 4,
        pixel_batch: int = 16, device="cuda") -> dict:
    """{"cache_kernel": {0: ..., 1: ...}, "pixels": {...}, "min_fused_rows":
    None}: the figures of each experiment."""
    out = {"cache_kernel": {}, "min_fused_rows": None}
    for ck in (0, 1):
        r = ab_cache_write.run(depth, batch, iters, kv="int8", w8a8=True,
                               cache_kernel=bool(ck), device=device)
        out["cache_kernel"][ck] = r
        print(f"[retest] cache_kernel={ck}: {r['tag']}: {r['ms']:.1f} "
              f"ms/batch, {r['img_per_s']:.2f} img/s (card: {r['card']})",
              flush=True)
    pix = bench_pixels.run(pixel_batch, iters, device=device,
                           names=PIXEL_VARIANTS)
    out["pixels"] = {k: v for k, v in pix.items() if k in PIXEL_VARIANTS}
    for name, r in out["pixels"].items():
        print(f"[retest] {name}: {r['ms']:.1f} ms, mean|d| from the golden "
              f"f32 image {r['mean_abs_diff']:.6f}", flush=True)
    print("[retest] min_fused_rows: no counterpart (a TPU tuning gate of "
          "the JAX package's XLA act-quant path; the port's act-quant "
          "kernel runs at every scale)", flush=True)
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 30,
        int(sys.argv[2]) if len(sys.argv) > 2 else 16)
