"""Pixel-decoder (VQVAE CNN) variants on the card (the counterpart of the
repository's ``tools/bench_pixels.py``): NCHW against channels-last, f32
against bf16 against W8A8, at 256px (ch=160, z=32), random weights from a
fixed seed and a random latent.

    python -m sdvar_tpu_torch.tools.bench_pixels [B] [iters]

(default 16 5). Variants, as the JAX tool names them:
  nchw-f32 (golden)  ``fhat_to_img``, TF32 off
  nchw-bf16          ``fhat_to_img_bf16``
  nhwc-f32           ``fhat_to_img_nhwc(dtype=float32)``, TF32 off
  nhwc-f32-3x        the same with ``precision="high"``: on the card that is
                     TF32 (about 1e-3 relative), not the JAX tool's
                     three-pass bf16 (about 1e-6); the mean |d| printed
                     says which class it is in
  nhwc-bf16          ``fhat_to_img_nhwc`` (the serving decoder)
  nhwc-w8a8          dynamic per-tensor W8A8 3x3 convs
  nhwc-w8a8-calib    calibrated static W8A8 sites (on this latent)
Each: the first call's seconds, then the best of ``iters`` (host clock to
the card's last write), img/s, and mean and max |d| from the golden
image in [-1, 1].
"""

from __future__ import annotations

import sys
import time

import torch

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize


def variants(vae_cfg, params, f_hat) -> dict:
    """name -> zero-argument pixel decode of ``f_hat``, in the JAX tool's
    order (golden first)."""
    f32 = torch.float32
    out = {
        "nchw-f32 (golden)": lambda: VQ.fhat_to_img(vae_cfg, params, f_hat),
        "nchw-bf16": lambda: VQ.fhat_to_img_bf16(vae_cfg, params, f_hat),
        "nhwc-f32": lambda: VQ.fhat_to_img_nhwc(vae_cfg, params, f_hat,
                                                dtype=f32),
        "nhwc-f32-3x": lambda: VQ.fhat_to_img_nhwc(vae_cfg, params, f_hat,
                                                   dtype=f32, precision="high"),
        "nhwc-bf16": lambda: VQ.fhat_to_img_nhwc(vae_cfg, params, f_hat),
        "nhwc-w8a8": lambda: VQ.fhat_to_img_nhwc_w8a8(vae_cfg, params, f_hat),
    }
    sites = VQ.calibrate_decoder_w8a8(vae_cfg, params, [f_hat])
    out["nhwc-w8a8-calib"] = lambda: VQ.fhat_to_img_nhwc_w8a8_static(
        vae_cfg, params, f_hat, sites)
    return out


def run(B: int = 16, iters: int = 5, device="cuda", names=None) -> dict:
    """{variant: {ms, img_per_s, mean_abs_diff, max_abs_diff, first_s}};
    ``names``: a subset of the variants (all by default)."""
    dev = resolve_device(device)
    vae_cfg = VQVAEConfig()
    params = VQ.init_vqvae_params(vae_cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    hw = vae_cfg.patch_nums[-1]
    f_hat = torch.randn(B, vae_cfg.z_channels, hw, hw, device=dev, generator=g)
    card = card_name(dev)
    gold, out = None, {}
    for name, fn in variants(vae_cfg, params, f_hat).items():
        if names is not None and name not in names and gold is not None:
            continue
        with torch.inference_mode():
            synchronize(dev)
            t0 = time.perf_counter()
            img = fn()
            synchronize(dev)
            first = time.perf_counter() - t0
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                synchronize(dev)
                times.append(time.perf_counter() - t0)
        best = min(times)
        if gold is None:
            gold = img
        d = (img - gold).abs()
        row = {"ms": best * 1e3, "img_per_s": B / best, "first_s": first,
               "mean_abs_diff": float(d.mean()), "max_abs_diff": float(d.max())}
        out[name] = row
        print(f"[pixels] {name:18s} B={B}: {row['ms']:7.1f} ms "
              f"({row['img_per_s']:6.1f} img/s)  mean|d|="
              f"{row['mean_abs_diff']:.6f} max|d|={row['max_abs_diff']:.6f} "
              f"(first {first:.1f} s; card: {card})", flush=True)
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 16,
        int(sys.argv[2]) if len(sys.argv) > 2 else 5)
