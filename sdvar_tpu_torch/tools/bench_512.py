"""VAR-d36 512px decode on the card (the counterpart of the repository's
``tools/bench_512.py``): the published 512px model, shared AdaLN, C=2304,
36 heads of 64, ``PATCH_NUMS_512`` (L=2240), random weights from fixed
seeds.

    python -m sdvar_tpu_torch.tools.bench_512 [batch] [modes...]

(default: 4 bf16 w8a8). Modes: ``bf16`` (bf16 weights and KV cache),
``w8a8`` (W8A8 weights, bf16 KV cache), ``w8a8-int8kv`` (W8A8 weights and
an INT8 KV cache). The bf16 weights go once the W8A8 tree is built and no
later mode needs them, as the JAX tool deletes them.

For each mode: one ``generate_images`` call at seed 2 (the entry point:
labels -> 10 scales -> golden f32 pixels; the first call also loads the
kernels), one ``decode_all_scales`` at seed 2 into a cache that every later
decode of the mode reuses, ``repeats`` timed decodes at seeds 3, 4, ...
(the best printed, as the JAX tool's best of 3), and one more decode at
seed 2, whose ids must equal the first's. Then the 512px pixel decoders on
the seed-2 latent, each called twice and timed on the second call: the
golden f32 decoder (its image bit-equal to
``generate_images``'), the channels-last bf16 decoder and the all-int8
decoder, its W8A8 sites calibrated once on the first mode's latent as the
server's ``pixq`` is (alpha 0.75, sites narrower than 256 pixels left
bf16). Every line carries the card's name and power limit.
"""

from __future__ import annotations

import sys
import time

import torch

from sdvar_tpu_torch.config import (
    PATCH_NUMS_512,
    SamplingConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales, generate_images
from sdvar_tpu_torch.models.var import count_params, init_var_params
from sdvar_tpu_torch.models.vqvae import (
    calibrate_decoder_w8a8,
    fhat_to_img,
    fhat_to_img_nhwc,
    fhat_to_img_nhwc_w8a8_static,
    init_vqvae_params,
)
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

MODES = ("bf16", "w8a8", "w8a8-int8kv")
SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
PIXELS = ("f32", "nhwc-bf16", "nhwc-int8")
PIXEL_CALLS = 2  # a pixel decoder's first call picks cuDNN's algorithms


def _timed(fn, dev):
    """(fn's result, its wall seconds up to the card's last write)."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def _peak_gib(dev) -> float:
    if dev.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def run_modes(tag: str, var_cfg: VARConfig, vae_cfg: VQVAEConfig,
              batch: int, modes, repeats: int, dev: torch.device,
              entry: bool, pixels) -> dict:
    """Random bf16 weights from seeds 0 (VAR) and 1 (VQVAE), then decode
    ``batch`` labels (``arange(batch) % 1000``) in each mode and the
    seed-2 latent with each of ``pixels`` (names of ``PIXELS``);
    ``entry``: also one ``generate_images`` call a mode. The bf16 weights
    are dropped once no later mode needs them (this function holds the
    only reference). Returns {mode: figures}, every figure measured in
    this call."""
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} ({' | '.join(MODES)})")
    for name in pixels:
        if name not in PIXELS:
            raise ValueError(f"unknown pixel decoder {name!r} "
                             f"({' | '.join(PIXELS)})")
    print(f"[{tag}] {_cfg_name(var_cfg)}: C={var_cfg.embed_dim} "
          f"L={var_cfg.L}{', shared AdaLN' if var_cfg.shared_aln else ''}",
          flush=True)
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    vae = init_vqvae_params(vae_cfg, seed=1, device=dev)
    synchronize(dev)
    print(f"[{tag}] init {time.time() - t0:.1f} s, "
          f"{count_params(params) / 1e9:.3f} B parameters", flush=True)
    card = card_name(dev)
    labels = torch.arange(batch) % 1000
    quantized, sites, out = None, None, {}
    for i, mode in enumerate(modes):
        if mode.startswith("w8a8") and quantized is None:
            quantized = quantize_var_params(params, mode="w8a8")
        p = quantized if mode.startswith("w8a8") else params
        if not any(m == "bf16" for m in modes[i:]):
            params = None  # the replaced bf16 weights go with the tree
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        kv_mode = "int8" if mode.endswith("int8kv") else "bf16"
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def decode(seed, cache=None):
            return decode_all_scales(
                var_cfg, vae_cfg, p, vae["quant"], labels, seed, SAMP,
                torch.bfloat16, return_ids=True, kv_mode=kv_mode, cache=cache,
                return_cache=True, device=dev)

        # the decodes into the returned cache after the first capture the
        # block stack's CUDA graphs and replay them
        row = {"batch": batch, "card": card, "decodes": repeats + 2 + entry,
               "replays": repeats}
        image = None
        if entry:
            image, row["entry_s"] = _timed(lambda: generate_images(
                var_cfg, vae_cfg, p, vae, labels, 2, SAMP, torch.bfloat16,
                kv_mode=kv_mode, device=dev), dev)
        (f_hat, ids2, cache), row["first_s"] = _timed(lambda: decode(2), dev)
        times, ids3 = [], None
        for r in range(repeats):
            (_, ids, cache), t = _timed(lambda: decode(3 + r, cache), dev)
            times.append(t)
            ids3 = ids if ids3 is None else ids3
        (_, again, cache), _ = _timed(lambda: decode(2, cache), dev)
        best = min(times)
        row.update(ms=best * 1e3, times_ms=[t * 1e3 for t in times],
                   img_per_s=batch / best, peak_gib=_peak_gib(dev),
                   same_seed_ids_equal=bool(torch.equal(ids2, again)),
                   other_seed_ids_differ=(float((ids2 != ids3).float().mean())
                                          if ids3 is not None else None),
                   ids=ids2, f_hat=f_hat, image=image)
        del cache
        print(f"[{tag}] {_cfg_name(var_cfg)} {mode} B={batch}: "
              f"{row['ms']:.1f} ms/batch, {row['img_per_s']:.3f} img/s "
              f"(times={['%.1f' % t for t in row['times_ms']]}; first "
              f"{row['first_s']:.1f} s), peak {row['peak_gib']:.2f} GiB; "
              f"seed 2 twice: ids {'equal' if row['same_seed_ids_equal'] else 'DIFFER'}"
              f"; card: {card}", flush=True)
        gold, row["pixels"] = None, {}
        for name in pixels:
            if name == "nhwc-int8" and sites is None:
                sites = calibrate_decoder_w8a8(vae_cfg, vae, [f_hat],
                                               alpha=0.75, min_w=256)
            fn = {"f32": lambda: fhat_to_img(vae_cfg, vae, f_hat),
                  "nhwc-bf16": lambda: fhat_to_img_nhwc(vae_cfg, vae, f_hat),
                  "nhwc-int8": lambda: fhat_to_img_nhwc_w8a8_static(
                      vae_cfg, vae, f_hat, sites)}[name]
            with torch.inference_mode():
                times = [_timed(fn, dev) for _ in range(PIXEL_CALLS)]
            img = (times[0][0] + 1.0) * 0.5
            t = min(t for _, t in times[1:])
            if name == "f32":
                gold = img
            pix = {"ms": t * 1e3, "img_per_s": batch / t, "calls": PIXEL_CALLS,
                   "shape": tuple(img.shape), "image": img,
                   "mean_abs_diff": (float((img - gold).abs().mean())
                                     if gold is not None else None)}
            if name == "nhwc-int8":
                pix["sites_quantized"] = sum(s is not None for s in sites)
                pix["sites"] = len(sites)
            row["pixels"][name] = pix
            diff = ("" if pix["mean_abs_diff"] is None
                    else f", mean|d| from f32 {pix['mean_abs_diff']:.5f}")
            print(f"[{tag}] {mode} pixels {name} {pix['shape']}: "
                  f"{pix['ms']:.1f} ms ({pix['img_per_s']:.2f} img/s){diff}",
                  flush=True)
        if image is not None and gold is not None:
            row["entry_equals_f32"] = bool(torch.equal(image, gold))
        out[mode] = row
    return out


def _cfg_name(cfg: VARConfig) -> str:
    return f"VAR-d{cfg.depth} {cfg.patch_nums[-1] * 16}px"


def run(batch: int = 4, modes=("bf16", "w8a8"), repeats: int = 3,
        device="cuda") -> dict:
    """VAR-d36 512px with shared AdaLN in each mode, then the three pixel
    decoders at 512px; returns ``run_modes``' figures."""
    return run_modes("512", VARConfig(depth=36, patch_nums=PATCH_NUMS_512,
                                      shared_aln=True),
                     VQVAEConfig(patch_nums=PATCH_NUMS_512), batch,
                     tuple(modes), repeats, resolve_device(device),
                     entry=True, pixels=PIXELS)


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
        tuple(sys.argv[2:]) or ("bf16", "w8a8"))
