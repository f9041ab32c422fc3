"""Does an image's pixels depend on its slot in the batch?

    python3 -m sdvar_tpu_torch.tools.probe_slot_invariance

Decodes one B=16 f_hat (256px VQVAE, random weights and latents from a
seed) with the channels-last bf16 decoder and the calibrated W8A8 decoder,
then the same f_hat with its rows permuted, and counts the images whose
bits differ; once with every conv batched (``PER_IMAGE_MAX_W = 0``) and
once as shipped (3x3 convs up to ``PER_IMAGE_MAX_W`` wide one image per
call), with each decoder's time (CUDA events, best of 3). Then it lists,
for every conv of the batched bf16 decoder, how many of 16 images change
their bits when the rows are permuted. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import types

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ

BATCH = 16
PERM = torch.tensor([5, 0, 12, 3, 9, 14, 1, 7, 15, 2, 10, 4, 13, 6, 11, 8])


def _best_ms(fn, n=3):
    fn()
    best = float("inf")
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _slot_dependent(y, y_perm):
    """Images of the permuted run whose bits differ from the unpermuted
    run's, and the largest difference."""
    d = (y[PERM] - y_perm).abs().flatten(1).amax(dim=1)
    return int((d > 0).sum()), d.max().item()


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; cuDNN {torch.backends.cudnn.version()}, "
          f"torch {torch.__version__}")
    cfg = VQVAEConfig()
    vae = VQ.init_vqvae_params(cfg, seed=1, eini=1.0)
    g = torch.Generator(device="cuda").manual_seed(0)
    f = torch.randn(BATCH, cfg.Cvae, 16, 16, device="cuda", generator=g) * 0.5
    cal = [torch.randn(8, cfg.Cvae, 16, 16, device="cuda", generator=g) * 0.5
           for _ in range(2)]
    sites = VQ.calibrate_decoder_w8a8(cfg, vae, cal, alpha=0.75, min_w=256)
    decoders = {"bf16": lambda t: VQ.fhat_to_img_nhwc(cfg, vae, t),
                "w8a8": lambda t: VQ.fhat_to_img_nhwc_w8a8_static(cfg, vae, t, sites)}
    shipped = VQ.PER_IMAGE_MAX_W
    try:
        for max_w in (0, shipped):
            VQ.PER_IMAGE_MAX_W = max_w
            for name, fn in decoders.items():
                with torch.inference_mode():
                    n, dmax = _slot_dependent(fn(f), fn(f[PERM].contiguous()))
                    ms = _best_ms(lambda: fn(f))
                print(f"PER_IMAGE_MAX_W={max_w} {name} decoder B={BATCH}: "
                      f"{n}/{BATCH} images slot-dependent (max |d| "
                      f"{dmax:.3e}), {ms:.3f} ms")
        VQ.PER_IMAGE_MAX_W = 0
        seen = {}

        def spy(x, w, b=None, stride=1, padding=0):
            y = F.conv2d(x, w, b, stride, padding)
            y_perm = F.conv2d(x[PERM].contiguous(memory_format=torch.channels_last),
                              w, b, stride, padding)
            key = (tuple(x.shape[1:]), tuple(w.shape))
            seen[key] = max(seen.get(key, 0), _slot_dependent(y, y_perm)[0])
            return y

        VQ.F = types.SimpleNamespace(conv2d=spy, interpolate=F.interpolate)
        with torch.inference_mode():
            VQ.fhat_to_img_nhwc(cfg, vae, f)
    finally:
        VQ.F, VQ.PER_IMAGE_MAX_W = F, shipped
    print("batched bf16 convs, input (C, H, W), weight (O, C, kh, kw): "
          "images slot-dependent of 16")
    for (xs, ws), n in seen.items():
        print(f"   {str(xs):<16} {str(ws):<20} {n}")


if __name__ == "__main__":
    main()
