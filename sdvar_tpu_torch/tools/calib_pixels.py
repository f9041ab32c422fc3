"""The calibrated W8A8 pixel decoder's verdict on the card (the counterpart
of the repository's ``tools/calib_pixels.py``).

    python -m sdvar_tpu_torch.tools.calib_pixels [--train-vae 400] \\
        [--vae-bs 8] [--vae-lr 3e-4] [--batch 16] [--iters 5] \\
        [--alpha 0.65] [--cal-batches 4] [--device cpu]

  1. ``--train-vae`` SGD steps of ``train.vae_trainer.vae_train_step`` on
     ``StructuredSynthImages(length=4096, seed=123)`` (256px), so that the
     decoder's channel ranges are trained-skewed, the regime per-channel
     scales exist for (0: the random weights);
  2. calibration and eval f_hats encoded from held-out images of the same
     dataset (``Q.encode(..., return_fhat=True)``);
  3. mean |pixel delta| against the golden f32 decoder and the best wall
     time of ``--iters`` calls (host clock around a synchronisation) of
     the channels-last bf16 decoder, the dynamic W8A8 decoder (kernel row
     6, ``conv3x3_s8``, at every eligible 3x3 site) and six static
     calibrations (``calibrate_decoder_w8a8`` at (alpha, min_w),
     ``fhat_to_img_nhwc_w8a8_static``: row 6 at each quantized site).

The verdict: PASS where the best calibration's mean |delta| is within 2x
the bf16 decoder's, else NEGATIVE. Each decoder's row-6 launches per call
are counted (0 on the CPU, where the plain conv runs). Random weights from
seed 0; every line of times follows the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sdvar_tpu_torch.config import VQVAEConfig, patch_nums_for_reso
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.ops.kernels.conv_s8 import conv3x3_s8_kernel
from sdvar_tpu_torch.train.data import StructuredSynthImages
from sdvar_tpu_torch.train.vae_trainer import init_vae_train_state, vae_train_step
from sdvar_tpu_torch.utils.device import (
    card_name,
    full_f32,
    resolve_device,
    synchronize,
)

CALIBRATIONS = ((None, 0), (0.75, 0), (0.85, 0), (0.75, 128), (0.9, 128),
                (0.75, 256))  # (alpha, min_w); None: --alpha


def run(train_vae: int = 400, vae_bs: int = 8, vae_lr: float = 3e-4,
        batch: int = 16, iters: int = 5, alpha: float = 0.65,
        cal_batches: int = 4, device="cuda") -> dict:
    dev = resolve_device(device)
    card = card_name(dev)
    print(f"[pixels] card: {card}", flush=True)
    cfg = VQVAEConfig(patch_nums=patch_nums_for_reso(256))
    params = VQ.init_vqvae_params(cfg, seed=0, device=dev)
    # the tokenizer's image side: 256 at the 256px preset
    side = cfg.downsample * cfg.patch_nums[-1]
    ds = StructuredSynthImages(reso=side, num_classes=16, length=4096, seed=123)

    def images(i0, n):
        return torch.from_numpy(np.stack([ds[i][0] for i in range(i0, i0 + n)])
                                ).to(dev)

    out = {"card": card}
    if train_vae:
        st = init_vae_train_state(cfg, params)
        t0 = time.time()
        first = last = None
        for it in range(train_vae):
            st, m = vae_train_step(cfg, st, images((it * vae_bs) % 3072, vae_bs),
                                   vae_lr)
            if it == 0:
                first = float(m["rec_loss"])
            if it % 50 == 0 or it == train_vae - 1:
                last = float(m["rec_loss"])
                print(f"[vae {it}] rec={last:.4f} vq={float(m['vq_loss']):.4f}",
                      flush=True)
        params = st.params
        out["vae"] = {"steps": train_vae, "rec_first": first, "rec_last": last,
                      "minutes": (time.time() - t0) / 60}
        print(f"[vae] {train_vae} steps in {(time.time() - t0) / 60:.1f} min "
              f"rec {first:.4f} -> {last:.4f}", flush=True)

    @torch.no_grad()
    def to_fhat(img):
        with full_f32():
            return Q.encode(cfg, params["quant"], VQ.img_to_f(cfg, params, img),
                            return_fhat=True)[-1]

    cal = [to_fhat(images(3072 + i * batch, batch)) for i in range(cal_batches)]
    ev = to_fhat(images(3072 + cal_batches * batch, batch))
    gold = VQ.fhat_to_img(cfg, params, ev)
    rows = {}

    def measure(name, fn):
        n0 = conv3x3_s8_kernel.launches
        img = fn(ev)
        synchronize(dev)
        launches = conv3x3_s8_kernel.launches - n0
        err = float((img - gold).abs().mean())
        t = []
        for _ in range(iters):
            synchronize(dev)
            t0 = time.perf_counter()
            fn(ev)
            synchronize(dev)
            t.append(time.perf_counter() - t0)
        print(f"[pixels] {name:24s} mean|d|={err:.5f} "
              f"wall={min(t) * 1e3:.1f} ms (B={batch}) conv3x3_s8 launches "
              f"{launches}", flush=True)
        rows[name] = {"mean_abs_diff": err, "ms": min(t) * 1e3,
                      "conv_launches": launches}
        return err, min(t) * 1e3

    e_bf, t_bf = measure("nhwc_bf16", lambda z: VQ.fhat_to_img_nhwc(cfg, params, z))
    e_dy, _ = measure("w8a8_dynamic",
                      lambda z: VQ.fhat_to_img_nhwc_w8a8(cfg, params, z))
    best = (float("inf"), None, None, None)
    n_sites = None
    for a, min_w in CALIBRATIONS:
        a = alpha if a is None else a
        sites = VQ.calibrate_decoder_w8a8(cfg, params, cal, alpha=a, min_w=min_w)
        n_sites = len(sites)
        nq = sum(s is not None for s in sites)
        name = f"calib a={a} w>={min_w} ({nq}q)"
        e, t = measure(name, lambda z, s=sites: VQ.fhat_to_img_nhwc_w8a8_static(
            cfg, params, z, s))
        rows[name]["sites_quantized"] = nq
        if e < best[0]:
            best = (e, t, a, min_w)
    e_st, t_st, b_a, b_w = best
    verdict = "PASS" if e_st <= 2.0 * e_bf else "NEGATIVE"
    print(f"[verdict] {verdict}: best calibrated (alpha={b_a}, min_w={b_w}) "
          f"{e_st:.5f} vs bf16-class {e_bf:.5f} (2x gate {2 * e_bf:.5f}); "
          f"dynamic was {e_dy:.5f}; wall bf16 {t_bf:.1f} -> calib "
          f"{t_st:.1f} ms", flush=True)
    out.update(rows=rows, sites=n_sites, verdict=verdict, best_err=e_st,
               bf16_err=e_bf, dynamic_err=e_dy, best=(b_a, b_w))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-vae", type=int, default=400,
                    help="VQVAE SGD steps before the verdict (0 = random "
                         "weights)")
    ap.add_argument("--vae-bs", type=int, default=8)
    ap.add_argument("--vae-lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=0.65)
    ap.add_argument("--cal-batches", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    run(a.train_vae, a.vae_bs, a.vae_lr, a.batch, a.iters, a.alpha,
        a.cal_batches, device=a.device)


if __name__ == "__main__":
    main()
