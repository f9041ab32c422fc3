#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the port's kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version on the card, drives the main path
(VAR-d30 256px class-conditional generation, B=16, bf16, random weights
from a seed) as a server answering a few requests, checks the outputs, and
times the kernels. The last stdout line is
``{"ok": true, "device": {...}}``; any failed phase raises and the script
exits non-zero without printing it. It needs a CUDA card and the
``sdvar_tpu_torch`` package beside it, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales, generate_images
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import fhat_to_img, init_vqvae_params
from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.attention import (
    attention_kernel,
    attention_plain,
    smem_bytes,
)
from sdvar_tpu_torch.ops.kernels.sampling import sample_kernel, sample_plain
from sdvar_tpu_torch.utils.device import full_f32

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores; and the int32 instruction rate from
# the SM's unit counts: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INT32_OPS = 64 * 132 * 1.98e9

B = 16             # requests per batch (2B = 32 rows under CFG)
N_BATCHES = 3
DEPTH = 30


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(Bq, Lq, Lk, H, hd, itemsize):
    """(bound ms, bound_by): q, k, v read once, o written once, vs
    4*B*H*Lq*Lk*hd FLOPs at the input type's peak."""
    nbytes = itemsize * H * hd * Bq * (2 * Lq + 2 * Lk)
    flops = 4 * Bq * H * Lq * Lk * hd
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sampler_bound(M, V, n_topk):
    """(bound ms, bound_by) of the sampling function, not of this kernel's
    bisection: the logits and row seeds read once and the ids written once,
    vs the operations the function needs, all priced at the int32 rate (the
    slowest of its types). Per logit, one radix-select pass finds the top-k
    threshold (ordered image, digit, count: 4). Per logit that top-k keeps
    (``n_topk``, counted on this run's data): the exp and sum for the
    nucleus (3), one radix-select pass on the masses (4), the row hash and
    Gumbel transform (16) and the argmax (2)."""
    nbytes = M * V * 4 + M * 8
    ops = M * V * 4 + n_topk * 25
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}, {torch.cuda.device_count()} card(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.build(["attention"])
    log(f"[build] csrc/attention.cu built in {time.time() - t0:.1f} s")
    for line in _build.build_log("attention").splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
            log(f"[build] {line.strip()}")
    log("[build] attention shared memory per block: " + ", ".join(
        f"{str(dt)[6:]} hd={hd}: {smem_bytes(hd, dt)} B"
        for dt in (torch.bfloat16, torch.float32) for hd in (32, 64, 128)))
    return name


def phase_kernel_checks():
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    Bq, H, hd, Lmax = 2 * B, DEPTH, 64, 680
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        cache = torch.randn(2, Bq, Lmax, H * hd, device=dev, generator=g).to(dtype)
        for Lq, Lk in ((1, 1), (64, 155), (169, 424), (256, 680)):
            q = torch.randn(Bq, Lq, H, hd, device=dev, generator=g)
            q = torch.nn.functional.normalize(q, dim=-1).mul_(4.0).to(dtype)
            # unit keys written back into the cache, so that k and v both
            # reach the kernel as strided cache slices, as on the main path
            k = cache[0, :, :Lk].view(Bq, Lk, H, hd)
            k.copy_(torch.nn.functional.normalize(k.float(), dim=-1))
            v = cache[1, :, :Lk].view(Bq, Lk, H, hd)
            got = attention_kernel(q, k, v, None, 1.0).float()
            torch.cuda.synchronize()
            want = attention_plain(q.float(), k.float(), v.float(), None, 1.0)
            err = (got - want).abs().max().item()
            if dtype == torch.float32:
                ok = err <= 1e-4
            else:
                ok = torch.allclose(got, want, rtol=2e-2, atol=2e-2)
            log(f"[check] attention {str(dtype)[6:]} Lq={Lq} Lk={Lk}: "
                f"max|d|={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"attention kernel disagrees at {Lq}x{Lk}")
            errs[(dtype, Lq, Lk)] = err
    # additive bias with -inf entries and one fully masked row, f32
    Lq, Lk = 100, 255
    q = torch.randn(Bq, Lq, H, hd, device=dev, generator=g) * 0.2
    k = torch.randn(Bq, Lk, H, hd, device=dev, generator=g) * 0.2
    v = torch.randn(Bq, Lk, H, hd, device=dev, generator=g)
    bias = torch.randn(Lq, Lk, device=dev, generator=g)
    bias[:, ::3] = float("-inf")
    bias[-1] = float("-inf")
    got = attention_kernel(q, k, v, bias, 1.0)
    want = attention_plain(q, k, v, bias, 1.0)
    err = (got - want).abs().max().item()
    ok = err <= 1e-4 and not got[:, -1].any() and torch.isfinite(got).all()
    log(f"[check] attention f32 with -inf bias and a masked row: "
        f"max|d|={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("attention kernel disagrees under a bias")

    M, V = 4096, 4096
    logits = torch.randn(M, V, device=dev, generator=g) * 4
    noise = -torch.log(-torch.log(
        torch.rand(M, V, device=dev, generator=g).clamp_(1e-7, 1 - 1e-7)))
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=dev,
                          generator=g, dtype=torch.int32)
    smp = {}
    for top_k, top_p in ((900, 0.96), (900, 0.0), (1, 0.0)):
        ids, mask = sample_kernel(logits, None, top_k, top_p, noise=noise,
                          return_mask=True)
        ids_p, mask_p = sample_plain(logits, None, top_k, top_p, noise=noise,
                              return_mask=True)
        rows = ((mask == mask_p).all(-1) & (ids == ids_p)).float().mean().item()
        hashed = (sample_kernel(logits, seeds, top_k, top_p)
                  == sample_plain(logits, seeds, top_k, top_p)).float().mean().item()
        need = 1.0 if top_p == 0.0 else 0.999
        ok = rows >= need and hashed >= 0.999
        log(f"[check] sampler top_k={top_k} top_p={top_p}: rows equal with "
            f"noise {rows:.6f} (need {need}), ids equal on the row-hash path "
            f"{hashed:.6f} (need 0.999) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sampler kernel disagrees at {top_k}/{top_p}")
        smp[(top_k, top_p)] = ((mask.int() - mask_p.int()).abs().max().item(),
                               rows, hashed)
    return errs, smp


def phase_main_path(name):
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vqvae_params(vae_cfg, seed=1, device="cuda", eini=1.0)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"[main] VAR-d{DEPTH} ({n_par / 1e9:.3f} B params, bf16) and VQVAE "
        f"initialised on the card in {time.time() - t0:.1f} s")
    labels = [torch.arange(B) * 61 % 1000, torch.arange(B) * 7 + 100,
              torch.full((B,), 207)]
    seeds = [1, 2, 3]
    # warm-up (Triton compiles the main-path specialisation here)
    generate_images(var_cfg, vae_cfg, params, vae, labels[0], 0, samp)
    torch.cuda.synchronize()

    attention_kernel.launches = 0
    sample_kernel.launches = 0
    imgs = []
    for lab, seed in zip(labels, seeds):
        t0 = time.time()
        img = generate_images(var_cfg, vae_cfg, params, vae, lab, seed, samp)
        torch.cuda.synchronize()
        imgs.append(img)
        log(f"[main] request batch seed={seed}: {tuple(img.shape)} in "
            f"{(time.time() - t0) * 1e3:.1f} ms")
    launches = {"attention": attention_kernel.launches,
                "sampler": sample_kernel.launches}
    log(f"[main] kernel launches over {N_BATCHES} decodes: {launches}")
    if launches != {"attention": 300 * N_BATCHES, "sampler": 10 * N_BATCHES}:
        raise AssertionError(f"main path launch counts {launches} != "
                             f"{300 * N_BATCHES} attention, {10 * N_BATCHES} sampler")
    for img in imgs:
        if img.shape != (B, 3, 256, 256) or not torch.isfinite(img).all() \
                or img.min() < 0 or img.max() > 1:
            raise AssertionError(f"bad images: {tuple(img.shape)} "
                                 f"[{img.min().item()}, {img.max().item()}]")
    log("[main] images finite, in [0, 1], shape (16, 3, 256, 256)")

    ids = [decode_all_scales(var_cfg, vae_cfg, params, vae["quant"], labels[0],
                             s, samp, return_ids=True)[1] for s in (5, 5, 6)]
    if not torch.equal(ids[0], ids[1]) or torch.equal(ids[0], ids[2]):
        raise AssertionError("same seed must give the same ids, another "
                             "seed other ids")
    log(f"[main] seed 5 twice: identical ids; seed 6: "
        f"{(ids[0] != ids[2]).float().mean().item():.3f} of ids differ")

    torch.cuda.reset_peak_memory_stats()
    lat, pix = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        f_hat = decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                                  labels[i], 10 + i, samp)
        torch.cuda.synchronize()
        t1 = time.time()
        with torch.inference_mode():
            fhat_to_img(vae_cfg, vae, f_hat)
        torch.cuda.synchronize()
        lat.append((t1 - t0) * 1e3)
        pix.append((time.time() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lat_ms, pix_ms = min(lat), min(pix)
    log(f"[main] {name}: latent decode {lat_ms:.1f} ms "
        f"(runs {', '.join(f'{t:.1f}' for t in lat)}), pixel decode "
        f"{pix_ms:.1f} ms (runs {', '.join(f'{t:.1f}' for t in pix)}), "
        f"{B / ((lat_ms + pix_ms) / 1e3):.2f} img/s at B={B}, "
        f"peak memory {peak:.2f} GiB")
    del params, vae
    return launches


def phase_small_reference():
    """The whole CUDA path against the CPU plain path on a small stack
    (depth 2, patch_nums (1, 2, 3)), greedy and f32: equal ids, close
    images."""
    pns = (1, 2, 3)
    vc = VARConfig(depth=2, num_classes=10, patch_nums=pns, vocab_size=64,
                   Cvae=8, head_dim=32)
    qc = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=pns)
    samp = SamplingConfig(cfg=1.5, top_k=1)
    out = {}
    for dev in ("cpu", "cuda"):
        p = init_var_params(vc, seed=3, device="cpu")
        p["head"]["w"].normal_(0, 0.05, generator=torch.Generator().manual_seed(4))
        q = init_vqvae_params(qc, seed=4, device="cpu", eini=1.0)
        p, q = _to(p, dev), _to(q, dev)
        f_hat, ids = decode_all_scales(vc, qc, p, q["quant"], [3, 7], 0, samp,
                                       torch.float32, return_ids=True,
                                       device=dev)
        with torch.inference_mode():
            out[dev] = (ids.cpu(), fhat_to_img(qc, q, f_hat).cpu())
    same_ids = torch.equal(out["cpu"][0], out["cuda"][0])
    err = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
    log(f"[reference] small stack, card vs CPU plain path: ids equal "
        f"{same_ids}, image max|d| {err:.2e} (limit 1e-3)")
    if not same_ids or err > 1e-3:
        raise AssertionError("card path disagrees with the CPU reference")


def phase_kernel_times(launches, errs, smp):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    Bq, H, hd, Lmax = 2 * B, DEPTH, 64, 680
    cache = torch.randn(2, Bq, Lmax, H * hd, device=dev, generator=g).to(torch.bfloat16)

    def att_inputs(Lq, Lk):
        q = torch.randn(Bq, Lq, H, hd, device=dev, generator=g).to(torch.bfloat16)
        return (q, cache[0, :, :Lk].view(Bq, Lk, H, hd),
                cache[1, :, :Lk].view(Bq, Lk, H, hd))

    per_scale, total = [], 0.0
    cur = 0
    for pn in (1, 2, 3, 4, 5, 6, 8, 10, 13, 16):
        cur += pn * pn
        q, k, v = att_inputs(pn * pn, cur)
        ms = cuda_ms(lambda: attention_kernel(q, k, v, None, 1.0), 20)
        per_scale.append(f"{pn * pn}x{cur}:{ms * 1e3:.1f}us")
        total += ms * DEPTH
    log(f"[time] attention kernel per scale (Lq x Lk: us per launch) "
        f"{' '.join(per_scale)}; x{DEPTH} layers = {total:.2f} ms per decode")

    q, k, v = att_inputs(256, 680)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    a_ms = cuda_ms(lambda: attention_kernel(q, k, v, None, 1.0), 50)
    a_plain = cuda_ms(lambda: attention_plain(q, k, v, None, 1.0), 10)
    a_lib = cuda_ms(lambda: sdpa(qt, kt, vt, scale=1.0), 50)
    a_bound, a_by = attention_bound(Bq, 256, 680, H, hd, 2)
    log(f"[time] attention scale 9 (2B=32 Lq=256 Lk=680 H=30 hd=64 bf16): "
        f"kernel_ms {a_ms:.4f} plain_ms {a_plain:.4f} library_ms "
        f"{a_lib:.4f} (scaled_dot_product_attention) bound_ms {a_bound:.4f} "
        f"({a_by}) launches/decode {launches['attention'] // N_BATCHES}")

    M, V = B * 256, 4096
    logits = torch.randn(M, V, device=dev, generator=g) * 4
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=dev,
                          generator=g, dtype=torch.int32)
    s_ms = cuda_ms(lambda: sample_kernel(logits, seeds, 900, 0.96), 50)
    s_plain = cuda_ms(lambda: sample_plain(logits, seeds, 900, 0.96), 5, warmup=1)
    n_topk = sample_plain(logits, seeds, 900, 0.0, return_mask=True)[1].sum()
    s_bound, s_by = sampler_bound(M, V, n_topk.item())
    s_total = 0.0
    for pn in (1, 2, 3, 4, 5, 6, 8, 10, 13, 16):
        lg, sd = logits[: B * pn * pn], seeds[: B * pn * pn]
        s_total += cuda_ms(lambda: sample_kernel(lg, sd, 900, 0.96), 10)
    log(f"[time] sampler scale 9 (M=4096 V=4096 top_k=900 top_p=0.96): "
        f"kernel_ms {s_ms:.4f} plain_ms {s_plain:.4f} library_ms none "
        f"bound_ms {s_bound:.4f} ({s_by}) launches/decode "
        f"{launches['sampler'] // N_BATCHES}; all 10 scales {s_total:.3f} ms "
        f"per decode")

    kernels = [
        {"name": "attention", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/attention.cu",
         "replaces": "sdvar_tpu/ops/pallas/attention.py:46",
         "launches": launches["attention"],
         "max_abs_err": errs[(torch.bfloat16, 256, 680)],
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": a_lib},
        {"name": "sampler", "route": "triton",
         "source": "sdvar_tpu_torch/ops/kernels/sampling.py",
         "replaces": "sdvar_tpu/ops/pallas/sampling.py:79",
         "launches": launches["sampler"],
         "max_abs_err": float(smp[(900, 0.96)][0]),
         "rows_equal": smp[(900, 0.96)][1],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None},
    ]
    return kernels


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.time()
    name = phase_device_and_build()
    with full_f32():  # the plain f32 attention's einsums, as the kernel's
        errs, smp = phase_kernel_checks()
    launches = phase_main_path(name)
    phase_small_reference()
    with full_f32():
        kernels = phase_kernel_times(launches, errs, smp)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
