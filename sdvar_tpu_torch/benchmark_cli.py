"""Benchmark and evaluation CLI of the speculative engine (the counterpart of
``sdvar_tpu/benchmark_cli.py``, itself the reference notebook
``sdvar_colab_test.py`` as a CLI). Five modes, each printing one JSON row
per case with the JAX package's keys:

  gamma     gamma in {1, 2, 3}: wall time and acceptance counters
  seqspec   target-only decode against speculative decoding, with the
            target calls counted (10 against about 5 in theory)
  quality   latent MSE and acceptance of speculative against target-only
  quant     target-only decode with bf16 weights against w8, fp8, w8a8 and
            w8a8 + INT8 KV on the same seed: token agreement over all ids
            and per scale, latent MSE, wall time (build without --quant)
  handoff   the sd_mask 0..5 ablation of the static handoff

Seeds take the place of the JAX package's keys: ``PRNGKey(seed)`` is the
int ``seed`` (one stream per request, ``ops.sampling.request_seeds``), and
``fold_in(key, i)`` is the per-request seeds
``fold_seeds(request_seeds(seed, B), i)``.

    python -m sdvar_tpu_torch.benchmark_cli --mode gamma --depth-draft 16 \\
        --depth-target 30 --batch 8

Checkpoints (``--ckpt-vae``, ``--ckpt-draft``, ``--ckpt-target``: the
reference model zoo's ``vae_ch160v4096z32.pth``, ``var_d16.pth``,
``var_d30.pth``) load through ``utils.torch_port``; without them the weights
are random, made from ``--seed``: the timings hold, quality and acceptance
numbers mean nothing. It runs on the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from sdvar_tpu_torch.config import (
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.ops.sampling import fold_seeds, request_seeds
from sdvar_tpu_torch.utils.torch_port import (
    var_params_from_torch,
    vqvae_params_from_torch,
)


def build_engine(args, device="cuda") -> SpeculativeEngine:
    pns = tuple(int(p) for p in args.patch_nums.split("_"))
    vae_cfg = VQVAEConfig(patch_nums=pns)
    draft_cfg = VARConfig(depth=args.depth_draft, patch_nums=pns)
    target_cfg = VARConfig(depth=args.depth_target, patch_nums=pns)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if args.ckpt_draft:
        def load(path):
            return torch.load(path, map_location="cpu")
        draft_params = var_params_from_torch(draft_cfg, load(args.ckpt_draft), device)
        target_params = var_params_from_torch(target_cfg, load(args.ckpt_target), device)
        vae_params = vqvae_params_from_torch(vae_cfg, load(args.ckpt_vae), device)
    else:
        print("[bench-cli] no checkpoints given: using random weights "
              "(timings valid; quality/acceptance numbers not meaningful)",
              flush=True)
        draft_params = init_var_params(draft_cfg, seed=args.seed + 1,
                                       device=device, dtype=dtype)
        target_params = init_var_params(target_cfg, seed=args.seed + 2,
                                        device=device, dtype=dtype)
        vae_params = init_vqvae_params(vae_cfg, seed=args.seed + 3,
                                       device=device, eini=1.0)
    if args.quant != "none":
        draft_params = quantize_var_params(draft_params, mode=args.quant)
        target_params = quantize_var_params(target_params, mode=args.quant)
        print(f"[bench-cli] quantized draft+target weights: {args.quant}",
              flush=True)
    return SpeculativeEngine(vae_cfg, draft_cfg, target_cfg, vae_params,
                             draft_params, target_params, dtype=dtype,
                             device=device)


def benchmark_config(args) -> SamplingConfig:
    # the notebook's benchmark settings (sdvar_colab_test.py:88-129)
    return SamplingConfig(cfg=args.cfg, top_k=args.top_k, top_p=args.top_p)


def _labels(eng, args) -> torch.Tensor:
    return torch.tensor(args.labels[: args.batch], device=eng.device)


def _fold(args, n: int, i: int) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), i)`` as per-request seeds."""
    return fold_seeds(request_seeds(args.seed, n, "cpu"), i)


def _sync(eng) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def mode_gamma(eng: SpeculativeEngine, args):
    """gamma sweep with wall time and acceptance counters."""
    samp, labels, rows = benchmark_config(args), _labels(eng, args), []
    for gamma in (1, 2, 3):
        spec = SpeculativeConfig(gamma=gamma)
        eng.generate_speculative(labels, args.seed, spec, samp)  # warm-up
        _sync(eng)
        t0 = time.time()
        for i in range(args.iters):
            f_hat, stats = eng.generate_speculative(
                labels, _fold(args, len(labels), i), spec, samp)
        _sync(eng)
        dt = (time.time() - t0) / args.iters
        _emit(rows, {"gamma": gamma, "sec_per_batch": round(dt, 4),
                     "images_per_sec": round(len(labels) / dt, 3),
                     **stats.as_dict()})
    return rows


def _target_decode(eng, params, labels, seed, samp, **kw):
    return decode_all_scales(eng.target_cfg, eng.vae_cfg, params,
                             eng.quant_params, labels, seed, samp, eng.dtype,
                             device=eng.device, **kw)


def mode_seq_vs_spec(eng: SpeculativeEngine, args):
    """Sequential target-only against speculative, with the target calls
    counted (sdvar_colab_test.py:267-331)."""
    samp, labels = benchmark_config(args), _labels(eng, args)
    _target_decode(eng, eng.target_params, labels, args.seed, samp)
    _sync(eng)
    t0 = time.time()
    for i in range(args.iters):
        _target_decode(eng, eng.target_params, labels,
                       _fold(args, len(labels), i), samp)
    _sync(eng)
    seq_dt = (time.time() - t0) / args.iters

    spec = SpeculativeConfig(gamma=args.gamma)
    eng.generate_speculative(labels, args.seed, spec, samp)
    _sync(eng)
    t0 = time.time()
    for i in range(args.iters):
        f_hat, stats = eng.generate_speculative(
            labels, _fold(args, len(labels), i), spec, samp)
    _sync(eng)
    spec_dt = (time.time() - t0) / args.iters

    S = eng.num_scales
    row = {
        "sequential_sec": round(seq_dt, 4),
        "speculative_sec": round(spec_dt, 4),
        "speedup": round(seq_dt / spec_dt, 3),
        "target_calls": stats.target_calls,
        "target_calls_sequential": S,
        "theoretical_speedup": round(S / max(stats.target_calls, 1), 2),
        **stats.as_dict(),
    }
    print(json.dumps(row), flush=True)
    return row


def mode_quality(eng: SpeculativeEngine, args):
    """Latent MSE and acceptance of speculative against target-only
    generation on the same seed (the notebook used image MSE)."""
    samp, labels = benchmark_config(args), _labels(eng, args)
    base = _target_decode(eng, eng.target_params, labels, args.seed, samp)
    f_hat, stats = eng.generate_speculative(
        labels, args.seed, SpeculativeConfig(gamma=args.gamma), samp)
    row = {
        "latent_mse_vs_target_only": round(
            float(((f_hat - base) ** 2).mean()), 6),
        "accept_rate": round(stats.accept_count / max(
            stats.accept_count + stats.reject_count, 1), 3),
        **stats.as_dict(),
    }
    print(json.dumps(row), flush=True)
    return row


def mode_quant(eng: SpeculativeEngine, args):
    """Target-only decode with bf16 weights against quantized ones (w8,
    fp8, w8a8, w8a8 + INT8 KV) on the same seed: token agreement over all
    ids and per scale, latent MSE, wall time of both. With the model zoo's
    checkpoints this is the cheap stand-in for an FID delta; with random
    weights it exercises the mechanics."""
    samp, labels = benchmark_config(args), _labels(eng, args)

    def run(params, kv_mode="bf16"):
        _target_decode(eng, params, labels, args.seed, samp, kv_mode=kv_mode)
        _sync(eng)
        t0 = time.time()
        f_hat, ids = _target_decode(eng, params, labels, args.seed, samp,
                                    return_ids=True, kv_mode=kv_mode)
        _sync(eng)
        return f_hat, ids, time.time() - t0

    base_fhat, base_ids, base_dt = run(eng.target_params)
    rows = []
    for mode, kv_mode in (("w8", "bf16"), ("fp8", "bf16"), ("w8a8", "bf16"),
                          ("w8a8", "int8")):
        q_fhat, q_ids, q_dt = run(
            quantize_var_params(eng.target_params, mode=mode), kv_mode)
        same = q_ids == base_ids
        per_scale = [round(same[:, bg:ed].float().mean().item(), 3)
                     for bg, ed in eng.target_cfg.begin_ends]
        _emit(rows, {
            "quant": mode + ("+int8kv" if kv_mode == "int8" else ""),
            "token_agreement_vs_bf16": round(same.float().mean().item(), 4),
            "per_scale_agreement": per_scale,
            "latent_mse_vs_bf16": round(
                float(((q_fhat - base_fhat) ** 2).mean()), 6),
            "sec_bf16": round(base_dt, 4), "sec_quant": round(q_dt, 4),
            "speedup": round(base_dt / q_dt, 3),
        })
    return rows


def mode_handoff(eng: SpeculativeEngine, args):
    """The sd_mask 0..5 ablation of the static handoff at ``entry_num``."""
    samp, labels, rows = benchmark_config(args), _labels(eng, args), []
    for sd_mask in range(6):
        eng.generate_handoff(labels, args.seed, entry_num=args.entry_num,
                             sd_mask=sd_mask, samp=samp)
        _sync(eng)
        t0 = time.time()
        _, stats = eng.generate_handoff(labels, args.seed,
                                        entry_num=args.entry_num,
                                        sd_mask=sd_mask, samp=samp)
        _sync(eng)
        _emit(rows, {"sd_mask": sd_mask, "entry_num": args.entry_num,
                     "sec": round(time.time() - t0, 4),
                     "target_calls": stats.target_calls})
    return rows


MODES = {"gamma": mode_gamma, "seqspec": mode_seq_vs_spec,
         "quality": mode_quality, "quant": mode_quant, "handoff": mode_handoff}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=list(MODES), default="gamma")
    ap.add_argument("--depth-draft", type=int, default=16)
    ap.add_argument("--depth-target", type=int, default=30)
    ap.add_argument("--patch-nums", dest="patch_nums", type=str,
                    default="1_2_3_4_5_6_8_10_13_16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--gamma", type=int, default=2)
    ap.add_argument("--entry-num", type=int, default=4)
    ap.add_argument("--cfg", type=float, default=3.0)       # notebook default
    ap.add_argument("--top-k", type=int, default=900)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--quant", choices=["none", "w8", "w8a8", "fp8"],
                    default="none",
                    help="weight-only INT8 (w8), W8A8 or fp8 weights for both "
                         "models")
    # the notebook's classes (sdvar_colab_test.py:88-129)
    ap.add_argument("--labels", type=int, nargs="+",
                    default=[980, 437, 22, 562, 980, 437, 22, 562])
    ap.add_argument("--ckpt-vae", type=str, default=None)
    ap.add_argument("--ckpt-draft", type=str, default=None)
    ap.add_argument("--ckpt-target", type=str, default=None)
    args = ap.parse_args(argv)
    if args.mode == "quant" and args.quant != "none":
        ap.error("--mode quant quantizes the bf16 target itself: build the "
                 "engine without --quant")
    ckpts = (args.ckpt_vae, args.ckpt_draft, args.ckpt_target)
    if any(ckpts) and not all(ckpts):
        ap.error("--ckpt-vae, --ckpt-draft and --ckpt-target go together")
    return args


def main(argv=None):
    """Run one mode; returns its rows (each also printed as a JSON line)."""
    args = parse_args(argv)
    return MODES[args.mode](build_engine(args), args)


if __name__ == "__main__":
    main()
