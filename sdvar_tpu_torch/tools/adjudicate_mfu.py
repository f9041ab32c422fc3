"""Price the VAR-d16 training step's GEMM floor against the measured step
on the card (the counterpart of the repository's
``tools/adjudicate_mfu.py``).

    python -m sdvar_tpu_torch.tools.adjudicate_mfu [--depth 16] [--bs 32] \\
        [--iters 5] [--device cpu]

  1. the token-path step (``train_step(pretokenized=True)``: no VQVAE
     encode, the quantizer's teacher-forcing input kept; bf16 compute,
     remat, AdamW), best of ``--iters`` after one untimed step, and its
     MFU with the JAX tool's FLOP count,
     3 * 2 * M * (12 w^2 d + w V + Cvae w) + 3 * 2 * 2 * B * L^2 * w
     (M = B * L; the causal mask is not credited), against 989 TFLOP/s,
     the H100 SXM data-sheet bf16 dense peak;
  2. every transformer GEMM shape of that step at its real row count in
     its forward, dgrad and wgrad pass: ``torch.matmul`` in bf16 (the
     library GEMM, cuBLAS, is what is measured), each timed over ``REPS``
     back-to-back launches with CUDA events, best of 4; the floor counts
     the forward twice (remat recomputes it in the backward);
  3. kernel row 1 at the training shape through ``ops/attention.py``'s
     ``attention`` (the forward), with the JAX tool's estimate of the
     forward and backward, 3 x forward, and beside it the measured
     forward + backward of ``AttentionFn`` (the kernel's forward, the
     plain PyTorch backward);
then the residual and the verdict. On the CPU the times are the CPU's.
"""

from __future__ import annotations

import argparse
import time

import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.quantizer import init_quantizer_params
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.ops.attention import AttentionFn, attention
from sdvar_tpu_torch.ops.masks import block_causal_prefix, device_bias
from sdvar_tpu_torch.train import trainer as T
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

PEAK_BF16 = 989e12  # FLOP/s, H100 SXM data sheet, bf16 dense
PEAK_NAME = "the H100 SXM bf16 dense peak, 989 TFLOP/s"
REPS = 8  # back-to-back launches a timing


def step_flops(cfg: VARConfig, B: int) -> tuple:
    """(GEMM FLOPs, attention FLOPs) of one training step, the JAX tool's
    count: forward + backward = 3 x the forward's 2 * M * K * N of the
    block, head and word-embedding matmuls, and 3 x the forward's two
    (L x L) products a layer."""
    w, V, d, L = cfg.embed_dim, cfg.vocab_size, cfg.depth, cfg.L
    M = B * L
    gemm = 3 * 2 * M * (12 * w * w * d + w * V + cfg.Cvae * w)
    attn = 3 * 2 * 2 * B * L * L * w
    return gemm, attn


def token_step(cfg: VARConfig, vae_cfg: VQVAEConfig, B: int, dev):
    """(state, step function) of the token-path step: f32 master weights
    from seed 0, the quantizer from seed 3, ids and labels all zero."""
    params = init_var_params(cfg, seed=0, device=dev)
    state = T.init_train_state(params)
    g = torch.Generator(device=dev).manual_seed(3)
    vae_params = {"quant": init_quantizer_params(vae_cfg, g, dev)}
    gt = torch.zeros((B, cfg.L), dtype=torch.long, device=dev)
    label = torch.zeros((B,), dtype=torch.long, device=dev)

    def step(state):
        return T.train_step(cfg, vae_cfg, state, vae_params, gt, label, 1e-4,
                            0.05, T.step_generator(0, 1, dev),
                            dtype=torch.bfloat16, remat=True,
                            pretokenized=True)

    return state, step


def best_seconds(fn, dev, reps: int = REPS, rounds: int = 4) -> float:
    """The best of ``rounds`` mean times of ``reps`` back-to-back calls:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    synchronize(dev)
    best = float("inf")
    for _ in range(rounds):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / reps)
    return best


def run(depth: int = 16, bs: int = 32, iters: int = 5, device="cuda") -> dict:
    dev = resolve_device(device)
    card = card_name(dev)
    print(f"[mfu] card: {card}", flush=True)
    cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    w, V, d = cfg.embed_dim, cfg.vocab_size, depth
    B, L = bs, cfg.L
    M = B * L

    # -- 1. the step ---------------------------------------------------------
    state, step = token_step(cfg, vae_cfg, B, dev)
    state, m = step(state)
    float(m["loss"])
    t_step = float("inf")
    for _ in range(iters):
        synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state)
        float(m["loss"])
        synchronize(dev)
        t_step = min(t_step, time.perf_counter() - t0)
    del state
    gemm_fl, attn_fl = step_flops(cfg, B)
    mfu = (gemm_fl + attn_fl) / t_step / PEAK_BF16
    print(f"[mfu] d{d} B={B} token-path step: {t_step * 1e3:.1f} ms "
          f"-> {mfu * 100:.1f}% MFU of {PEAK_NAME} "
          f"({(gemm_fl + attn_fl) / 1e12:.1f} TF/step)", flush=True)

    # -- 2. the GEMM shapes ----------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [("qkv", w, 3 * w, d), ("proj", w, w, d), ("fc1", w, 4 * w, d),
              ("fc2", 4 * w, w, d), ("head", w, V, 1)]
    total_gemm_ms, done_fl, rows = 0.0, 0.0, []

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for name, K, N, cnt in shapes:
        x, wm, gr, wt = randn(M, K), randn(K, N), randn(M, N), randn(N, K)
        fl = 2 * M * K * N
        t_f = best_seconds(lambda: torch.matmul(x, wm), dev)
        t_d = best_seconds(lambda: torch.matmul(gr, wt), dev)
        t_w = best_seconds(lambda: torch.matmul(x.t(), gr), dev)
        # the forward twice: the step runs remat (the forward again in the
        # backward); the MFU above counts the useful 3 passes
        ms = (2 * t_f + t_d + t_w) * 1e3 * cnt
        total_gemm_ms += ms
        done_fl += 4 * fl * cnt
        rows.append({"name": name, "K": K, "N": N, "count": cnt,
                     "fwd_tflops": fl / t_f / 1e12,
                     "dgrad_tflops": fl / t_d / 1e12,
                     "wgrad_tflops": fl / t_w / 1e12, "ms": ms})
        print(f"[mfu] {name:5s} {K:5d}x{N:5d} x{cnt:2d}: "
              f"fwd {fl / t_f / 1e12:5.1f}T dgrad {fl / t_d / 1e12:5.1f}T "
              f"wgrad {fl / t_w / 1e12:5.1f}T -> {ms:6.1f} ms total", flush=True)
        del x, wm, gr, wt

    # -- 3. attention and the residual ------------------------------------------
    h, hd = cfg.num_heads, cfg.head_dim
    q = randn(B, L, h, hd)
    bias = device_bias(dev, block_causal_prefix, tuple(cfg.patch_nums), L)
    scale = hd ** -0.5
    with torch.no_grad():
        t_attn = best_seconds(lambda: attention(q, q, q, bias, scale), dev)
    qs = [q.clone().requires_grad_() for _ in range(3)]
    go = randn(B, L, h, hd)
    t_fb = best_seconds(lambda: AttentionFn.apply(*qs, bias, scale).backward(go),
                        dev)
    attn_ms = 3 * t_attn * 1e3 * d  # the JAX tool's estimate: fwd+bwd ~ 3 fwd
    attn_fb_ms = t_fb * 1e3 * d
    print(f"[mfu] attention (row 1, B={B} L={L} H={h}): forward "
          f"{t_attn * 1e3:.3f} ms a layer; estimate 3 x forward x {d} layers "
          f"= {attn_ms:.1f} ms; measured forward + backward of AttentionFn "
          f"{t_fb * 1e3:.3f} ms a layer = {attn_fb_ms:.1f} ms", flush=True)
    resid = t_step * 1e3 - total_gemm_ms - attn_ms
    print(f"[mfu] GEMM floor {total_gemm_ms:.1f} ms "
          f"({total_gemm_ms / t_step / 10:.1f}% of step) + attn ~{attn_ms:.1f} ms"
          f" -> residual {resid:.1f} ms "
          f"({resid / t_step / 10:.1f}%: adaLN/LN/softmax-CE/optimizer/launches);"
          f" with the measured attention {t_step * 1e3 - total_gemm_ms - attn_fb_ms:.1f}"
          f" ms", flush=True)
    gemm_rate = done_fl / (total_gemm_ms / 1e3) / 1e12
    floor = total_gemm_ms + attn_ms
    print(f"[mfu] verdict: at the MEASURED per-shape GEMM rates "
          f"(~{gemm_rate:.0f} TFLOP/s avg) the step floor is {floor:.1f} ms = "
          f"{floor / t_step / 10:.1f}% of the measured step; the rest is "
          f"harvestable iff the residual line is large. ({card})", flush=True)
    return {"card": card, "step_ms": t_step * 1e3, "mfu": mfu,
            "gemm_flops": gemm_fl, "attn_flops": attn_fl, "gemms": rows,
            "gemm_floor_ms": total_gemm_ms, "attn_est_ms": attn_ms,
            "attn_fwd_bwd_ms": attn_fb_ms, "residual_ms": resid,
            "gemm_tflops": gemm_rate}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    run(a.depth, a.bs, a.iters, device=a.device)


if __name__ == "__main__":
    main()
