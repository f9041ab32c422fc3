#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the port's kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version on the card, and drives the port's
paths at VAR-d30 256px (class-conditional, random weights from a seed):
``generate_images`` on batches of B=16 requests in bf16, then quantized
(W8A8 weights and an INT8 KV cache, the JAX package's headline
configuration, and weight-only INT8); the bf16 and W8A8 decodes again with
the cache-kernel switch on (``set_cache_kernel``: the fused cache write +
attention, bit-equal to the switch off); SDVAR speculative decoding
(``SpeculativeEngine``: a VAR-d16 self-draft in f32 that must accept every
scale, then VAR-d16 -> VAR-d30 with every drafted scale accepted and with
the real accept rule, beside the d30 baseline) and the server in
speculative mode; then the continuous-batching ``GenerationServer``
answering requests, all-int8 (W8A8 + INT8 KV with the calibrated W8A8
pixel decoder, uint8 delivery) and bf16; then fp8 weights beside bf16,
and the entry points and measuring tools as a user runs them: the FID
sampler (``sample_batches`` into an npz), ``python -m
sdvar_tpu_torch.bench`` (one JSON line), the benchmark CLI's gamma and quant
modes, the serving bench and the int8 matmul microbenchmark (the fused
W8A8 kernel's path); the sampler at vocabularies its kernel does not take
(routed to the plain sampler); then training: kernel row 1 at VAR-d16's
training shape with the gradient through it, a small ``train_step``
against the CPU, VAR-d16 256px at global batch 32 through
``run_training`` and timed ``train_step``s (remat, a progressive stage,
gradient accumulation, the bf16 tokenizer, the checkpoint read back),
``train_loop --smoke`` as a subprocess, one step's spans; VAR-d8 at
global batch 32 through ``run_training`` on a 2x1 and a 1x2 mesh of two
ranks sharing the card (gloo), against the single card, with each mesh's
checkpoint loaded on one card, and a small f32 stack on both meshes; the
VQVAE trainer at 256px; the native data loader's build and one
``run_training`` iteration through it; then high-resolution generation
through the decode measuring tools' ``run()``: VAR-d36 512px with shared
AdaLN at B=4 (``tools/bench_512``: ``generate_images``, bf16 and W8A8 +
INT8 KV, the golden, channels-last bf16 and calibrated all-int8 pixel
decoders at 512px) and the 1024px preset at the d16 width at B=2
(``tools/bench_1024``), with launch counts from depth x scales, the
presets' small stacks against the CPU, a d36-512 B=8 decode whose stacked
cache passes 2^31 elements with the cache-kernel switch on (bit-equal to
off) and kernel rows 1-6 at the new shapes; and four ranks sharing the
card with a stack whose heads do not divide the mesh. The training tools
run through their ``run()`` after the VQVAE trainer: ``convert_checkpoint``
(a VAR-d16 reference state_dict, read back bit-equal), ``pretokenize``
(ids equal to the trainer's tokenize), ``bench_train``, ``profile_train``
(32 row-1 launches in a remat step), ``adjudicate_mfu``, ``calib_pixels``
(row 6 at every quantized site) and ``train_pair`` (a cut dataset: both
roles, a sweep, and the drill: a run SIGKILLed mid-epoch and resumed, its
epoch-2 checkpoint bit-equal to the uninterrupted run's). It checks the outputs and
the kernel launch counts of each path, holds small stacks on the card against
the CPU plain path, times the three pixel decoders and the kernels (the
act-quant, conv, sampler and fused W8A8 kernels also replayed in CUDA
graphs, and the W8A8
pixel decode held bit for bit against the same decode with the plain conv
on the card). The
last stdout line is ``{"ok": true, "device": {...}}``; any failed phase
raises and the script exits non-zero without printing it. It needs a CUDA
card and the ``sdvar_tpu_torch`` package beside it, and imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import (
    PATCH_NUMS_512,
    PATCH_NUMS_1024,
    MeshConfig,
    SamplingConfig,
    SpeculativeConfig,
    TrainConfig,
    VARConfig,
    VQVAEConfig,
    var_config_pair,
)
from sdvar_tpu_torch import benchmark_cli
from sdvar_tpu_torch.engine.decode import decode_all_scales, generate_images
from sdvar_tpu_torch.engine.serving import GenerationServer
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
from sdvar_tpu_torch.models.quantizer import init_quantizer_params
from sdvar_tpu_torch.models.var import (
    KVCache,
    apply_transformer,
    count_params,
    get_logits,
    init_var_params,
    precompute_modulations,
)
from sdvar_tpu_torch.models.vqvae import (
    calibrate_decoder_w8a8,
    fhat_to_img,
    fhat_to_img_nhwc,
    fhat_to_img_nhwc_w8a8_static,
    init_vqvae_params,
)
from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops import attention as ATT
from sdvar_tpu_torch.ops.attention import (
    get_attention_impl,
    set_attention_bwd_chunk,
    set_attention_impl,
    set_cache_kernel,
)
from sdvar_tpu_torch.ops.kernels.attention import (
    attention_cache_kernel,
    attention_cache_plain,
    attention_cache_write_kernel,
    attention_cache_write_plain,
    KEY_TILE,
    attention_kernel,
    attention_plain,
    attention_plan,
    smem_bytes,
)
from sdvar_tpu_torch.ops.masks import (
    block_causal_prefix,
    device_bias,
    verify_window_bias,
)
from sdvar_tpu_torch.ops.sampling import sample_with_top_k_top_p
from sdvar_tpu_torch.ops.kernels import conv_s8 as CONV
from sdvar_tpu_torch.ops.kernels.conv_s8 import (
    conv3x3_s8_kernel,
    conv3x3_s8_plain,
    conv_plan,
)
from sdvar_tpu_torch.ops.kernels.matmul_int8 import (
    int8_matmul_kernel,
    int8_matmul_plain,
    matmul_plan,
)
from sdvar_tpu_torch.ops.kernels import matmul_int8 as MM
from sdvar_tpu_torch.ops.kernels.quantize import (
    act_quantize_kernel,
    act_quantize_plain,
    act_scale_kernel,
    act_scale_plain,
    quant_plan,
)
from sdvar_tpu_torch.ops.kernels import sampling as SMP
from sdvar_tpu_torch.ops.kernels.sampling import sample_kernel, sample_plain
from sdvar_tpu_torch.ops.kernels.scale_probe import (
    scale_probe_kernel,
    scale_probe_plain,
)
from sdvar_tpu_torch.ops import conv_s8 as conv_s8_ops
from sdvar_tpu_torch.ops import quantization as QOPS
from sdvar_tpu_torch.ops.partition import (
    data_rows,
    gather_data,
    gather_model,
    set_tp_mesh,
    sharded_scale_probe,
)
from sdvar_tpu_torch.ops.kernels import w8a8_fused as FUSED
from sdvar_tpu_torch.ops.kernels.w8a8_fused import (
    w8a8_fused_kernel,
    w8a8_fused_plain,
)
from sdvar_tpu_torch.ops.quantization import (
    QuantizedKVCache,
    dequantize_tokens,
    dequantize_weight,
    quantize_tokens,
    quantize_var_params,
    quantize_weight,
    quantize_weight_fp8,
)
from sdvar_tpu_torch.parallel import distributed as DIST
from sdvar_tpu_torch.parallel.launch import launch
from sdvar_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_tree,
    unshard_tree,
    var_param_specs,
)
from sdvar_tpu_torch.sample_fid import balanced_labels, sample_batches
from sdvar_tpu_torch.train import checkpoint as CK
from sdvar_tpu_torch.train import train_loop as TL
from sdvar_tpu_torch.train import trainer as TR
from sdvar_tpu_torch.train import vae_trainer as VT
from sdvar_tpu_torch.train.data import SyntheticImageNet, batch_arrays
from sdvar_tpu_torch.tools import (
    adjudicate_mfu,
    bench_512,
    bench_1024,
    bench_serving,
    bench_train,
    calib_pixels,
    convert_checkpoint,
    microbench_int8_matmul,
    pretokenize,
    probe_mesh_placement,
    profile_train,
    train_pair,
)
from sdvar_tpu_torch.train.pretokenize import TokenDataset
from sdvar_tpu_torch.utils.torch_port import var_params_from_torch
from sdvar_tpu_torch.utils.device import full_f32
from sdvar_tpu_torch.utils.fid import create_npz_from_arrays
from sdvar_tpu_torch.utils.profiling import (
    TRACE_FILE,
    SpanTimer,
    memory_stats,
    trace,
)

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# int8 tensor-core OP/s, f32 FLOP/s outside the tensor cores; and the int32
# instruction rate from the SM's unit counts: 64 INT32 lanes per SM x 132
# SMs x 1.98 GHz boost
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
INT32_OPS = 64 * 132 * 1.98e9

B = 16             # requests per batch (2B = 32 rows under CFG)
DRAFT_DEPTH = 16   # the speculative engine's draft: VAR-d16
B_LARGE = 32       # the batch bench.py tries first for the quantized decode
N_BATCHES = 3
DEPTH = 30
DEV = "cuda"
PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
# (rows, heads) of one rank's attention in the d30 mesh decodes: 1x2 holds
# 15 heads of the 2B CFG rows, 2x1 all 30 heads of its B rows
MESH_RANK_ATT = {"1x2": (2 * B, DEPTH // 2), "2x1": (B, DEPTH)}


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


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: the launches are queued behind a
    spin kernel (about 5 ms), so the card runs them back to back and not at
    the host's pace, which bounds ``cuda_ms`` for launches of a few tens
    of microseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
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
    """(bound ms, bound_by) of the sampling function, not of any one
    kernel's design: the logits and row seeds read once and the ids written
    once, vs the operations the function needs, all priced at the int32
    rate (the slowest of its types). Per logit, one radix-select pass finds the top-k
    threshold (ordered image, digit, count: 4). Per logit that top-k keeps
    (``n_topk``, counted on this run's data): the exp and sum for the
    nucleus (3), one radix-select pass on the masses (4), the row hash and
    Gumbel transform (16) and the argmax (2)."""
    nbytes = M * V * 4 + M * 8
    ops = M * V * 4 + n_topk * 25
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def act_quantize_bound(M, K, gelu, x_itemsize=2):
    """(bound ms, bound_by): x and the bias (x's type, with GELU) read
    once, the int8 values and f32 scales written once, vs the function's
    f32 operations per element: bias, the tanh-GELU polynomial and tanh
    (10), amax (2), divide and round (2); without GELU or bias 4."""
    nbytes = M * K * (x_itemsize + 1) + M * 4 + (K * x_itemsize if gelu else 0)
    ops = M * K * (14 if gelu else 4)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int8_matmul_bound(M, K, N, x_itemsize, out_itemsize):
    """(bound ms, bound_by): x, the int8 weights and the scales read once,
    the output written once, vs the least time of the function's products.
    A bf16 x: 2*M*K*N FLOPs at the bf16 tensor-core peak. An f32 x: the
    lesser of 2*M*K*N at the CUDA cores' f32 rate and 3 x 2*M*K*N at the
    bf16 peak, since every f32 is the exact sum of three bf16 pieces and
    each piece times an int8 is exact in f32, so three bf16 products
    summed in f32 compute the same function (0.3907 ms in place of 1.9231
    at the head's M=8192, K=1920, N=4096: a correction of the yardstick,
    not a gain)."""
    nbytes = M * K * x_itemsize + K * N + N * 4 + M * N * out_itemsize
    flops = 2 * M * K * N
    if x_itemsize == 2:
        t_ops = flops / BF16_FLOPS * 1e3
    else:
        t_ops = min(flops / F32_FLOPS, 3 * flops / BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_int8_bound(Bq, Lq, Lk, H, hd):
    """(bound ms, bound_by): bf16 q and o, int8 k and v and their f32
    per-token scales moved once, vs 4*B*H*Lq*Lk*hd FLOPs at the bf16
    peak."""
    nbytes = 2 * H * hd * Bq * 2 * Lq + H * hd * Bq * 2 * Lk + 2 * Bq * Lk * 4
    flops = 4 * Bq * H * Lq * Lk * hd
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cache_write_bound(Bq, Lq, begin, H, hd, int8, bias):
    """(bound ms, bound_by) of the fused cache write + attention: bf16 q
    read and the output written, the new K/V read and written into the
    cache, the prefix K/V [0, begin) read (int8 with their f32 per-token
    scales), the bias read if any, vs 4*B*H*Lq*Lk*hd FLOPs at the bf16
    peak."""
    C, Lk = H * hd, begin + Lq
    kv = 1 if int8 else 2
    nbytes = Bq * C * 2 * 2 * Lq + Bq * C * kv * 2 * (2 * Lq + begin)
    if int8:
        nbytes += Bq * 4 * 2 * (2 * Lq + begin)
    if bias:
        nbytes += Lq * Lk * 4
    flops = 4 * Bq * H * Lq * Lk * hd
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv3x3_s8_bound(B, H, W, C, O, out_itemsize):
    """(bound ms, bound_by): int8 x and weights, f32 scale and bias read
    once, the output written once, vs 2*B*H*W*9*C*O int8 operations at the
    int8 tensor-core peak."""
    nbytes = B * H * W * (C + O * out_itemsize) + 9 * C * O + 8 * O
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2 * B * H * W * 9 * C * O / INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def w8a8_fused_bound(M, K, N, s8):
    """(bound ms, bound_by): bf16 x, the int8 weights and the f32 scales
    read once, the bf16 output written once, vs 2*M*K*N operations at the
    int8 (s8) or bf16 tensor-core peak."""
    nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2 * M * K * N / (INT8_OPS if s8 else BF16_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_plan_checks():
    """w8a8_plan's shared memory and scratch are what the CUDA source
    takes, at every FUSED_SHAPES shape and form; the ptxas report of the
    four instances."""
    lib = _build.load("w8a8_fused")
    lib.sdvar_w8a8_fused_scratch_bytes.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sdvar_w8a8_fused_scratch_bytes.restype = ctypes.c_longlong
    lib.sdvar_w8a8_fused_smem_bytes.argtypes = []
    lib.sdvar_w8a8_fused_smem_bytes.restype = ctypes.c_int
    for L, K, N, tag in FUSED_SHAPES:
        for s8 in (True, False):
            M = microbench_int8_matmul.B * L
            plan = FUSED.w8a8_plan(M, K, N, s8)
            got = lib.sdvar_w8a8_fused_scratch_bytes(M, N, K, int(s8))
            if got != plan["scratch_bytes"]:
                raise AssertionError(f"w8a8_plan's scratch {plan['scratch_bytes']} "
                                     f"!= the source's {got} at {tag} s8={s8}")
            if lib.sdvar_w8a8_fused_smem_bytes() != plan["smem_bytes"]:
                raise AssertionError("w8a8_plan's shared memory differs from the source's")
    plan = FUSED.w8a8_plan(8192, 1920, 7680, True)
    log(f"[build] w8a8_fused at fc1 s9: grid {plan['grid']}, {plan['tiles']} "
        f"tiles of {FUSED.TILE_M}x{FUSED.TILE_N}, {plan['units']} quantization "
        f"units, {FUSED.STAGES} stages, {plan['smem_bytes']} B dynamic shared "
        f"memory, {plan['scratch_bytes']} B scratch (equal to the source's); "
        "ptxas " + "; ".join(
            f"{x} s8={s8}: " + _kernel_ptxas(
                "w8a8_fused", f"w8a8_fused_kernelI{m}Lb{int(s8)}E")
            for x, m in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
            for s8 in (True, False)))


def sampler_plan_checks():
    """sampler_plan's shared memory is what the CUDA source gives a launch,
    at the decode's V, the widest V and narrow ones; the ptxas report."""
    for V in (64, 1000, 2048, 4096, 8192, 8196, 16384, 32768):
        plan = SMP.sampler_plan(4096, V)
        got = SMP.smem_bytes(V, plan["threads"])
        if got != plan["smem_bytes"]:
            raise AssertionError(f"sampler_plan reserves {plan['smem_bytes']} B "
                                 f"at V={V}, the source {got}")
    plan = SMP.sampler_plan(4096, 4096)
    log(f"[build] sampler at V=4096: {plan['threads']} threads a row, "
        f"{plan['smem_bytes']} B dynamic shared memory (equal to the "
        f"source's); ptxas {_kernel_ptxas('sampler', 'sample_kernelILb0E')}; "
        f"the wide-row instance {_kernel_ptxas('sampler', 'sample_kernelILb1E')}")


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}, {torch.cuda.device_count()} card(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    sources = ("attention", "matmul_int8", "conv_s8", "w8a8_fused",
               "scale_probe", "act_quant", "sampler")
    _build.build(sources)  # one nvcc each, all started together
    log(f"[build] {', '.join(f'csrc/{s}.cu' for s in sources)} built in "
        f"{time.time() - t0:.1f} s")
    for src in sources:
        for line in _build.build_log(src).splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling", "Performance")):
                log(f"[build] {src}: {line.strip()}")
    # every int8 matmul instance runs on the tensor cores through wgmma
    hgmma = sass_hgmma("matmul_int8")
    if hgmma is None:
        log("[build] matmul_int8 SASS: no cuobjdump found, HGMMA not counted")
    else:
        log("[build] matmul_int8 SASS, HGMMA instructions per kernel: "
            + ", ".join(f"{k}: {n}" for k, n in hgmma.items()))
        if not hgmma or min(hgmma.values()) == 0:
            raise AssertionError("an int8 matmul kernel has no HGMMA in its SASS")
    # the wide conv path runs on the tensor cores through s8 wgmma, a GMMA
    # in the SASS (IGMMA; the mma.sync kernel of the narrow path holds none)
    conv_gmma = sass_hgmma("conv_s8", "GMMA")
    if conv_gmma is not None:
        wide = {k: n for k, n in conv_gmma.items() if "conv3x3_s8_tma_kernel" in k}
        log("[build] conv_s8 SASS, GMMA (s8 wgmma) instructions per wide-path "
            "kernel: " + ", ".join(f"{k}: {n}" for k, n in wide.items()))
        if not wide or min(wide.values()) == 0:
            raise AssertionError("a wide conv3x3_s8 kernel has no GMMA in its SASS")
    if CONV.smem_bytes() != CONV.TMA_SMEM:
        raise AssertionError("conv_plan's shared memory differs from the source's")
    # the fused W8A8 kernel runs on the tensor cores through s8 and bf16
    # wgmma (IGMMA and HGMMA: both hold "GMMA") in every instance
    fused_gmma = sass_hgmma("w8a8_fused", "GMMA")
    if fused_gmma is not None:
        log("[build] w8a8_fused SASS, GMMA instructions per kernel: " + ", ".join(
            f"{k}: {n}" for k, n in fused_gmma.items()))
        if not fused_gmma or min(fused_gmma.values()) == 0:
            raise AssertionError("a w8a8_fused kernel has no GMMA in its SASS")
    fused_plan_checks()
    sampler_plan_checks()
    log(f"[build] conv3x3_s8 wide path: ptxas {conv_ptxas()}; "
        f"{CONV.TMA_SMEM} B dynamic shared memory ({CONV.TMA_STAGES} stages, "
        f"equal to conv_plan's); act_quantize fc2 instance (bf16, 2 loads a "
        f"thread, GELU): ptxas {act_quant_ptxas(True)}; K=1920 instance: "
        f"ptxas {act_quant_ptxas(False)}")
    tiles = []
    for x_dt, shapes in MM.TILES.items():
        for wg, bn in shapes:
            for st in (3, 4):
                got = MM.smem_bytes(x_dt, wg, bn, st)
                want = MM._smem_bytes(x_dt, wg, bn, st)
                if got != want:
                    raise AssertionError(f"matmul_plan reserves {want} B of "
                                         f"shared memory, the source {got}")
                tiles.append(f"{str(x_dt)[6:]} {64 * wg}x{bn} s{st}: {got} B")
    log("[build] int8 matmul dynamic shared memory per block (equal to "
        "matmul_plan's): " + ", ".join(tiles))
    # the launch geometry is planned in Python: its shared memory must be
    # what the CUDA source reserves, for every instance
    sizes = []
    for q_dt, kv_dt in ((torch.bfloat16, torch.bfloat16),
                        (torch.bfloat16, torch.int8),
                        (torch.bfloat16, torch.float32),
                        (torch.float32, torch.float32)):
        for hd in (32, 64, 128):
            plan = attention_plan(2 * B, 256, 680, DEPTH, hd, q_dt, kv_dt)
            got = smem_bytes(hd, q_dt, kv_dt, plan["stages"])
            sizes.append(f"q {str(q_dt)[6:]} k/v {str(kv_dt)[6:]} hd={hd}: "
                         f"{got} B ({plan['stages']} stages)")
            if got != plan["smem_bytes"]:
                raise AssertionError(f"attention_plan reserves {plan['smem_bytes']}"
                                     f" B of shared memory, the source {got}")
    log("[build] attention dynamic shared memory per block (equal to "
        "attention_plan's): " + ", ".join(sizes))
    return name


def attention_ptxas(kv: str, write: bool, hd: int = 64) -> str:
    """The -Xptxas -v report (registers, spills) of one bf16-q attention
    instantiation, from the build log; kv: k/v's type, bf16, int8 or f32."""
    mangled = {"bf16": "13__nv_bfloat16", "int8": "a", "f32": "f"}[kv]
    return _kernel_ptxas("attention",
                         f"attention_mma_kernelILi{hd}E{mangled}Lb{int(write)}E")


def _kernel_ptxas(src: str, key: str) -> str:
    """The -Xptxas -v report (registers, spills) of the one kernel of
    ``csrc/<src>.cu`` whose mangled name holds ``key``."""
    lines = _build.build_log(src).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and key in line:
            near = lines[i + 1:i + 4]
            used = next(x for x in near if "Used" in x).split(":", 1)[1]
            spill = next(x for x in near if "spill" in x)
            return f"{used.strip()}; {spill.strip()}"
    raise AssertionError(f"no ptxas report for {key} in csrc/{src}.cu")


def matmul_ptxas(x_dtype, plan) -> str:
    """The ptxas report of the int8 matmul instance that ``plan`` launches."""
    xt = "f" if x_dtype == torch.float32 else "13__nv_bfloat16"
    return _kernel_ptxas("matmul_int8", f"int8_matmul_wgmma_kernelI{xt}"
                         f"Li{plan['warpgroups']}ELi{plan['block_n']}E")


def conv_ptxas() -> str:
    """The ptxas report of the wide conv kernel the top level launches
    (bf16 out, a 32-channel tail chunk)."""
    return _kernel_ptxas("conv_s8", "conv3x3_s8_tma_kernelI13__nv_bfloat16Li32E")


def act_quant_ptxas(gelu: bool) -> str:
    """The ptxas report of the bf16, 16-byte, two-load act-quant kernel."""
    return _kernel_ptxas("act_quant", "act_quantize_kernelI13__nv_bfloat16"
                         f"Li8ELi2ELb{int(gelu)}E")


def sass_hgmma(src: str, op: str = "HGMMA") -> dict:
    """{kernel: ``op`` instructions in its SASS} of ``csrc/<src>.cu``'s
    built library, from cuobjdump (the CUDA toolkit's, else the one Triton
    bundles); None where neither is there. A bf16 wgmma is an HGMMA, an
    s8 one an IGMMA (both hold "GMMA")."""
    tools = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if os.path.exists(t)), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(_build._target(src))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and op in line:
            counts[fn] += 1
    return counts


def attention_staging(Bq, Lq, Lk, H, hd, kv_dtype, write=False) -> str:
    """The K/V bytes one launch's copies stage (attention_plan) beside
    those the bound counts (each K/V row and int8 scale read once), and
    the dynamic shared memory of a block."""
    plan = attention_plan(Bq, Lq, Lk, H, hd, torch.bfloat16, kv_dtype,
                          write=write)
    item = {torch.bfloat16: 2, torch.int8: 1, torch.float32: 4}[kv_dtype]
    counted = Bq * H * hd * 2 * Lk * item + (Bq * Lk * 8 if item == 1 else 0)
    return (f"K/V bytes staged per launch {plan['kv_bytes_staged']} (the bound "
            f"counts {counted}), grid {plan['grid']} x {plan['threads']} "
            f"threads, {plan['stages']} stages, {plan['smem_bytes']} B dynamic "
            f"shared memory")


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
    for tag, (Bm, Hm) in MESH_RANK_ATT.items():  # scale 9, bf16, per rank
        Lq, Lk = 256, 680
        cache = torch.randn(2, Bm, Lmax, Hm * hd, device=dev,
                            generator=g).to(torch.bfloat16)
        q = torch.nn.functional.normalize(torch.randn(
            Bm, Lq, Hm, hd, device=dev, generator=g), dim=-1).mul_(4.0)
        q = q.to(torch.bfloat16)
        k = cache[0, :, :Lk].view(Bm, Lk, Hm, hd)
        k.copy_(torch.nn.functional.normalize(k.float(), dim=-1))
        v = cache[1, :, :Lk].view(Bm, Lk, Hm, hd)
        got = attention_kernel(q, k, v, None, 1.0).float()
        torch.cuda.synchronize()
        want = attention_plain(q.float(), k.float(), v.float(), None, 1.0)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=2e-2, atol=2e-2)
        log(f"[check] attention bfloat16 mesh {tag} rank shape ({Bm} rows, "
            f"{Hm} heads) Lq={Lq} Lk={Lk}: max|d|={err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention kernel disagrees at the {tag} "
                                 f"rank shape")
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
    # tie and extreme rows: a 10-way tie above and a tie at the k=15 edge,
    # all-equal rows (0.25, -0.0), +-3e38 with +-0.0 and 1e-38, a row of
    # -3e38 with one -1e-38, runs of +0.0 and -0.0 beside +-3e38
    logits[0] = -5.0
    logits[0, :10], logits[0, 10:20] = 3.0, 1.0
    logits[1], logits[2] = 0.25, -0.0
    logits[3, :4] = torch.tensor([3e38, -3e38, 0.0, -0.0])
    logits[3, 4:8] = 1e-38
    logits[4] = -3e38
    logits[4, 17] = -1e-38
    logits[5, :2] = torch.tensor([3e38, -3e38])
    logits[5, 8:600], logits[5, 600:1200] = 0.0, -0.0
    noise = -torch.log(-torch.log(
        torch.rand(M, V, device=dev, generator=g).clamp_(1e-7, 1 - 1e-7)))
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=dev,
                          generator=g, dtype=torch.int32)
    smp = {}
    # M = 4096 rows (the decode's scale 9) and M = 100
    for rows in (M, 100):
        lg, nz, sd = logits[:rows], noise[:rows], seeds[:rows]
        for top_k, top_p in ((900, 0.96), (900, 0.0), (1, 0.0), (15, 0.0),
                             (4095, 0.0), (0, 0.9), (15, 0.5)):
            ids, mask = sample_kernel(lg, None, top_k, top_p, noise=nz,
                                      return_mask=True)
            ids_p, mask_p = sample_plain(lg, None, top_k, top_p, noise=nz,
                                         return_mask=True)
            equal = (mask == mask_p).all(-1) & (ids == ids_p)
            rows_eq, odd_eq = equal.float().mean().item(), bool(equal[:6].all())
            hashed = (sample_kernel(lg, sd, top_k, top_p)
                      == sample_plain(lg, sd, top_k, top_p)).float().mean().item()
            need = 1.0 if top_p == 0.0 else 0.999
            ok = rows_eq >= need and hashed >= 0.999 and (top_p != 0.0 or odd_eq)
            log(f"[check] sampler M={rows} top_k={top_k} top_p={top_p}: rows "
                f"equal with noise {rows_eq:.6f} (need {need}; the six tie and "
                f"extreme rows {'equal' if odd_eq else 'not all equal'}), ids "
                f"equal on the row-hash path {hashed:.6f} (need 0.999) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"sampler kernel disagrees at M={rows} "
                                     f"{top_k}/{top_p}")
            if rows == M:
                smp[(top_k, top_p)] = ((mask.int() - mask_p.int()).abs().max().item(),
                                       rows_eq, hashed)
    # a CUDA graph of one launch replays the eager bits (no host sync, no
    # allocation in the kernel)
    for rows in (M, 16):
        lg, sd = logits[:rows], seeds[:rows]
        eager = sample_kernel(lg, sd, 900, 0.96)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = sample_kernel(lg, sd, 900, 0.96)
        replayed.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        ok = torch.equal(replayed, eager)
        log(f"[check] sampler M={rows} in a CUDA graph: replay bit-equal to "
            f"eager {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("sampler graph replay differs from eager")
    return errs, smp


def _log_uniform(shape, lo, hi, g):
    """Scales far from 1: log-uniform in [lo, hi]."""
    u = torch.rand(shape, device=DEV, generator=g)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def _int8_cache(Bq, Lmax, C, g):
    """An int8 (2, Bq, Lmax, C) K/V cache of one layer and its (2, Bq,
    Lmax) f32 scale planes, scales log-uniform in [1e-3, 1e2]."""
    vals = torch.randint(-127, 128, (2, Bq, Lmax, C), device=DEV, generator=g,
                         dtype=torch.int8)
    return vals, _log_uniform((2, Bq, Lmax), 1e-3, 1e2, g)


def _int8_kv(vals, scales, Lk, H, hd):
    """k, v and (ks, vs) as strided slices [0, Lk) of the cache, as the
    main path hands them to the kernel."""
    Bq = vals.shape[1]
    return (vals[0, :, :Lk].view(Bq, Lk, H, hd), vals[1, :, :Lk].view(Bq, Lk, H, hd),
            (scales[0, :, :Lk], scales[1, :, :Lk]))


def phase_quant_kernel_checks():
    """The three kernels of the quantized path against their plain versions
    at main-path shapes, the d30 mesh ranks' included (attention on 15
    heads and on 16 rows, the act-quant's split-row modes, the head's
    2048-column half). Tolerances: INT8-KV attention f32 1e-4 and bf16
    2e-2 of the output's size (bf16: p * vs and o round once each); act
    quantization scales 1e-6 relative and |dq| <= 1 on fewer than 1e-3 of
    the elements with GELU (libdevice tanh against PyTorch's), the plain
    version's bits without; INT8-weight matmul f32 1e-5 of the output's
    size (the f32 sum's order), bf16 2^-7 (one rounding of the output is up
    to 2^-8 of the largest one's binade, plus the sum's order)."""
    g = torch.Generator(device=DEV).manual_seed(2)
    Bq, H, hd, Lmax = 2 * B, DEPTH, 64, 680
    errs = {}
    vals, scales = _int8_cache(Bq, Lmax, H * hd, g)
    for dtype in (torch.bfloat16, torch.float32):
        for Lq, Lk in ((1, 1), (64, 155), (169, 424), (256, 680)):
            q = (torch.randn(Bq, Lq, H, hd, device=DEV, generator=g) * 1e-3).to(dtype)
            k, v, kv_scales = _int8_kv(vals, scales, Lk, H, hd)
            got = attention_kernel(q, k, v, None, 1.0, kv_scales=kv_scales).float()
            torch.cuda.synchronize()
            want = attention_plain(q, k, v, None, 1.0, kv_scales=kv_scales).float()
            err = (got - want).abs().max().item()
            lim = (1e-4 if dtype == torch.float32 else 2e-2) * want.abs().max().item()
            ok = err <= lim
            log(f"[check] attention_int8 {str(dtype)[6:]} Lq={Lq} Lk={Lk}: "
                f"max|d|={err:.3e} (limit {lim:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"INT8-KV attention disagrees at {Lq}x{Lk}")
            errs[("attention_int8", dtype, Lq, Lk)] = err
    for tag, (Bm, Hm) in MESH_RANK_ATT.items():  # scale 9, bf16, per rank
        Lq, Lk = 256, 680
        mvals, mscales = _int8_cache(Bm, Lmax, Hm * hd, g)
        q = (torch.randn(Bm, Lq, Hm, hd, device=DEV, generator=g)
             * 1e-3).to(torch.bfloat16)
        k, v, kv_scales = _int8_kv(mvals, mscales, Lk, Hm, hd)
        got = attention_kernel(q, k, v, None, 1.0, kv_scales=kv_scales).float()
        torch.cuda.synchronize()
        want = attention_plain(q, k, v, None, 1.0, kv_scales=kv_scales).float()
        err = (got - want).abs().max().item()
        lim = 2e-2 * want.abs().max().item()
        ok = err <= lim
        log(f"[check] attention_int8 bfloat16 mesh {tag} rank shape ({Bm} "
            f"rows, {Hm} heads) Lq={Lq} Lk={Lk}: max|d|={err:.3e} (limit "
            f"{lim:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"INT8-KV attention disagrees at the {tag} "
                                 f"rank shape")
        del mvals, mscales
    # additive bias with -inf entries and one fully masked row, f32
    Lq, Lk = 100, 255
    q = torch.randn(Bq, Lq, H, hd, device=DEV, generator=g) * 1e-3
    k, v, kv_scales = _int8_kv(vals, scales, Lk, H, hd)
    bias = torch.randn(Lq, Lk, device=DEV, generator=g)
    bias[:, ::3] = float("-inf")
    bias[-1] = float("-inf")
    got = attention_kernel(q, k, v, bias, 1.0, kv_scales=kv_scales)
    want = attention_plain(q, k, v, bias, 1.0, kv_scales=kv_scales)
    err = (got - want).abs().max().item()
    ok = (err <= 1e-4 * want.abs().max().item() and not got[:, -1].any()
          and bool(torch.isfinite(got).all()))
    log(f"[check] attention_int8 f32 with -inf bias and a masked row: "
        f"max|d|={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("INT8-KV attention disagrees under a bias")

    M = 2 * B * 256
    for K, gelu in ((7680, True), (1920, False)):
        x = (torch.randn(M, K, device=DEV, generator=g) * 3).to(torch.bfloat16)
        bias = (torch.randn(K, device=DEV, generator=g).to(torch.bfloat16)
                if gelu else None)  # bf16, as the main path's fc1_b
        q8, s8 = act_quantize_kernel(x, bias, gelu)
        torch.cuda.synchronize()
        qp, sp = act_quantize_plain(x, bias, gelu)
        s_rel = ((s8 - sp).abs() / sp).max().item()
        d = (q8.int() - qp.int()).abs()
        frac = (d != 0).float().mean().item()
        ok = s_rel <= 1e-6 and d.max().item() <= 1 and frac < 1e-3
        log(f"[check] act_quantize M={M} K={K} gelu={gelu}: scales max rel "
            f"{s_rel:.3e}, |dq|<=1 {d.max().item() <= 1}, dq != 0 on "
            f"{frac:.2e} of elements {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"act_quantize kernel disagrees at K={K}")
        errs[("act_quantize", K)] = float(d.max().item())

    # a row split over the 1x2 mesh's two ranks: proj's input (K=960 a
    # rank, no GELU) and fc2's (K=3840, bf16 bias + GELU); this rank's half
    # of each row, the scales alone, then the values under the whole row's
    # scale (the max of both halves' scales, at least this half's own)
    for K, gelu in ((960, False), (3840, True)):
        xw = (torch.randn(M, 2 * K, device=DEV, generator=g) * 3).to(torch.bfloat16)
        bw = (torch.randn(2 * K, device=DEV, generator=g).to(torch.bfloat16)
              if gelu else None)
        x, bias = xw[:, :K].contiguous(), (bw[:K] if gelu else None)
        s8 = act_scale_kernel(x, bias, gelu)
        torch.cuda.synchronize()
        sp = act_scale_plain(x, bias, gelu)
        whole = torch.maximum(sp, act_scale_plain(
            xw[:, K:], bw[K:] if gelu else None, gelu))
        q8, s_out = act_quantize_kernel(x, bias, gelu, scale=whole)
        torch.cuda.synchronize()
        qp, _ = act_quantize_plain(x, bias, gelu, scale=whole)
        s_rel = ((s8 - sp).abs() / sp).max().item()
        d = (q8.int() - qp.int()).abs()
        frac = (d != 0).float().mean().item()
        if gelu:  # libdevice tanh against PyTorch's, as above
            ok = s_rel <= 1e-6 and d.max().item() <= 1 and frac < 1e-3
        else:
            ok = torch.equal(s8, sp) and d.max().item() == 0
        ok = ok and torch.equal(s_out.view(-1), whole.view(-1))
        log(f"[check] act_quantize split row M={M} K={K} gelu={gelu}: "
            f"scale-only pass max rel {s_rel:.3e}, given-scale pass dq != 0 "
            f"on {frac:.2e} of elements (max |dq| {d.max().item()}; "
            f"{'limit |dq| <= 1 on < 1e-3' if gelu else 'bits required'}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"act_quantize split-row modes disagree at "
                                 f"K={K}")
        errs[("act_quantize split", K)] = float(d.max().item())

    # the act-quant kernel at every shape the W8A8 decode launches: the
    # qkv, proj and fc1 inputs (K=1920, no GELU) bit-equal at the ten
    # scales, the fc2 input (K=7680, bf16 bias + GELU) within the tolerance
    for pn in PNS:
        Ms = 2 * B * pn * pn
        x = (torch.randn(Ms, 1920, device=DEV, generator=g) * 3).to(torch.bfloat16)
        q8, s8 = act_quantize_kernel(x, None, False)
        torch.cuda.synchronize()
        qp, sp = act_quantize_plain(x, None, False)
        same = torch.equal(q8, qp) and torch.equal(s8, sp)
        xg = (torch.randn(Ms, 7680, device=DEV, generator=g) * 3).to(torch.bfloat16)
        bg = torch.randn(7680, device=DEV, generator=g).to(torch.bfloat16)
        qg, sg = act_quantize_kernel(xg, bg, True)
        torch.cuda.synchronize()
        qgp, sgp = act_quantize_plain(xg, bg, True)
        d = (qg.int() - qgp.int()).abs()
        frac = (d != 0).float().mean().item()
        s_rel = ((sg - sgp).abs() / sgp).max().item()
        ok = same and s_rel <= 1e-6 and d.max().item() <= 1 and frac < 1e-3
        plan = quant_plan(Ms, 1920, torch.bfloat16)
        log(f"[check] act_quantize scale pn={pn} (M={Ms}; K=1920: {plan['group']} "
            f"threads a row, {plan['nv']} loads a thread, grid {plan['grid']}): "
            f"K=1920 bit-equal {same}; K=7680 + GELU dq != 0 on {frac:.2e}, "
            f"scales max rel {s_rel:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"act_quantize kernel disagrees at pn={pn}")
    same = _act_quant_graph_replay(g)
    log(f"[check] act_quantize M=800 K=7680 bf16 bias + GELU captured in a "
        f"CUDA graph and replayed on new x: bit-equal to the eager launch {same}")
    if not same:
        raise AssertionError("act_quantize's graph replay differs from the "
                             "eager launch")

    # fc1 and fc2 of the w8 decode, the head and the 1x2 rank's vocab half
    # at scale 9 (M=8192), and ragged M: scale 8's 5408 rows, scale 4's 800
    for x_dtype, Mx, K, N in ((torch.bfloat16, M, 1920, 7680),
                              (torch.bfloat16, M, 7680, 1920),
                              (torch.float32, M, 1920, 4096),
                              (torch.float32, M, 1920, 2048),
                              (torch.bfloat16, 5408, 7680, 1920),
                              (torch.float32, 800, 1920, 4096)):
        x = torch.randn(Mx, K, device=DEV, generator=g).to(x_dtype)
        qw = quantize_weight(torch.randn(K, N, device=DEV, generator=g) * 0.02)
        got = int8_matmul_kernel(x, qw.q, qw.scale).float()
        torch.cuda.synchronize()
        want = int8_matmul_plain(x.float(), qw.q, qw.scale)  # x widens exactly
        err = (got - want).abs().max().item()
        lim = (2 ** -7 if x_dtype == torch.bfloat16 else 1e-5) * want.abs().max().item()
        ok = err <= lim
        plan = matmul_plan(Mx, N, K, x_dtype)
        log(f"[check] int8_matmul {str(x_dtype)[6:]} M={Mx} K={K} N={N} (tile "
            f"{plan['block_m']}x{plan['block_n']}, {plan['stages']} stages, "
            f"{plan['splits']} split(s) of K): "
            f"max|d|={err:.3e} (limit {lim:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"int8_matmul kernel disagrees for {x_dtype} "
                                 f"at M={Mx} K={K} N={N}")
        if Mx == M and K == 1920:
            errs[("int8_matmul", x_dtype, N)] = err
    for x_dtype in (torch.bfloat16, torch.float32):
        same = _int8_matmul_graph_replay(x_dtype, g)
        log(f"[check] int8_matmul {str(x_dtype)[6:]} M=800 K=1920 N=4096 "
            f"captured in a CUDA graph and replayed on new x: bit-equal to the "
            f"eager launch {same}")
        if not same:
            raise AssertionError("int8_matmul's graph replay differs from the "
                                 "eager launch")
    return errs


def _act_quant_graph_replay(g) -> bool:
    """One act_quantize_kernel launch captured in a CUDA graph (after an
    eager launch) and replayed on new x, against an eager launch on that
    x: q and the scales bit-equal."""
    x = (torch.randn(800, 7680, device=DEV, generator=g) * 3).to(torch.bfloat16)
    bias = torch.randn(7680, device=DEV, generator=g).to(torch.bfloat16)
    act_quantize_kernel(x, bias, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = act_quantize_kernel(x, bias, True)
    x.copy_((torch.randn(800, 7680, device=DEV, generator=g) * 3).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    qe, se = act_quantize_kernel(x, bias, True)
    same = torch.equal(q, qe) and torch.equal(s, se)
    del graph
    return same


def _conv_graph_replay(g) -> bool:
    """One conv3x3_s8_kernel launch of the wide path captured in a CUDA
    graph and replayed on new x, against an eager launch: bit-equal."""
    Bc, H, W, C, O = 4, 64, 64, 160, 160
    x8 = torch.randint(-127, 128, (Bc, H, W, C), device=DEV, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device=DEV, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device=DEV, generator=g) * 2e-3
    bias = torch.randn(O, device=DEV, generator=g)
    conv3x3_s8_kernel(x8, wk, scale, bias)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv3x3_s8_kernel(x8, wk, scale, bias)
    x8.copy_(torch.randint(-127, 128, x8.shape, device=DEV, generator=g,
                           dtype=torch.int8))
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, conv3x3_s8_kernel(x8, wk, scale, bias))
    del graph
    return same


def _int8_matmul_graph_replay(x_dtype, g) -> bool:
    """One int8_matmul_kernel launch captured in a CUDA graph (after an
    eager launch) and replayed on new x, against an eager launch on that
    x: bit-equal when the kernel allocates nothing and does not
    synchronise."""
    M, K, N = 800, 1920, 4096
    x = torch.randn(M, K, device=DEV, generator=g).to(x_dtype)
    qw = quantize_weight(torch.randn(K, N, device=DEV, generator=g) * 0.02)
    int8_matmul_kernel(x, qw.q, qw.scale)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_matmul_kernel(x, qw.q, qw.scale)
    x.copy_(torch.randn(M, K, device=DEV, generator=g).to(x_dtype))
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, int8_matmul_kernel(x, qw.q, qw.scale))
    del graph
    return same


CONV_SHAPES = ((2, 16, 32, 8, 12), (1, 8, 64, 4, 4), (2, 24, 32, 12, 8),
               (1, 16, 32, 160, 3)) + tuple(
    (2, 8, 37, C, O) for C in (32, 160, 320) for O in (160, 320, 640, 200)) + (
    (16, 256, 256, 160, 160),)
CONV_FULL = CONV_SHAPES[-1]  # the pixel decoder's top level at B=16


def phase_conv_checks():
    """The INT8 conv kernel against its plain version, f32 and bf16 output,
    bit-equal required: both form the exact s32 sums and round x * scale
    and + bias separately, then cast once."""
    g = torch.Generator(device=DEV).manual_seed(3)
    errs = {}
    for shape in CONV_SHAPES:
        Bc, H, W, C, O = shape
        x8 = torch.randint(-127, 128, (Bc, H, W, C), device=DEV, generator=g,
                           dtype=torch.int8)
        wk = torch.randint(-127, 128, (O, 3, 3, C), device=DEV, generator=g,
                           dtype=torch.int8)
        scale = torch.rand(O, device=DEV, generator=g) * 2e-3
        bias = torch.randn(O, device=DEV, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            got = conv3x3_s8_kernel(x8, wk, scale, bias, dtype)
            torch.cuda.synchronize()
            want = conv3x3_s8_plain(x8, wk, scale, bias, dtype)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.equal(got, want)
            plan = conv_plan(*shape)
            log(f"[check] conv3x3_s8 {str(dtype)[6:]} (B,H,W,C,O)={shape} "
                f"({plan['path']} path"
                + (f", box {plan['box_w']}x{plan['box_h']}, {plan['k_steps']} "
                   f"128-channel steps + tail {plan['tail']}, grid {plan['grid']}"
                   if plan["path"] == "tma" else "")
                + f"): max|d|={err:.3e} bit-equal {ok} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"conv3x3_s8 kernel disagrees at {shape}")
            errs[("conv3x3_s8", dtype, shape)] = err
        del x8, wk, got, want
    same = _conv_graph_replay(g)
    log(f"[check] conv3x3_s8 (4, 64, 64, 160 -> 160) wide path captured in a "
        f"CUDA graph and replayed on new x: bit-equal to the eager launch {same}")
    if not same:
        raise AssertionError("conv3x3_s8's graph replay differs from the eager "
                             "launch")
    torch.cuda.empty_cache()
    return errs


def _reset_counts():
    attention_kernel.launches = attention_kernel.launches_int8 = 0
    act_quantize_kernel.launches = int8_matmul_kernel.launches = 0
    sample_kernel.launches = conv3x3_s8_kernel.launches = 0
    attention_cache_write_kernel.launches = 0
    attention_cache_write_kernel.launches_int8 = 0
    attention_cache_kernel.launches = 0
    w8a8_fused_kernel.launches = scale_probe_kernel.launches = 0
    sample_kernel.plain_rows = 0


def _read_counts():
    return {"attention": attention_kernel.launches,
            "attention_int8": attention_kernel.launches_int8,
            "act_quantize": act_quantize_kernel.launches,
            "int8_matmul": int8_matmul_kernel.launches,
            "sampler": sample_kernel.launches,
            "conv3x3_s8": conv3x3_s8_kernel.launches,
            "cache_write": attention_cache_write_kernel.launches,
            "cache_write_int8": attention_cache_write_kernel.launches_int8,
            "attention_cache": attention_cache_kernel.launches,
            "w8a8_fused": w8a8_fused_kernel.launches,
            "scale_probe": scale_probe_kernel.launches}


def _want(**counts):
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {**{k: 0 for k in _read_counts()}, **counts}


# the port's kernels as the device trace names them (their ``__global__``
# names in csrc/*.cu), by the launch counter that counts them
_PORT_KERNELS = (("act_quantize_kernel", "act_quantize"),
                 ("int8_matmul_wgmma_kernel", "int8_matmul"),
                 ("sample_kernel", "sampler"),
                 ("conv3x3_s8", "conv3x3_s8"),
                 ("w8a8_fused_kernel", "w8a8_fused"),
                 ("scale_probe_kernel", "scale_probe"))


def _kernel_counter(name):
    """The launch counter a device kernel's name belongs to, or None. The
    attention kernels are ``attention_{mma,f32}_kernel<HD, KC, WRITE>``:
    KC ``signed char`` for an int8 cache, WRITE true for the cache-write
    form (the cache-read form, row 7, on none of the paths counted so,
    reads as ``attention``)."""
    att = re.search(r"attention_(?:mma|f32)_kernel<([^>]*)>", name)
    if att:
        args = att.group(1)
        base = "cache_write" if args.replace(" ", "").endswith("true") \
            else "attention"
        return base + ("_int8" if "char" in args else "")
    for key, counter in _PORT_KERNELS:
        if key in name:
            return counter
    return None


def _device_counts(fn):
    """``fn()`` under ``torch.profiler`` (every thread) -> (its result, the
    port's kernels that ran on the card, counted by name in the device
    trace and keyed as ``_read_counts``). A replayed CUDA graph's kernel
    nodes are in the trace, though no launch counter ticks for them."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        cfg = None
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        experimental_config=cfg)
    prof.start()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    counts = {k: 0 for k in _read_counts()}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            counter = _kernel_counter(e.name())
            if counter is not None:
                counts[counter] += 1
    return out, counts


def _time_decodes(name, var_cfg, vae_cfg, params, vae, samp, batch, kv_mode,
                  pixels, tag):
    """Best of 3 latent decodes (and pixel decodes), every run printed."""
    labels = torch.arange(batch) * 37 % 1000
    torch.cuda.reset_peak_memory_stats()
    lat, pix = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        f_hat = decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                                  labels, 20 + i, samp, kv_mode=kv_mode)
        torch.cuda.synchronize()
        t1 = time.time()
        lat.append((t1 - t0) * 1e3)
        if pixels:
            with torch.inference_mode():
                fhat_to_img(vae_cfg, vae, f_hat)
            torch.cuda.synchronize()
            pix.append((time.time() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line = (f"[{tag}] {name}: B={batch} latent decode {min(lat):.1f} ms "
            f"(runs {', '.join(f'{t:.1f}' for t in lat)})")
    if pixels:
        line += (f", pixel decode {min(pix):.1f} ms (runs "
                 f"{', '.join(f'{t:.1f}' for t in pix)}), "
                 f"{batch / ((min(lat) + min(pix)) / 1e3):.2f} img/s")
    log(f"{line}, peak memory {peak:.2f} GiB")


def _quantized_var(var_cfg, mode):
    """VAR-d30 from the seed of the bf16 path, quantized; the replaced bf16
    weights go as the float tree is dropped."""
    params = quantize_var_params(
        init_var_params(var_cfg, seed=0, device=DEV, dtype=torch.bfloat16),
        mode=mode)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params


def phase_quant_path(name):
    """W8A8 weights + INT8 KV cache (the JAX package's headline
    configuration, bench.py), then weight-only INT8 weights."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    t0 = time.time()
    params = _quantized_var(var_cfg, "w8a8")
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[quant] VAR-d{DEPTH} w8a8 ({nbytes / 2 ** 30:.2f} GiB of "
        f"parameters) quantized on the card in {time.time() - t0:.1f} s, "
        f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    labels = [torch.arange(B) * 61 % 1000, torch.arange(B) * 7 + 100,
              torch.full((B,), 207)]
    # warm-up (the CUDA kernels load)
    generate_images(var_cfg, vae_cfg, params, vae, labels[0], 0, samp,
                    kv_mode="int8")
    torch.cuda.synchronize()

    _reset_counts()
    imgs = []
    for lab, seed in zip(labels, (1, 2, 3)):
        t0 = time.time()
        img = generate_images(var_cfg, vae_cfg, params, vae, lab, seed, samp,
                              kv_mode="int8")
        torch.cuda.synchronize()
        imgs.append(img)
        log(f"[quant] w8a8 + int8 KV request batch seed={seed}: "
            f"{tuple(img.shape)} in {(time.time() - t0) * 1e3:.1f} ms")
    launches = _read_counts()
    log(f"[quant] kernel launches over {N_BATCHES} w8a8 + int8-KV decodes: "
        f"{launches}")
    # per decode and layer of each of the 10 scales: one attention and four
    # activation quantizations (qkv, proj and fc1 inputs, fused fc2 input);
    # per scale one head matmul and one sampler launch: 300/1200/10/10
    S = len(PNS)
    want = _want(attention_int8=S * DEPTH * N_BATCHES,
                 act_quantize=4 * S * DEPTH * N_BATCHES,
                 int8_matmul=S * N_BATCHES, sampler=S * N_BATCHES)
    if launches != want:
        raise AssertionError(f"w8a8 path launch counts {launches} != {want}")
    for img in imgs:
        if img.shape != (B, 3, 256, 256) or not torch.isfinite(img).all() \
                or img.min() < 0 or img.max() > 1:
            raise AssertionError(f"bad images: {tuple(img.shape)} "
                                 f"[{img.min().item()}, {img.max().item()}]")
    log(f"[quant] images finite, in [0, 1], shape ({B}, 3, 256, 256)")
    ids = [decode_all_scales(var_cfg, vae_cfg, params, vae["quant"], labels[0],
                             s, samp, return_ids=True, kv_mode="int8")[1]
           for s in (5, 5, 6)]
    if not torch.equal(ids[0], ids[1]) or torch.equal(ids[0], ids[2]):
        raise AssertionError("same seed must give the same ids, another "
                             "seed other ids")
    log(f"[quant] seed 5 twice: identical ids; seed 6: "
        f"{(ids[0] != ids[2]).float().mean().item():.3f} of ids differ")
    _time_decodes(name, var_cfg, vae_cfg, params, vae, samp, B, "int8", True,
                  "quant w8a8 + int8 KV")
    decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                      torch.arange(B_LARGE), 0, samp, kv_mode="int8")
    _time_decodes(name, var_cfg, vae_cfg, params, vae, samp, B_LARGE, "int8",
                  False, "quant w8a8 + int8 KV")
    del params
    torch.cuda.empty_cache()

    params = _quantized_var(var_cfg, "w8")
    decode_all_scales(var_cfg, vae_cfg, params, vae["quant"], labels[0], 0,
                      samp, kv_mode="int8")
    torch.cuda.synchronize()
    _reset_counts()
    decode_all_scales(var_cfg, vae_cfg, params, vae["quant"], labels[1], 1,
                      samp, kv_mode="int8")
    torch.cuda.synchronize()
    w8 = _read_counts()
    log(f"[quant] kernel launches over one w8 + int8-KV decode: {w8}")
    # four block matmuls per layer and the head: 1200 + 10
    want = _want(attention_int8=S * DEPTH, int8_matmul=4 * S * DEPTH + S,
                 sampler=S)
    if w8 != want:
        raise AssertionError(f"w8 path launch counts {w8} != {want}")
    _time_decodes(name, var_cfg, vae_cfg, params, vae, samp, B, "int8", False,
                  "quant w8 + int8 KV")
    del params, vae
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("attention_int8", "act_quantize",
                                     "int8_matmul")}


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
    # warm-up (the CUDA kernels load and set their shared-memory limits)
    generate_images(var_cfg, vae_cfg, params, vae, labels[0], 0, samp)
    torch.cuda.synchronize()

    _reset_counts()
    imgs = []
    for lab, seed in zip(labels, seeds):
        t0 = time.time()
        img = generate_images(var_cfg, vae_cfg, params, vae, lab, seed, samp)
        torch.cuda.synchronize()
        imgs.append(img)
        log(f"[main] request batch seed={seed}: {tuple(img.shape)} in "
            f"{(time.time() - t0) * 1e3:.1f} ms")
    launches = _read_counts()
    log(f"[main] kernel launches over {N_BATCHES} decodes: {launches}")
    want = {k: 0 for k in launches}
    want.update(attention=300 * N_BATCHES, sampler=10 * N_BATCHES)
    if launches != want:
        raise AssertionError(f"main path launch counts {launches} != {want}")
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


SERVE_B = 16        # bench_serving's bucket: one bucket of 16 requests


def _serve(srv, requests, timeout=900.0):
    """Submit (label, seed) pairs at once, wait for all; the results and the
    wall time from the first submit to the last result."""
    t0 = time.time()
    rids = [srv.submit(label=lab, seed=seed) for lab, seed in requests]
    results = [srv.get(rid, timeout=timeout) for rid in rids]
    return results, time.time() - t0


def _check_results(results, tag):
    """Every result ok, a (3, 256, 256) uint8 image; raises otherwise."""
    for r in results:
        if not r.ok:
            raise AssertionError(f"[{tag}] request {r.id} failed: {r.error}")
        if r.image.shape != (3, 256, 256) or r.image.dtype.name != "uint8":
            raise AssertionError(f"[{tag}] request {r.id}: image "
                                 f"{r.image.shape} {r.image.dtype}")


def _serve_warm(srv, requests, tag, per_batch, graphed):
    """The server's first batches, which capture the bucket's CUDA graphs:
    counts set to 0 just before, read just after. The ``graphed`` kernels
    (the block stack's) tick once, at the capture; the others
    ``per_batch`` for each batch run."""
    b0 = srv.stats["batches"]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    warm, _ = _serve(srv, requests)
    torch.cuda.synchronize()
    launches = _read_counts()
    _check_results(warm, tag)
    nb = srv.stats["batches"] - b0
    want = {k: graphed.get(k, per_batch.get(k, 0) * nb) for k in launches}
    log(f"[{tag}] warm-up bucket of {len(requests)}: {time.time() - t0:.1f} s, "
        f"{nb} batches; kernel launches (the graphs' captured once) "
        f"{launches}")
    if launches != want:
        raise AssertionError(f"[{tag}] warm-up launch counts {launches} != "
                             f"{want}")


def _serve_measured(srv, requests, tag, per_batch):
    """Drive the server's path once, under ``torch.profiler``: counts set
    to 0 just before, read just after. Each batch replays the bucket's
    graphs, so the device trace must hold ``per_batch`` kernels of the
    port for each batch run, and the launch counters those of them that
    run outside the graphs (the head's, the sampler's, the pixel
    decoder's); print delivered img/s (under the profiler), p50/p95
    latency, occupancy, peak memory."""
    b0, occ0 = srv.stats["batches"], srv.stats["occupancy_sum"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (results, wall), ran = _device_counts(lambda: _serve(srv, requests))
    launches = _read_counts()
    _check_results(results, tag)
    nb = srv.stats["batches"] - b0
    want = {k: per_batch.get(k, 0) * nb for k in launches}
    eager = {k: want[k] if k in ("int8_matmul", "sampler", "conv3x3_s8")
             else 0 for k in launches}
    log(f"[{tag}] over {nb} batches: the port's kernels in the device "
        f"trace {ran}; launches counted on the host {launches}")
    if ran != want:
        raise AssertionError(f"[{tag}] device kernels {ran} != {want}")
    if launches != eager:
        raise AssertionError(f"[{tag}] launch counts {launches} != {eager}")
    lat = sorted(r.latency_s * 1e3 for r in results)
    occ = (srv.stats["occupancy_sum"] - occ0) / nb
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {len(requests)} requests in {wall:.3f} s: "
        f"{len(requests) / wall:.2f} img/s delivered, latency p50 "
        f"{lat[len(lat) // 2]:.1f} ms p95 {lat[int(len(lat) * 0.95)]:.1f} ms "
        f"max {lat[-1]:.1f} ms, {nb} batches, occupancy {occ:.3f}, "
        f"peak memory {peak:.2f} GiB")
    return results, launches


def _pixel_decoders(vae_cfg, vae, f_hat, sites):
    """The three pixel decoders on one B=16 f_hat: print their ms (CUDA
    events, best of 3 after a warm-up) and the |d| of the bf16 and W8A8
    images against the f32 golden one; require the W8A8 images bit-equal
    to the same decode with the plain conv on the card; return the conv
    launches per W8A8 decode."""
    runs = {"fhat_to_img (f32 golden)": lambda: fhat_to_img(vae_cfg, vae, f_hat),
            "fhat_to_img_nhwc (bf16)": lambda: fhat_to_img_nhwc(vae_cfg, vae, f_hat),
            "fhat_to_img_nhwc_w8a8_static": lambda: fhat_to_img_nhwc_w8a8_static(
                vae_cfg, vae, f_hat, sites)}
    imgs = {}
    with torch.inference_mode():
        for name, fn in runs.items():
            imgs[name] = fn()
            ms = [cuda_ms(fn, 1, warmup=0) for _ in range(3)]
            log(f"[pixels] {name} B={f_hat.shape[0]}: {min(ms):.3f} ms (runs "
                f"{', '.join(f'{t:.3f}' for t in ms)})")
        conv3x3_s8_kernel.launches = 0
        fhat_to_img_nhwc_w8a8_static(vae_cfg, vae, f_hat, sites)
        torch.cuda.synchronize()
    per_decode = conv3x3_s8_kernel.launches
    # the W8A8 decode with every site's conv in its plain version on the
    # card: the same bits
    real = conv_s8_ops.conv3x3_s8_ohwi
    conv_s8_ops.conv3x3_s8_ohwi = conv3x3_s8_plain
    try:
        with torch.inference_mode():
            plain_img = fhat_to_img_nhwc_w8a8_static(vae_cfg, vae, f_hat, sites)
    finally:
        conv_s8_ops.conv3x3_s8_ohwi = real
    same = torch.equal(plain_img, imgs["fhat_to_img_nhwc_w8a8_static"])
    log(f"[pixels] fhat_to_img_nhwc_w8a8_static through conv3x3_s8_kernel "
        f"against the same decode with conv3x3_s8_plain on the card: "
        f"bit-equal {same}")
    if not same:
        raise AssertionError("the W8A8 pixel decode through the conv kernel "
                             "differs from the decode with the plain conv")
    gold = imgs["fhat_to_img (f32 golden)"]
    for name in list(runs)[1:]:
        d = (imgs[name] - gold).abs()
        if imgs[name].shape != gold.shape or not torch.isfinite(imgs[name]).all():
            raise AssertionError(f"[pixels] {name}: bad image")
        log(f"[pixels] {name} against the golden decoder, images in [-1, 1]: "
            f"mean |d| {d.mean().item():.5f}, max |d| {d.max().item():.5f}")
    log(f"[pixels] conv3x3_s8 launches per W8A8 pixel decode: {per_decode}")
    return per_decode


def _repeat_check(first, again):
    """Images of the same requests from two batches must be bit-equal: a
    request's pixels depend on its (label, seed) alone."""
    differ = [i for i, (a, b) in enumerate(zip(first, again))
              if not (a == b).all()]
    log(f"[serve int8] {len(first)} requests again in another batch: "
        f"{len(first) - len(differ)} images bit-equal")
    if differ:
        d = abs(first[differ[0]].astype(int) - again[differ[0]].astype(int))
        raise AssertionError(f"{len(differ)} resubmitted requests gave other "
                             f"images, the first max |d| {d.max()} u8 steps")


def phase_serving(name):
    """The continuous-batching server at VAR-d30 256px: all-int8 (W8A8 +
    INT8 KV cache, the pixel decoder's sites calibrated with alpha=0.75,
    min_w=256 on two B=8 decodes, bucket 16, uint8 delivery:
    tools/bench_serving.py's pixq mode), then bf16 (channels-last bf16
    pixels)."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    params = _quantized_var(var_cfg, "w8a8")
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    t0 = time.time()
    cal = [decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                             torch.arange(8) + 100 * i, 40 + i, samp,
                             kv_mode="int8") for i in range(2)]
    sites = calibrate_decoder_w8a8(vae_cfg, vae, cal, alpha=0.75, min_w=256)
    n_q = sum(s is not None for s in sites)
    log(f"[serve] calibrated {len(sites)} pixel-decoder sites on two B=8 "
        f"decodes in {time.time() - t0:.1f} s: {n_q} quantized (min_w=256)")
    if len(sites) != 29 or n_q != 8:
        raise AssertionError(f"expected 29 sites, 8 quantized; got "
                             f"{len(sites)}, {n_q}")

    srv = GenerationServer(var_cfg, vae_cfg, params, vae, samp=samp,
                           max_batch=SERVE_B, buckets=[SERVE_B],
                           max_wait_ms=20.0, dtype=torch.bfloat16,
                           kv_mode="int8", pixel_sites=sites, deliver="u8")
    srv.start()
    S = len(PNS)
    per_batch = {"attention_int8": S * DEPTH, "act_quantize": 4 * S * DEPTH,
                 "int8_matmul": S, "sampler": S, "conv3x3_s8": 8}
    try:
        _serve_warm(srv, [(i, 1000 + i) for i in range(SERVE_B)], "serve int8",
                    per_batch, {"attention_int8": S * DEPTH,
                                "act_quantize": 4 * S * DEPTH})
        reqs = [((i * 37) % 1000, 10_000 + i) for i in range(3 * SERVE_B)]
        results, launches = _serve_measured(srv, reqs, "serve int8", per_batch)
        # the same (label, seed) pairs again, 16 of them drawn from all
        # three batches, in another order and composition
        pick = [47, 3, 30, 12, 25, 40, 8, 19, 33, 1, 44, 16, 27, 6, 38, 21]
        again, _ = _serve(srv, [reqs[i] for i in pick])
        _check_results(again, "serve int8")
        _repeat_check([results[i].image for i in pick],
                      [r.image for r in again])
    finally:
        srv.stop()

    with torch.inference_mode():
        f_hat = decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                                  torch.arange(SERVE_B) * 61 % 1000, 7, samp,
                                  kv_mode="int8")
    per_decode = _pixel_decoders(vae_cfg, vae, f_hat, sites)
    del params, srv, cal, f_hat
    torch.cuda.empty_cache()

    params = init_var_params(var_cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    srv = GenerationServer(var_cfg, vae_cfg, params, vae, samp=samp,
                           max_batch=SERVE_B, buckets=[SERVE_B],
                           max_wait_ms=20.0, dtype=torch.bfloat16,
                           deliver="u8")
    srv.start()
    per_batch = {"attention": S * DEPTH, "sampler": S}
    try:
        _serve_warm(srv, [(i, 2000 + i) for i in range(SERVE_B)], "serve bf16",
                    per_batch, {"attention": S * DEPTH})
        _serve_measured(srv, [((i * 53) % 1000, 20_000 + i)
                              for i in range(2 * SERVE_B)], "serve bf16",
                        per_batch)
    finally:
        srv.stop()
    del params, vae, srv
    torch.cuda.empty_cache()
    return launches["conv3x3_s8"], per_decode


def phase_conv_times(launches, per_decode, errs):
    """conv3x3_s8 at the pixel decoder's top level, B=16: kernel, plain
    (f64 convolution), bound, and the bf16 cuDNN convolution the site
    replaces (channels-last, same shape)."""
    Bc, H, W, C, O = CONV_FULL
    g = torch.Generator(device=DEV).manual_seed(4)
    x8 = torch.randint(-127, 128, (Bc, H, W, C), device=DEV, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device=DEV, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device=DEV, generator=g) * 2e-3
    bias = torch.randn(O, device=DEV, generator=g)
    k_ms = cuda_ms(lambda: conv3x3_s8_kernel(x8, wk, scale, bias), 20)
    p_ms = cuda_ms(lambda: conv3x3_s8_plain(x8, wk, scale, bias), 2, warmup=1)
    xb = torch.randn(Bc, C, H, W, device=DEV, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    wb = torch.randn(O, C, 3, 3, device=DEV, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    bb = bias.to(torch.bfloat16)
    c_ms = cuda_ms(lambda: F.conv2d(xb, wb, bb, padding=1), 20)
    bound, by = conv3x3_s8_bound(Bc, H, W, C, O, 2)
    plan = conv_plan(Bc, H, W, C, O)
    # conv_out (160 -> 3) on the narrow path, beside its cuDNN conv
    wn = wk[:3].contiguous()
    n_ms = cuda_ms(lambda: conv3x3_s8_kernel(x8, wn, scale[:3].contiguous(),
                                             bias[:3].contiguous()), 20)
    wbn = wb[:3].contiguous(memory_format=torch.channels_last)
    cn_ms = cuda_ms(lambda: F.conv2d(xb, wbn, bb[:3], padding=1), 20)
    n_bound = conv3x3_s8_bound(Bc, H, W, C, 3, 2)[0]
    log(f"[time] conv3x3_s8 (B={Bc} H={H} W={W} C={C} O={O}, int8 -> bf16, "
        f"{plan['path']} path, box {plan['box_w']}x{plan['box_h']}, "
        f"{plan['stages']} stages, grid {plan['grid']}): kernel_ms "
        f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms none bound_ms "
        f"{bound:.4f} ({by}); bf16_conv_ms {c_ms:.4f} (F.conv2d, cuDNN, "
        f"channels-last bf16, the conv the site replaces); launches per W8A8 "
        f"pixel decode {per_decode}; ptxas {conv_ptxas()}; conv_out (O=3, "
        f"{conv_plan(Bc, H, W, C, 3)['path']} path) kernel_ms {n_ms:.4f} "
        f"bound_ms {n_bound:.4f} bf16_conv_ms {cn_ms:.4f}")
    return {"name": "conv3x3_s8", "route": "cuda",
            "source": "sdvar_tpu_torch/csrc/conv_s8.cu",
            "replaces": "sdvar_tpu/ops/pallas/conv_s8.py:58",
            "launches": launches,
            "max_abs_err": errs[("conv3x3_s8", torch.bfloat16, CONV_FULL)],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "bf16_conv_ms": c_ms,
            "launches_per_pixel_decode": per_decode,
            "conv_out_narrow": {"ms": n_ms, "bound_ms": n_bound,
                                "bf16_conv_ms": cn_ms}}


SMALL_PNS = (1, 2, 3)


def _small_stack(quant=None, pns=SMALL_PNS, shared=False):
    """The small stack of the card-vs-CPU checks on the CPU (depth 2, 32
    per head, V=64, ``pns`` the schedule): head redrawn at 0.05 and the
    AdaLN biases (with ``shared``, the shared projection's bias and
    ada_gss) drawn at 0.3, both from seeded generators, so the blocks take
    part (the initialiser's AdaLN gammas of about 1e-5 would let every
    residual branch enter h at 1e-5 of its size); with
    ``quantize_var_params(mode=quant)``'s weights when ``quant``. Returns
    (vc, qc, params, vqvae)."""
    vc = VARConfig(depth=2, num_classes=10, patch_nums=pns, vocab_size=64,
                   Cvae=8, head_dim=32, shared_aln=shared)
    qc = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=pns)
    p = init_var_params(vc, seed=3, device="cpu")
    p["head"]["w"].normal_(0, 0.05, generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(6)
    if shared:
        p["shared_ada_lin"]["b"].normal_(0, 0.3, generator=gen)
        p["blocks"]["ada_gss"].normal_(0, 0.3, generator=gen)
    else:
        p["blocks"]["ada_lin_b"].normal_(0, 0.3, generator=gen)
    q = init_vqvae_params(qc, seed=4, device="cpu", eini=1.0)
    if quant:
        p = quantize_var_params(p, mode=quant)
    return vc, qc, p, q


def _max_gamma(vc, p, labels, dev="cpu") -> float:
    """The largest |gamma| (AdaLN's residual gates) the stack runs with on
    these labels' CFG rows."""
    lab = torch.tensor(list(labels) + [vc.num_classes] * len(labels),
                       device=dev)
    p = _to(p, dev)
    mods = precompute_modulations(vc, p, p["class_emb"][lab].float())
    return mods[:, :, :2].abs().max().item()


def phase_small_reference(quant=None):
    """The whole CUDA path against the CPU plain path on the small stack,
    greedy and f32, with plain weights or ``quantize_var_params(mode=
    quant)``'s: equal ids, close images."""
    samp = SamplingConfig(cfg=1.5, top_k=1)
    out = {}
    vc, qc, p0, q0 = _small_stack(quant)
    for dev in ("cpu", "cuda"):
        p, q = _to(p0, dev), _to(q0, dev)
        f_hat, ids = decode_all_scales(vc, qc, p, q["quant"], [3, 7], 0, samp,
                                       torch.float32, return_ids=True,
                                       device=dev)
        with torch.inference_mode():
            out[dev] = (ids.cpu(), fhat_to_img(qc, q, f_hat).cpu())
    same_ids = torch.equal(out["cpu"][0], out["cuda"][0])
    err = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
    log(f"[reference] small stack{f' ({quant})' if quant else ''}, largest "
        f"|gamma| {_max_gamma(vc, p0, [3, 7]):.3f}, card vs CPU plain path: "
        f"ids equal {same_ids}, image max|d| {err:.2e} (limit 1e-3)")
    if not same_ids or err > 1e-3:
        raise AssertionError("card path disagrees with the CPU reference")


def _small_forward(vc, p, dev, xs, cond):
    """One cached forward per scale of the small stack with an INT8 KV
    cache: the logits of every scale (vocab and rows gathered under a
    mesh) and the cache."""
    cache = QuantizedKVCache.create(vc, cond.shape[0], device=dev)
    logits = []
    with torch.inference_mode(), full_f32():
        for (bg, ed), x in zip(vc.begin_ends, xs):
            rows = data_rows(x.shape[0])
            h = apply_transformer(vc, p, x[rows].to(dev), cond[rows].to(dev),
                                  cache=cache, cache_begin=bg, kv_len=ed)
            lg = get_logits(vc, p, h, cond[rows].to(dev))
            logits.append(gather_data(gather_model(lg)).cpu())
    return torch.cat([lg.flatten() for lg in logits]), cache


def _small_inputs(vc):
    gen = torch.Generator().manual_seed(5)
    cond = torch.randn(4, vc.embed_dim, generator=gen)
    xs = [torch.randn(4, ed - bg, vc.embed_dim, generator=gen)
          for bg, ed in vc.begin_ends]
    return xs, cond


def phase_small_reference_quant():
    """The quantized CUDA path (w8a8 weights, INT8 KV cache, f32) against
    the CPU plain path on the small stack of ``phase_small_reference``:
    the logits of one cached forward over every scale within 1e-5 of their
    size, and equal greedy ids. The two compute the same quantized function
    and differ only in the order of f32 sums and in tanh's last bit, which
    moves a logit by about 1e-7 of its size; an activation that quantizes
    one int8 step apart (a rounding tie that flips) moves the logits by far
    more, and the failure names the first token whose id differs and its
    scale."""
    vc, qc, p, q = _small_stack("w8a8")
    xs, cond = _small_inputs(vc)
    out = {}
    for dev in ("cpu", DEV):
        pd, qd = _to(p, dev), _to(q, dev)
        logits, _ = _small_forward(vc, pd, dev, xs, cond)
        ids = decode_all_scales(vc, qc, pd, qd["quant"], [3, 7], 0,
                                SamplingConfig(cfg=1.5, top_k=1), torch.float32,
                                return_ids=True, kv_mode="int8", device=dev)[1]
        out[dev] = (logits, ids.cpu())
    lc, lg = out["cpu"][0], out[DEV][0]
    rel = ((lc - lg).abs().max() / lc.abs().max()).item()
    differ = (out["cpu"][1] != out[DEV][1]).nonzero().tolist()
    log(f"[reference] quantized small stack (w8a8, int8 KV, f32), largest "
        f"|gamma| {_max_gamma(vc, p, [3, 7]):.3f}, card vs CPU plain path: "
        f"logits max|d| / max|ref| {rel:.2e} (limit 1e-5), greedy ids differ "
        f"at {len(differ)} tokens (need 0)")
    if differ:
        row, tok = differ[0]
        si = next(i for i, (bg, ed) in enumerate(vc.begin_ends) if tok < ed)
        raise AssertionError(
            f"quantized greedy ids differ first at row {row}, token {tok} "
            f"(scale {si}, pn={SMALL_PNS[si]}): CPU "
            f"{out['cpu'][1][row, tok].item()} vs card "
            f"{out[DEV][1][row, tok].item()}")
    if rel > 1e-5:
        raise AssertionError(f"quantized card logits differ from the CPU "
                             f"reference by {rel:.2e} of their size")


def phase_kernel_times(launches, errs, smp):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    Bq, H, hd, Lmax = 2 * B, DEPTH, 64, 680
    cache = torch.randn(2, Bq, Lmax, H * hd, device=dev, generator=g).to(torch.bfloat16)

    def att_inputs(Lq, Lk):
        q = torch.randn(Bq, Lq, H, hd, device=dev, generator=g).to(torch.bfloat16)
        return (q, cache[0, :, :Lk].view(Bq, Lk, H, hd),
                cache[1, :, :Lk].view(Bq, Lk, H, hd))

    per_scale, total, dev_total = [], 0.0, 0.0
    cur = 0
    for pn in (1, 2, 3, 4, 5, 6, 8, 10, 13, 16):
        cur += pn * pn
        q, k, v = att_inputs(pn * pn, cur)
        ms = cuda_ms(lambda: attention_kernel(q, k, v, None, 1.0), 20)
        dms = device_ms(lambda: attention_kernel(q, k, v, None, 1.0), 20)
        per_scale.append(f"{pn * pn}x{cur}:{ms * 1e3:.1f}/{dms * 1e3:.1f}us")
        total += ms * DEPTH
        dev_total += dms * DEPTH
    log(f"[time] attention kernel per scale (Lq x Lk: us per launch at the "
        f"host's pace / queued on the device) {' '.join(per_scale)}; x{DEPTH} "
        f"layers = {total:.2f} ms per decode at the host's pace, "
        f"{dev_total:.2f} ms of device time")

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
        f"({a_by}) launches/decode {launches['attention'] // N_BATCHES}; "
        f"{attention_staging(Bq, 256, 680, H, hd, torch.bfloat16)}; ptxas "
        f"{attention_ptxas('bf16', False)}")

    M, V = B * 256, 4096
    logits = torch.randn(M, V, device=dev, generator=g) * 4
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=dev,
                          generator=g, dtype=torch.int32)
    # ms, plain_ms and the ten scales' total at the host's pace (cuda_ms),
    # one method for the kernel and its plain version; the device-paced
    # times (device_ms) beside them
    s_ms = cuda_ms(lambda: sample_kernel(logits, seeds, 900, 0.96), 50)
    s_dev = device_ms(lambda: sample_kernel(logits, seeds, 900, 0.96), 50)
    s_plain = cuda_ms(lambda: sample_plain(logits, seeds, 900, 0.96), 5, warmup=1)
    n_topk = sample_plain(logits, seeds, 900, 0.0, return_mask=True)[1].sum()
    s_bound, s_by = sampler_bound(M, V, n_topk.item())
    s_scales, s_scales_dev = [], []
    for pn in PNS:  # each scale's rows
        lg, sd = logits[: B * pn * pn], seeds[: B * pn * pn]
        s_scales.append(cuda_ms(lambda: sample_kernel(lg, sd, 900, 0.96), 10))
        s_scales_dev.append(device_ms(lambda: sample_kernel(lg, sd, 900, 0.96), 50))
    lg, sd = logits[:B], seeds[:B]
    for _ in range(20):
        sample_kernel(lg, sd, 900, 0.96)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        sample_kernel(lg, sd, 900, 0.96)
    torch.cuda.synchronize()
    s_host0 = (time.perf_counter() - t0) * 1e3 / 500
    log(f"[time] sampler scale 9 (M=4096 V=4096 top_k=900 top_p=0.96): "
        f"kernel_ms {s_ms:.4f} (device-paced {s_dev:.4f}) plain_ms "
        f"{s_plain:.4f} library_ms none bound_ms {s_bound:.4f} ({s_by}) "
        f"launches/decode {launches['sampler'] // N_BATCHES}; all 10 scales "
        f"{sum(s_scales):.4f} ms per decode; the ten scales (M = 16 pn^2, "
        f"device-paced) {' '.join(f'{x:.4f}' for x in s_scales_dev)} ms, "
        f"{sum(s_scales_dev):.4f} ms per decode; scale 0 host-paced "
        f"{s_host0:.4f} ms per call")
    del logits, seeds

    # INT8-KV attention: int8 cache slices and their scale planes
    vals, scales = _int8_cache(Bq, Lmax, H * hd, g)
    per_scale, total8, dev_total8, cur = [], 0.0, 0.0, 0
    for pn in PNS:
        cur += pn * pn
        q8 = torch.randn(Bq, pn * pn, H, hd, device=dev, generator=g).to(torch.bfloat16)
        k8, v8, sc8 = _int8_kv(vals, scales, cur, H, hd)
        ms = cuda_ms(lambda: attention_kernel(q8, k8, v8, None, 1.0, kv_scales=sc8), 20)
        dms = device_ms(lambda: attention_kernel(q8, k8, v8, None, 1.0,
                                                 kv_scales=sc8), 20)
        per_scale.append(f"{pn * pn}x{cur}:{ms * 1e3:.1f}/{dms * 1e3:.1f}us")
        total8 += ms * DEPTH
        dev_total8 += dms * DEPTH
    log(f"[time] attention_int8 kernel per scale (Lq x Lk: us per launch at "
        f"the host's pace / queued on the device) {' '.join(per_scale)}; "
        f"x{DEPTH} layers = {total8:.2f} ms per decode at the host's pace, "
        f"{dev_total8:.2f} ms of device time")
    k8, v8, sc8 = _int8_kv(vals, scales, 680, H, hd)
    # the library call gets k/v dequantised beforehand, outside the timing
    kd, vd = (dequantize_tokens(t.reshape(Bq, 680, H * hd), s).view(Bq, 680, H, hd)
              .transpose(1, 2) for t, s in ((k8, sc8[0]), (v8, sc8[1])))
    i_ms = cuda_ms(lambda: attention_kernel(q, k8, v8, None, 1.0, kv_scales=sc8), 50)
    i_plain = cuda_ms(lambda: attention_plain(q, k8, v8, None, 1.0, kv_scales=sc8), 10)
    i_lib = cuda_ms(lambda: sdpa(qt, kd, vd, scale=1.0), 50)
    i_bound, i_by = attention_int8_bound(Bq, 256, 680, H, hd)
    log(f"[time] attention_int8 scale 9 (2B=32 Lq=256 Lk=680 H=30 hd=64 q "
        f"bf16, k/v int8): kernel_ms {i_ms:.4f} plain_ms {i_plain:.4f} "
        f"library_ms {i_lib:.4f} (scaled_dot_product_attention on k/v "
        f"dequantised beforehand, the dequant not timed) bound_ms "
        f"{i_bound:.4f} ({i_by}) launches/decode "
        f"{launches['attention_int8'] // N_BATCHES}; "
        f"{attention_staging(Bq, 256, 680, H, hd, torch.int8)}; ptxas "
        f"{attention_ptxas('int8', False)}")

    M = 2 * B * 256
    x = (torch.randn(M, 7680, device=dev, generator=g) * 3).to(torch.bfloat16)
    bias = torch.randn(7680, device=dev, generator=g).to(torch.bfloat16)
    q_ms = cuda_ms(lambda: act_quantize_kernel(x, bias, True), 50)
    q_plain = cuda_ms(lambda: act_quantize_plain(x, bias, True), 10)
    q_bound, q_by = act_quantize_bound(M, 7680, True)
    x1 = x[:, :1920].contiguous()
    q1_ms = cuda_ms(lambda: act_quantize_kernel(x1, None, False), 50)
    q1_bound, q1_by = act_quantize_bound(M, 1920, False)
    x0 = x1[:2 * B].contiguous()  # scale 0: the host's pace
    for _ in range(20):
        act_quantize_kernel(x0, None, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        act_quantize_kernel(x0, None, False)
    torch.cuda.synchronize()
    q0_host = (time.perf_counter() - t0) * 1e3 / 500
    q0_dev = device_ms(lambda: act_quantize_kernel(x0, None, False), 50)
    log(f"[time] act_quantize scale 9 (M=8192 K=7680 bf16, bias + GELU): "
        f"kernel_ms {q_ms:.4f} plain_ms {q_plain:.4f} library_ms none "
        f"bound_ms {q_bound:.4f} ({q_by}) launches/decode "
        f"{launches['act_quantize'] // N_BATCHES}; K=1920 without GELU "
        f"kernel_ms {q1_ms:.4f} bound_ms {q1_bound:.4f} ({q1_by}); scale 0 "
        f"(M=32 K=1920) host-paced {q0_host:.4f} ms a call, device-paced "
        f"{q0_dev:.4f}; ptxas {act_quant_ptxas(True)}")
    # the 1x2 rank's fc2 input (K=3840): the two split-row passes beside
    # one whole pass; bounds: x and the bias read, scales written (scale
    # only), and x, the bias and the scales read, int8 written (given)
    xh, bh = x[:, :3840].contiguous(), bias[:3840].contiguous()
    sh = act_scale_kernel(xh, bh, True)
    split = {"scale_only_ms": cuda_ms(lambda: act_scale_kernel(xh, bh, True), 50),
             "given_scale_ms": cuda_ms(
                 lambda: act_quantize_kernel(xh, bh, True, scale=sh), 50),
             "one_pass_ms": cuda_ms(lambda: act_quantize_kernel(xh, bh, True), 50),
             "scale_only_bound_ms": (M * 3840 * 2 + 3840 * 2 + M * 4)
             / HBM_BPS * 1e3,
             "given_scale_bound_ms": act_quantize_bound(M, 3840, True)[0]}
    log(f"[time] act_quantize split row (M=8192 K=3840 bf16, bias + GELU, "
        f"the 1x2 rank's fc2 input): scale-only pass "
        f"{split['scale_only_ms']:.4f} ms (bound "
        f"{split['scale_only_bound_ms']:.4f}), given-scale pass "
        f"{split['given_scale_ms']:.4f} ms (bound "
        f"{split['given_scale_bound_ms']:.4f}), one whole pass "
        f"{split['one_pass_ms']:.4f} ms")

    K = 1920
    mm = {}
    for x_dtype, N in ((torch.float32, 4096), (torch.bfloat16, 7680)):
        xm = torch.randn(M, K, device=dev, generator=g).to(x_dtype)
        qw = quantize_weight(torch.randn(K, N, device=dev, generator=g) * 0.02)
        wd = dequantize_weight(qw, x_dtype)  # for the library call, untimed
        m_ms = cuda_ms(lambda: int8_matmul_kernel(xm, qw.q, qw.scale), 20)
        m_plain = cuda_ms(lambda: int8_matmul_plain(xm, qw.q, qw.scale), 10)
        m_lib = cuda_ms(lambda: torch.matmul(xm, wd), 20)
        m_dev = device_ms(lambda: int8_matmul_kernel(xm, qw.q, qw.scale), 20)
        m_bound, m_by = int8_matmul_bound(M, K, N, xm.element_size(),
                                          xm.element_size())
        mm[x_dtype] = (m_ms, m_plain, m_lib, m_bound, m_by)
        plan = matmul_plan(M, N, K, x_dtype)
        fma = (f"; the old f32-FMA figure {2 * M * K * N / F32_FLOPS * 1e3:.4f} "
               f"ms (2MKN at the CUDA cores' rate)" if N == 4096 else "")
        log(f"[time] int8_matmul {str(x_dtype)[6:]} (M=8192 K={K} N={N}, "
            f"{'the w8a8 head' if N == 4096 else 'the w8 fc1'}): kernel_ms "
            f"{m_ms:.4f} (device-paced {m_dev:.4f}) plain_ms {m_plain:.4f} "
            f"library_ms {m_lib:.4f} (torch.matmul on the dequantised weight, "
            f"the dequant not timed) bound_ms {m_bound:.4f} ({m_by}{fma}); "
            f"tile {plan['block_m']}x{plan['block_n']}, {plan['stages']} "
            f"stages, {plan['splits']} split(s) of K, {plan['smem_bytes']} B "
            f"dynamic shared memory; ptxas "
            f"{matmul_ptxas(x_dtype, plan)}")
    m_ms, m_plain, m_lib, m_bound, m_by = mm[torch.float32]
    b_ms, b_plain, b_lib, b_bound, b_by = mm[torch.bfloat16]

    kernels = [
        {"name": "attention", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/attention.cu",
         "replaces": "sdvar_tpu/ops/pallas/attention.py:46",
         "launches": launches["attention"],
         "max_abs_err": errs[(torch.bfloat16, 256, 680)],
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": a_lib},
        {"name": "sampler", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/sampler.cu",
         "replaces": "sdvar_tpu/ops/pallas/sampling.py:79",
         "launches": launches["sampler"],
         "max_abs_err": float(smp[(900, 0.96)][0]),
         "rows_equal": smp[(900, 0.96)][1],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None, "decode_ms": sum(s_scales),
         "device_ms": s_dev, "scales_device_ms": s_scales_dev,
         "decode_device_ms": sum(s_scales_dev),
         "host_paced_scale0_ms": s_host0},
        {"name": "attention_int8", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/attention.cu",
         "replaces": "sdvar_tpu/ops/pallas/attention.py:54",
         "launches": launches["attention_int8"],
         "max_abs_err": errs[("attention_int8", torch.bfloat16, 256, 680)],
         "ms": i_ms, "plain_ms": i_plain, "bound_ms": i_bound,
         "bound_by": i_by, "library_ms": i_lib},
        {"name": "act_quantize", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/act_quant.cu",
         "replaces": "sdvar_tpu/ops/pallas/quantize.py:46",
         "launches": launches["act_quantize"],
         "max_abs_err": errs[("act_quantize", 7680)],
         "ms": q_ms, "plain_ms": q_plain, "bound_ms": q_bound,
         "bound_by": q_by, "library_ms": None, "split_row_k3840": split,
         "k1920_ms": q1_ms, "k1920_bound_ms": q1_bound,
         "scale0_host_paced_ms": q0_host, "scale0_device_ms": q0_dev},
        {"name": "int8_matmul", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/matmul_int8.cu",
         "replaces": "sdvar_tpu/ops/pallas/matmul_int8.py:30",
         "launches": launches["int8_matmul"],
         "max_abs_err": errs[("int8_matmul", torch.float32, 4096)],
         "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
         "bound_by": m_by, "library_ms": m_lib,
         "bf16_fc1": {"ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
                      "bound_by": b_by, "library_ms": b_lib,
                      "max_abs_err": errs[("int8_matmul", torch.bfloat16, 7680)]}},
    ]
    return kernels


# the verify window timed and checked: start 8, gamma 2 (scales 8 and 9)
CACHE_SHAPES = {"scale 9": (256, 424, False), "verify window": (425, 255, True)}
CACHE_LI = 1  # the layer written and read, of a two-layer stacked cache


def _cache_case(g, int8, Lq, begin):
    """q (2B, Lq, H, 64) bf16; a (2, 2B, 680, C) stacked K and V cache
    full of other tokens (int8: with (2, 2B, 680) scale planes log-uniform
    in [1e-3, 1e2]); this scale's new rows (2B, Lq, H, 64): bf16 unit
    keys, as the l2-normalised keys are, or int8 from quantize_tokens."""
    Bq, H, hd, Lmax = 2 * B, DEPTH, 64, 680
    C = H * hd
    if int8:
        q = (torch.randn(Bq, Lq, H, hd, device=DEV, generator=g) * 1e-3).to(torch.bfloat16)
        ck, cv = (torch.randint(-127, 128, (2, Bq, Lmax, C), device=DEV,
                                generator=g, dtype=torch.int8) for _ in range(2))
        cs = tuple(_log_uniform((2, Bq, Lmax), 1e-3, 1e2, g) for _ in range(2))
        (kn, ks), (vn, vs) = (quantize_tokens(torch.randn(
            Bq, Lq, C, device=DEV, generator=g)) for _ in range(2))
        return (q, ck, cv, cs, kn.view(Bq, Lq, H, hd), vn.view(Bq, Lq, H, hd),
                (ks, vs))
    unit = lambda *shape: F.normalize(torch.randn(*shape, device=DEV, generator=g),
                                      dim=-1).to(torch.bfloat16)
    q = unit(Bq, Lq, H, hd) * 4
    ck = unit(2, Bq, Lmax, H, hd).view(2, Bq, Lmax, C)
    cv = torch.randn(2, Bq, Lmax, C, device=DEV, generator=g).to(torch.bfloat16)
    kn = unit(Bq, Lq, H, hd)
    vn = torch.randn(Bq, Lq, H, hd, device=DEV, generator=g).to(torch.bfloat16)
    return q, ck, cv, None, kn, vn, None


def _layer(q, ck, cv, cs, kv_len):
    """The cache layer's [0, kv_len) as attention_kernel takes it."""
    Bq, _, H, hd = q.shape
    k = ck[CACHE_LI, :, :kv_len].view(Bq, kv_len, H, hd)
    v = cv[CACHE_LI, :, :kv_len].view(Bq, kv_len, H, hd)
    return k, v, (None if cs is None else
                  (cs[0][CACHE_LI, :, :kv_len], cs[1][CACHE_LI, :, :kv_len]))


def _verify_bias(Lq, kv_len, with_bias):
    if not with_bias:
        return None
    return torch.from_numpy(verify_window_bias(PNS, 8, 2, kv_len)).to(DEV)


def phase_cache_kernel_checks():
    """The fused cache write + attention (row 8) and the full-cache
    attention (row 7) at the decode's scale-9 shape and at the verify
    window's (start 8, gamma 2, with its bias), bf16 and INT8 K/V: the
    written cache rows and scales bit-equal to the plain version's, the
    output bit-equal to the unfused pair (two copies, then
    attention_kernel on the layer's slice) and within the attention
    kernel's bf16 tolerance of the plain version (float: rtol = atol =
    2e-2; int8: 2e-2 of the output's size)."""
    g = torch.Generator(device=DEV).manual_seed(6)
    errs = {}
    li = CACHE_LI
    for int8 in (False, True):
        for tag, (Lq, begin, with_bias) in CACHE_SHAPES.items():
            q, ck, cv, cs, kn, vn, ns = _cache_case(g, int8, Lq, begin)
            kv_len = begin + Lq
            bias = _verify_bias(Lq, kv_len, with_bias)
            clone = lambda: (ck.clone(), cv.clone(),
                             None if cs is None else tuple(t.clone() for t in cs))
            (pk, pv, ps), (uk, uv, us) = clone(), clone()
            got = attention_cache_write_kernel(q, kn, vn, ck, cv, li, begin,
                                               kv_len, bias, 1.0, ns, cs)
            torch.cuda.synchronize()
            want = attention_cache_write_plain(q, kn, vn, pk, pv, li, begin,
                                               kv_len, bias, 1.0, ns, ps)
            Bq, _, H, hd = q.shape
            uk[li, :, begin:kv_len] = kn.reshape(Bq, Lq, H * hd)
            uv[li, :, begin:kv_len] = vn.reshape(Bq, Lq, H * hd)
            if us is not None:
                for plane, new in zip(us, ns):
                    plane[li, :, begin:kv_len] = new
            k, v, kv_scales = _layer(q, uk, uv, us, kv_len)
            unfused = attention_kernel(q, k, v, bias, 1.0, kv_scales=kv_scales)
            cache_equal = torch.equal(ck, pk) and torch.equal(cv, pv) and (
                cs is None or all(torch.equal(a, b) for a, b in zip(cs, ps)))
            err = (got.float() - want.float()).abs().max().item()
            if int8:
                close = err <= 2e-2 * want.float().abs().max().item()
            else:
                close = torch.allclose(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
            # row 7 over the cache just written: the same keys, the same bits
            got7 = attention_cache_kernel(q, ck, cv, li, kv_len, bias, 1.0, cs)
            torch.cuda.synchronize()
            want7 = attention_cache_plain(q, ck, cv, li, kv_len, bias, 1.0, cs)
            err7 = (got7.float() - want7.float()).abs().max().item()
            ok = (cache_equal and close and torch.equal(got, unfused)
                  and torch.equal(got7, got) and bool(torch.isfinite(got).all()))
            kind = "int8" if int8 else "bf16"
            log(f"[check] attention_cache_write {kind} {tag} (2B={2 * B} Lq={Lq} "
                f"cache_begin={begin} kv_len={kv_len}"
                f"{', bias' if with_bias else ''}): cache rows"
                f"{' and scales' if int8 else ''} bit-equal {cache_equal}, "
                f"output bit-equal to copy + attention_kernel "
                f"{torch.equal(got, unfused)}, max|d| to plain {err:.3e}; "
                f"attention_cache over it bit-equal {torch.equal(got7, got)}, "
                f"max|d| to plain {err7:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cache kernels disagree: {kind} {tag}")
            errs[("cache_write", int8, tag)] = err
            errs[("cache", int8, tag)] = err7
            del q, ck, cv, cs, kn, vn, pk, pv, ps, uk, uv, us
    torch.cuda.empty_cache()
    return errs


def phase_cache_switch(name):
    """VAR-d30 256px B=16 decode_all_scales with the cache-kernel switch
    off and on, bf16 and then W8A8 + INT8 KV: the ids and f_hat bit-equal;
    switched on, 300 fused write launches per decode and none of
    attention_kernel; latent ms of both settings, in turns."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    labels = torch.arange(B) * 61 % 1000
    S = len(PNS)
    out = {}
    for mode in ("bf16", "w8a8"):
        if mode == "bf16":
            params, kv = init_var_params(var_cfg, seed=0, device=DEV,
                                         dtype=torch.bfloat16), "bf16"
            want = _want(cache_write=S * DEPTH, sampler=S)
        else:
            params, kv = _quantized_var(var_cfg, "w8a8"), "int8"
            want = _want(cache_write_int8=S * DEPTH, act_quantize=4 * S * DEPTH,
                         int8_matmul=S, sampler=S)

        def run():
            return decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                                     labels, 9, samp, return_ids=True,
                                     kv_mode=kv)
        try:
            for on in (False, True):  # warm-up
                set_cache_kernel(on)
                run()
            set_cache_kernel(False)
            f_off, ids_off = run()
            set_cache_kernel(True)
            torch.cuda.synchronize()
            _reset_counts()
            f_on, ids_on = run()
            torch.cuda.synchronize()
            launches = _read_counts()
            same = torch.equal(ids_on, ids_off) and torch.equal(f_on, f_off)
            log(f"[switch] {mode} decode with set_cache_kernel(True): launches "
                f"per decode {launches}; ids and f_hat bit-equal to the switch "
                f"off {same}")
            if launches != want or not same:
                raise AssertionError(f"[switch] {mode}: launches {launches} "
                                     f"(want {want}), bit-equal {same}")
            ms = {False: [], True: []}
            for on in (False, True) * 3:
                set_cache_kernel(on)
                torch.cuda.synchronize()
                t0 = time.time()
                run()
                torch.cuda.synchronize()
                ms[on].append((time.time() - t0) * 1e3)
        finally:
            set_cache_kernel(False)
        log(f"[switch] {name} {mode}: B={B} latent decode switch off "
            f"{min(ms[False]):.1f} ms (runs {', '.join(f'{t:.1f}' for t in ms[False])})"
            f", on {min(ms[True]):.1f} ms (runs "
            f"{', '.join(f'{t:.1f}' for t in ms[True])}), in turns")
        out[mode] = launches
        del params, f_off, f_on
        torch.cuda.empty_cache()
    return out


def _spec_launches(st):
    """Launches of one speculative generation with the switch on: a fused
    write per layer of every draft scale (d16) and verify window (d30),
    one sampler per draft scale and per resampled scale."""
    return _want(cache_write=DRAFT_DEPTH * st.draft_calls + DEPTH * st.target_calls,
                 sampler=st.draft_calls + st.resampled_scales)


def _good_fhat(f_hat, tag):
    if f_hat.shape != (B, 32, 16, 16) or not torch.isfinite(f_hat).all():
        raise AssertionError(f"[{tag}] bad f_hat {tuple(f_hat.shape)}")


def phase_speculative(name):
    """The speculative engine at full width, the cache-kernel switch on:
    VAR-d16 self-draft greedy in f32 (every scale accepted, the d16
    baseline's ids), then VAR-d16 -> VAR-d30 in bf16: force_accept_all at
    gamma 2 and 3 (the pipeline ceiling) and the real accept rule, beside
    the d30 baseline decode, each timed best of 3 in turns."""
    vae_cfg = VQVAEConfig()
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    d_cfg, t_cfg = var_config_pair(DRAFT_DEPTH, DEPTH)
    labels = torch.arange(B) * 61 % 1000
    S = len(PNS)
    set_cache_kernel(True)
    try:
        # self-draft greedy, f32 with TF32 off, head x30 so the argmaxes
        # stand apart: a verify window's products have other shapes than
        # the per-scale decode's, and must not flip a near tie
        p16 = init_var_params(d_cfg, seed=5, device=DEV, dtype=torch.float32)
        p16["head"]["w"] *= 30.0
        greedy = SamplingConfig(cfg=1.5, top_k=1)
        eng = SpeculativeEngine(vae_cfg, d_cfg, d_cfg, vae, p16, p16,
                                dtype=torch.float32, kv_mode="f32")
        eng.generate_speculative(labels, 3, SpeculativeConfig(gamma=2), greedy)
        torch.cuda.synchronize()
        _reset_counts()
        f_hat, st, ids = eng.generate_speculative(
            labels, 3, SpeculativeConfig(gamma=2), greedy, return_ids=True)
        torch.cuda.synchronize()
        launches = _read_counts()
        _, base_ids = decode_all_scales(d_cfg, vae_cfg, p16, vae["quant"],
                                        labels, 3, greedy, torch.float32,
                                        return_ids=True, kv_mode="f32")
        want = _want(cache_write=DRAFT_DEPTH * (S + 5), sampler=S)
        ok = (st.accept_count == S and st.forced_accepts == 0
              and st.target_calls == 5 and torch.equal(ids, base_ids)
              and launches == want)
        log(f"[spec] self-draft d16/d16 greedy f32 gamma=2: {st.as_dict()}; "
            f"ids equal to the d16 baseline decode {torch.equal(ids, base_ids)}"
            f"; launches {launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("self-draft greedy must accept all 10 scales "
                                 "in 5 verify calls with the baseline's ids")
        _good_fhat(f_hat, "spec")
        del eng, p16, f_hat
        torch.cuda.empty_cache()

        samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
        p16 = init_var_params(d_cfg, seed=5, device=DEV, dtype=torch.bfloat16)
        p30 = init_var_params(t_cfg, seed=0, device=DEV, dtype=torch.bfloat16)
        eng = SpeculativeEngine(vae_cfg, d_cfg, t_cfg, vae, p16, p30)
        specs = {"force_accept_all gamma=2": SpeculativeConfig(gamma=2, force_accept_all=True),
                 "force_accept_all gamma=3": SpeculativeConfig(gamma=3, force_accept_all=True),
                 "accept rule gamma=2": SpeculativeConfig(gamma=2)}
        runs = {"d30 baseline": lambda: (decode_all_scales(
            t_cfg, vae_cfg, p30, vae["quant"], labels, 4, samp), None)}
        for tag, spec in specs.items():
            runs[tag] = functools.partial(eng.generate_speculative, labels, 4,
                                          spec, samp)
        for fn in runs.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted = {}
        for tag, fn in runs.items():
            _reset_counts()
            f_hat, st = fn()
            torch.cuda.synchronize()
            launches = _read_counts()
            _good_fhat(f_hat, "spec")
            want = (_want(cache_write=S * DEPTH, sampler=S) if st is None
                    else _spec_launches(st))
            calls = {"force_accept_all gamma=2": 5, "force_accept_all gamma=3": 4}
            ok = launches == want and (st is None or (
                st.accept_count == S
                and st.target_calls == calls.get(tag, st.target_calls)))
            log(f"[spec] d16 -> d30 {tag}: "
                f"{'baseline decode' if st is None else st.as_dict()}; launches "
                f"{launches} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[spec] {tag}: launches {launches} (want "
                                     f"{want}), stats {st}")
            counted[tag] = launches
        ms = {tag: [] for tag in runs}
        for _ in range(3):
            for tag, fn in runs.items():
                torch.cuda.synchronize()
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                ms[tag].append((time.time() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for tag, t in ms.items():
            log(f"[spec] {name} B={B} {tag}: latent {min(t):.1f} ms (runs "
                f"{', '.join(f'{x:.1f}' for x in t)})")
        log(f"[spec] peak memory with the d16 and d30 weights and both KV "
            f"caches: {peak:.2f} GiB")
    finally:
        set_cache_kernel(False)
    del eng, p16, p30
    torch.cuda.empty_cache()
    return counted["force_accept_all gamma=2"]


def phase_spec_serving(name):
    """The server in speculative mode, cache-kernel switch on: VAR-d16 ->
    VAR-d30, bf16, bucket 16, uint8 delivery, the channels-last bf16 pixel
    decoder; a warm bucket, then 32 requests, then the first batch's 16
    again as one batch (acceptance is batch-global: the same batch must
    give the same bits)."""
    vae_cfg = VQVAEConfig()
    d_cfg, t_cfg = var_config_pair(DRAFT_DEPTH, DEPTH)
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    p16 = init_var_params(d_cfg, seed=5, device=DEV, dtype=torch.bfloat16)
    p30 = init_var_params(t_cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    set_cache_kernel(True)
    srv = GenerationServer(t_cfg, vae_cfg, p30, vae, samp=samp,
                           max_batch=SERVE_B, buckets=[SERVE_B],
                           max_wait_ms=20.0, dtype=torch.bfloat16,
                           deliver="u8", draft_cfg=d_cfg, draft_params=p16)
    srv.start()
    try:
        warm, _ = _serve(srv, [(i, 3000 + i) for i in range(SERVE_B)])
        _check_results(warm, "serve spec")
        keys = ["batches"] + ["spec_" + k for k in
                              ("target_calls", "draft_calls", "accept_count",
                               "reject_count", "forced_accepts")]
        before = {k: srv.stats.get(k, 0) for k in keys}
        reqs = [((i * 29) % 1000, 30_000 + i) for i in range(2 * SERVE_B)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        results, wall = _serve(srv, reqs)
        torch.cuda.synchronize()
        launches = _read_counts()
        _check_results(results, "serve spec")
        d = {k: srv.stats.get(k, 0) - before[k] for k in keys}
        want = _want(cache_write=DRAFT_DEPTH * d["spec_draft_calls"]
                     + DEPTH * d["spec_target_calls"],
                     sampler=d["spec_draft_calls"])
        lat = sorted(r.latency_s * 1e3 for r in results)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[serve spec] {name}: {len(reqs)} requests in {wall:.3f} s: "
            f"{len(reqs) / wall:.2f} img/s delivered, latency p50 "
            f"{lat[len(lat) // 2]:.1f} ms p95 {lat[int(len(lat) * 0.95)]:.1f} "
            f"ms max {lat[-1]:.1f} ms, {d['batches']} batches, stats {d}, "
            f"launches {launches}, peak memory {peak:.2f} GiB")
        if launches != want or d["spec_accept_count"] != len(PNS) * d["batches"]:
            raise AssertionError(f"[serve spec] launches {launches} != {want} "
                                 f"or stats {d}")
        again, _ = _serve(srv, reqs[:SERVE_B])
        _check_results(again, "serve spec")
        differ = [i for i, r in enumerate(again)
                  if not (r.image == results[i].image).all()]
        log(f"[serve spec] the first batch's {SERVE_B} requests again as one "
            f"batch: {SERVE_B - len(differ)} images bit-equal")
        if differ:
            raise AssertionError(f"{len(differ)} images of the same batch "
                                 "differ")
    finally:
        srv.stop()
        set_cache_kernel(False)
    del srv, p16, p30, vae
    torch.cuda.empty_cache()


def phase_cache_kernel_times(launches, int8_launches, errs):
    """Rows 7 and 8 on the card: the fused write + attention at the
    decode's scale-9 shape (and the verify window's, with its bias) beside
    its plain version and the unfused pair it replaces (two copies, then
    attention_kernel: no single PyTorch call computes it); the full-cache
    attention at scale 9 beside scaled_dot_product_attention on the
    layer's slice."""
    g = torch.Generator(device=DEV).manual_seed(7)
    li, H, hd = CACHE_LI, DEPTH, 64
    t = {}
    for tag, (Lq, begin, with_bias) in CACHE_SHAPES.items():
        q, ck, cv, _, kn, vn, _ = _cache_case(g, False, Lq, begin)
        kv_len = begin + Lq
        bias = _verify_bias(Lq, kv_len, with_bias)
        Bq = q.shape[0]

        def unfused():
            ck[li, :, begin:kv_len] = kn.reshape(Bq, Lq, H * hd)
            cv[li, :, begin:kv_len] = vn.reshape(Bq, Lq, H * hd)
            k, v, _ = _layer(q, ck, cv, None, kv_len)
            return attention_kernel(q, k, v, bias, 1.0)
        w_ms = cuda_ms(lambda: attention_cache_write_kernel(
            q, kn, vn, ck, cv, li, begin, kv_len, bias, 1.0), 50)
        w_plain = cuda_ms(lambda: attention_cache_write_plain(
            q, kn, vn, ck, cv, li, begin, kv_len, bias, 1.0), 5, warmup=1)
        u_ms = cuda_ms(unfused, 50)
        w_bound, w_by = cache_write_bound(Bq, Lq, begin, H, hd, False, with_bias)
        t[tag] = {"ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
                  "bound_by": w_by, "unfused_ms": u_ms}
        log(f"[time] attention_cache_write {tag} (2B={Bq} Lq={Lq} cache_begin="
            f"{begin} kv_len={kv_len} H={H} hd={hd} bf16"
            f"{', bias' if with_bias else ''}): kernel_ms {w_ms:.4f} plain_ms "
            f"{w_plain:.4f} library_ms none (no single call); two copies + "
            f"attention_kernel {u_ms:.4f} ms; bound_ms {w_bound:.4f} ({w_by}); "
            f"{attention_staging(Bq, Lq, kv_len, H, hd, torch.bfloat16, True)}; "
            f"ptxas {attention_ptxas('bf16', True)}")
        if tag == "scale 9":
            sdpa = torch.nn.functional.scaled_dot_product_attention
            k, v, _ = _layer(q, ck, cv, None, kv_len)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            c_ms = cuda_ms(lambda: attention_cache_kernel(q, ck, cv, li, kv_len,
                                                          None, 1.0), 50)
            c_plain = cuda_ms(lambda: attention_cache_plain(
                q, ck, cv, li, kv_len, None, 1.0), 10)
            c_lib = cuda_ms(lambda: sdpa(qt, kt, vt, scale=1.0), 50)
            c_bound, c_by = attention_bound(Bq, Lq, kv_len, H, hd, 2)
            log(f"[time] attention_cache scale 9 (2B={Bq} Lq={Lq} kv_len={kv_len}, "
                f"layer {li} of the stacked cache, bf16): kernel_ms {c_ms:.4f} "
                f"plain_ms {c_plain:.4f} library_ms {c_lib:.4f} "
                f"(scaled_dot_product_attention on the layer's slice) bound_ms "
                f"{c_bound:.4f} ({c_by}); on no model path (0 launches); "
                f"{attention_staging(Bq, Lq, kv_len, H, hd, torch.bfloat16)}; "
                f"ptxas {attention_ptxas('bf16', False)}")
        del q, ck, cv, kn, vn
    q, ck, cv, cs, kn, vn, ns = _cache_case(g, True, 256, 424)
    i_ms = cuda_ms(lambda: attention_cache_write_kernel(
        q, kn, vn, ck, cv, li, 424, 680, None, 1.0, ns, cs), 50)
    i_bound, i_by = cache_write_bound(2 * B, 256, 424, H, hd, True, False)
    log(f"[time] attention_cache_write int8 scale 9: kernel_ms {i_ms:.4f} "
        f"bound_ms {i_bound:.4f} ({i_by}); launches per W8A8 + INT8-KV decode "
        f"with the switch on {int8_launches}; "
        f"{attention_staging(2 * B, 256, 680, H, hd, torch.int8, True)}; "
        f"ptxas {attention_ptxas('int8', True)}; the f32-cache instances: "
        f"{attention_ptxas('f32', False)} / {attention_ptxas('f32', True)}")
    del q, ck, cv, cs, kn, vn, ns
    torch.cuda.empty_cache()
    s9 = t["scale 9"]
    return [
        {"name": "attention_cache_write", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/attention.cu",
         "replaces": "sdvar_tpu/ops/pallas/experimental.py:199",
         "launches": launches,
         "max_abs_err": errs[("cache_write", False, "scale 9")],
         "ms": s9["ms"], "plain_ms": s9["plain_ms"],
         "bound_ms": s9["bound_ms"], "bound_by": s9["bound_by"],
         "library_ms": None, "unfused_ms": s9["unfused_ms"],
         "int8": {"ms": i_ms, "bound_ms": i_bound, "bound_by": i_by,
                  "launches_per_decode": int8_launches,
                  "max_abs_err": errs[("cache_write", True, "scale 9")]},
         "verify_window": t["verify window"]},
        {"name": "attention_cache", "route": "cuda",
         "source": "sdvar_tpu_torch/csrc/attention.cu",
         "replaces": "sdvar_tpu/ops/pallas/experimental.py:33",
         "launches": 0, "on_model_path": False,
         "max_abs_err": errs[("cache", False, "scale 9")],
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": c_lib},
    ]


# the microbenchmark's six d30 GEMMs (x (32, L, K): M = 32 * L) and one
# ragged M: scale 4's 25 tokens, M = 800, half a 64-row tile over
FUSED_SHAPES = microbench_int8_matmul.SHAPES + ((25, 1920, 7680, "fc1 s4"),)


def phase_fused_checks():
    """The fused W8A8 kernel (row 10) against its plain version at the
    microbenchmark's shapes. The s8 form must be bit-equal: both take the
    exact integer sum and round x / xs, float(acc) * xs and * ws as
    separate f32 operations. The bf16 form's f32 sum is exact while every
    partial sum stays below 2^24 and rounds beyond, in another order than
    the plain product's: within 2^-7 of max|y| (the output's bf16 step at
    its largest values) and different on at most 1e-3 of the outputs."""
    errs = {}
    for L, K, N, tag in FUSED_SHAPES:
        x, wq, ws, _ = microbench_int8_matmul.operands(L, K, N, DEV, seed=11)
        for s8 in (True, False):
            got = w8a8_fused_kernel(x, wq, ws, s8)
            torch.cuda.synchronize()
            want = w8a8_fused_plain(x, wq, ws, s8)
            d = (got.float() - want.float()).abs()
            err, frac = d.max().item(), (d != 0).float().mean().item()
            if s8:
                ok = torch.equal(got, want)
            else:
                ok = err <= 2 ** -7 * want.float().abs().max().item() and frac <= 1e-3
            log(f"[check] w8a8_fused {'s8' if s8 else 'bf16'} {tag} (M={x.shape[0] * L} "
                f"K={K} N={N}): max|d|={err:.3e}, {frac:.2e} of outputs differ"
                f"{', bit-equal required' if s8 else ''} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"w8a8_fused kernel disagrees: {tag} s8={s8}")
            errs[("w8a8_fused", s8, tag)] = err
            if tag in ("fc1 s9", "fc1 s4"):  # a CUDA graph replays the eager bits
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    replayed = w8a8_fused_kernel(x, wq, ws, s8)
                replayed.zero_()
                graph.replay()
                torch.cuda.synchronize()
                ok = torch.equal(replayed, got)
                log(f"[check] w8a8_fused {'s8' if s8 else 'bf16'} {tag} in a CUDA "
                    f"graph: replay bit-equal to eager {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("w8a8_fused graph replay differs from eager")
                del graph, replayed
        del x, wq, ws, got, want
    torch.cuda.empty_cache()
    return errs


def phase_fp8(name):
    """fp8 weights (e4m3 block weights, the head kept bf16, as the JAX
    package's default) at VAR-d30 256px B=16 through generate_images: per
    decode 300 attention and 10 sampler launches and no int8 kernel; the
    latent beside the bf16 one, in turns in this call."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    bf16 = init_var_params(var_cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    fp8 = quantize_var_params(bf16, mode="fp8")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(fp8))
    log(f"[fp8] VAR-d{DEPTH} fp8 ({nbytes / 2 ** 30:.2f} GiB of parameters, "
        f"head {fp8['head']['w'].dtype})")
    labels = torch.arange(B) * 61 % 1000
    generate_images(var_cfg, vae_cfg, fp8, vae, labels, 0, samp)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    img = generate_images(var_cfg, vae_cfg, fp8, vae, labels, 1, samp)
    torch.cuda.synchronize()
    launches = _read_counts()
    S = len(PNS)
    want = _want(attention=S * DEPTH, sampler=S)
    log(f"[fp8] kernel launches over one fp8 generate_images: {launches}")
    if launches != want:
        raise AssertionError(f"fp8 path launch counts {launches} != {want}")
    if img.shape != (B, 3, 256, 256) or not torch.isfinite(img).all() \
            or img.min() < 0 or img.max() > 1:
        raise AssertionError(f"[fp8] bad images {tuple(img.shape)}")
    ms = {"bf16": [], "fp8": []}
    for tag in ("bf16", "fp8") * 3:
        p = bf16 if tag == "bf16" else fp8
        torch.cuda.synchronize()
        t0 = time.time()
        decode_all_scales(var_cfg, vae_cfg, p, vae["quant"], labels, 20, samp)
        torch.cuda.synchronize()
        ms[tag].append((time.time() - t0) * 1e3)
    log(f"[fp8] {name} B={B} latent decode, in turns: bf16 {min(ms['bf16']):.1f} "
        f"ms (runs {', '.join(f'{t:.1f}' for t in ms['bf16'])}), fp8 "
        f"{min(ms['fp8']):.1f} ms (runs {', '.join(f'{t:.1f}' for t in ms['fp8'])})")
    del bf16, fp8, vae, img
    torch.cuda.empty_cache()


def phase_sample_fid(name):
    """The FID sampler at VAR-d30 256px, bf16 weights: 32 class-balanced
    samples in batches of B=16 with the golden f32 pixel decoder, packed
    into an npz in a temporary directory, read back as uint8 (32, 256, 256,
    3), the run under ``torch.profiler``. The first batch captures the
    scales' graphs and replays them, the second replays them: the device
    trace holds 300 attention and 10 sampler kernels a batch, and the
    attention launch counter ticks 300 times in all, at the capture."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    params = init_var_params(var_cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    labels = balanced_labels(2 * B)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "samples.npz")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()

        def sample():
            batches = sample_batches(var_cfg, vae_cfg, params, vae, labels, B,
                                     samp, log_every=1)
            try:
                create_npz_from_arrays(batches, out, num=len(labels))
            finally:
                batches.close()

        _, ran = _device_counts(sample)
        wall = time.time() - t0
        launches = _read_counts()
        arr = np.load(out)["arr_0"]
    S = len(PNS)
    want_ran = _want(attention=2 * S * DEPTH, sampler=2 * S)
    want = _want(attention=S * DEPTH, sampler=2 * S)
    log(f"[fid] {name}: {len(labels)} samples, B={B}, f32 pixels, into an npz "
        f"in {wall:.3f} s under the profiler: {len(labels) / wall:.2f} img/s "
        f"end to end; npz {arr.dtype} {arr.shape}; the port's kernels in the "
        f"device trace {ran}; launches counted on the host {launches}")
    if arr.shape != (2 * B, 256, 256, 3) or arr.dtype != np.uint8 \
            or ran != want_ran or launches != want:
        raise AssertionError(f"[fid] npz {arr.dtype} {arr.shape}, device "
                             f"kernels {ran} (want {want_ran}), launches "
                             f"{launches} (want {want})")
    del params, vae
    torch.cuda.empty_cache()


def phase_benchmark_cli():
    """The benchmark CLI through its main, as from the command line:
    gamma mode (VAR-d16 -> VAR-d30, batch 8, one timed run per gamma) and
    quant mode (w8, fp8, w8a8, w8a8 + INT8 KV against bf16, batch 8). Its
    rows' keys are held against the JAX package's on the CPU."""
    S = len(PNS)
    _reset_counts()
    rows = benchmark_cli.main(["--mode", "gamma", "--batch", "8", "--iters", "1"])
    torch.cuda.synchronize()
    launches = _read_counts()
    log(f"[cli] gamma launches {launches}")
    if [r["gamma"] for r in rows] != [1, 2, 3] or launches["attention"] == 0 \
            or any(r["accept_count"] != S or r["sec_per_batch"] <= 0 for r in rows):
        raise AssertionError(f"[cli] gamma rows {rows}")
    torch.cuda.empty_cache()
    _reset_counts()
    rows = benchmark_cli.main(["--mode", "quant", "--batch", "8"])
    torch.cuda.synchronize()
    launches = _read_counts()
    log(f"[cli] quant launches {launches}")
    if [r["quant"] for r in rows] != ["w8", "fp8", "w8a8", "w8a8+int8kv"] or any(
            not 0 <= r["token_agreement_vs_bf16"] <= 1
            or not math.isfinite(r["latent_mse_vs_bf16"]) for r in rows) \
            or 0 in (launches["int8_matmul"], launches["act_quantize"],
                     launches["attention_int8"]):
        raise AssertionError(f"[cli] quant rows {rows}, launches {launches}")
    torch.cuda.empty_cache()


def phase_bench_serving():
    """tools/bench_serving's run at VAR-d30: 32 requests, bucket 16, W8A8 +
    INT8 KV, uint8 delivery, under ``torch.profiler``. Counts set to 0
    before the run and read after: two warm-up and two measured batches,
    each 300 INT8-KV attention, 1200 act_quantize, 10 int8 head matmul and
    10 sampler kernels in the device trace. The first batch captures the
    bucket's graphs, the others replay them: the launch counters tick for
    the blocks' kernels once, at the capture, and for the head's and the
    sampler's a batch."""
    S = len(PNS)
    torch.cuda.synchronize()
    _reset_counts()
    out, ran = _device_counts(
        lambda: bench_serving.run(DEPTH, 2 * SERVE_B, SERVE_B, "w8a8-int8kv-u8"))
    launches = _read_counts()
    nb = 2 + out["batches"]
    want_ran = _want(attention_int8=nb * S * DEPTH,
                     act_quantize=4 * nb * S * DEPTH, int8_matmul=nb * S,
                     sampler=nb * S)
    want = _want(attention_int8=S * DEPTH, act_quantize=4 * S * DEPTH,
                 int8_matmul=nb * S, sampler=nb * S)
    log(f"[bench_serving] {json.dumps(out)} (under the profiler); the port's "
        f"kernels in the device trace {ran}; launches counted on the host "
        f"{launches}")
    if ran != want_ran or launches != want or out["batches"] != 2:
        raise AssertionError(f"[bench_serving] device kernels {ran} != "
                             f"{want_ran} or launches {launches} != {want}")
    torch.cuda.empty_cache()


def phase_bench():
    """``python -m sdvar_tpu_torch.bench`` in a process of its own, as a
    user runs it: it must exit 0 with exactly one JSON line on stdout,
    holding the four keys."""
    torch.cuda.empty_cache()
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "sdvar_tpu_torch.bench"],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    for line in res.stderr.splitlines()[-12:]:
        log(f"[bench] stderr: {line}")
    lines = res.stdout.splitlines()
    log(f"[bench] exit {res.returncode} in {time.time() - t0:.1f} s; stdout: {lines}")
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError("bench must exit 0 with one stdout line")
    row = json.loads(lines[0])
    if set(row) != {"metric", "value", "unit", "vs_baseline"} or row["value"] <= 0:
        raise AssertionError(f"bench line {row}")


def phase_microbench(errs):
    """tools/microbench_int8_matmul's pass over its six shapes and six
    modes, the fused kernel's path: counts set to 0 just before and read
    just after (one warm-up and ITERS launches of each fused form at each
    shape). Then row 10's line at fc1 s9 (M=8192, K=1920, N=7680): the pl_s8
    time beside the plain version, the bound and two library figures,
    torch._int_mm on pre-quantized operands (the product alone, the
    microbenchmark's int8_int32) and the port's three-launch w8a8_matmul
    (w8a8_s8); fc2 s9 and the bf16 form beside it."""
    torch.cuda.synchronize()
    _reset_counts()
    rows = microbench_int8_matmul.run()
    torch.cuda.synchronize()
    launches = _read_counts()
    n = len(rows) * 2 * (microbench_int8_matmul.ITERS + 1)
    log(f"[micro] launches over the pass: {launches}")
    if launches["w8a8_fused"] != n:
        raise AssertionError(f"[micro] w8a8_fused launched "
                             f"{launches['w8a8_fused']} times, want {n}")
    by = {r["shape"]: r for r in rows}
    shapes = {}
    for r in rows:  # the six shapes: the fused forms beside the library calls
        shapes[r["shape"]] = {"ms": r["pl_s8"]["ms"], "bf16_form_ms": r["pl_bf16"]["ms"],
                              "int_mm_ms": r["int8_int32"]["ms"],
                              "w8a8_matmul_ms": r["w8a8_s8"]["ms"]}
        log(f"[time] w8a8_fused {r['shape']} (L={r['L']} K={r['K']} N={r['N']}): "
            f"s8 {r['pl_s8']['ms']:.4f} ms, bf16 form {r['pl_bf16']['ms']:.4f} ms; "
            f"torch._int_mm {r['int8_int32']['ms']:.4f} ms, w8a8_matmul "
            f"{r['w8a8_s8']['ms']:.4f} ms; fused s8 faster than w8a8_matmul: "
            f"{r['pl_s8']['ms'] < r['w8a8_s8']['ms']}")
    line = {}
    for tag in ("fc1 s9", "fc2 s9"):
        r = by[tag]
        M, K, N = microbench_int8_matmul.B * r["L"], r["K"], r["N"]
        x, wq, ws, _ = microbench_int8_matmul.operands(r["L"], K, N, DEV)
        p_ms = cuda_ms(lambda: w8a8_fused_plain(x, wq, ws, True), 3, warmup=1)
        bound, bound_by = w8a8_fused_bound(M, K, N, True)
        b_bound, _ = w8a8_fused_bound(M, K, N, False)
        line[tag] = {"ms": r["pl_s8"]["ms"], "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": r["int8_int32"]["ms"],
                     "library_ms_w8a8_matmul": r["w8a8_s8"]["ms"],
                     "bf16_form_ms": r["pl_bf16"]["ms"], "bf16_form_bound_ms": b_bound,
                     "bf16_ms": r["bf16"]["ms"], "convert_ms": r["w8a8"]["ms"]}
        log(f"[time] w8a8_fused {tag} (M={M} K={K} N={N}): kernel_ms "
            f"{r['pl_s8']['ms']:.4f} plain_ms {p_ms:.4f} library_ms "
            f"{r['int8_int32']['ms']:.4f} (torch._int_mm, pre-quantized "
            f"operands) and {r['w8a8_s8']['ms']:.4f} (w8a8_matmul, three "
            f"launches) bound_ms {bound:.4f} ({bound_by}); bf16 form "
            f"{r['pl_bf16']['ms']:.4f} (bound {b_bound:.4f}); bf16 matmul "
            f"{r['bf16']['ms']:.4f}")
        del x, wq, ws
    torch.cuda.empty_cache()
    fc1 = line.pop("fc1 s9")
    return {"name": "w8a8_fused", "route": "cuda",
            "source": "sdvar_tpu_torch/csrc/w8a8_fused.cu",
            "replaces": "tools/microbench_int8_matmul.py:42",
            "launches": launches["w8a8_fused"],
            "max_abs_err": errs[("w8a8_fused", True, "fc1 s9")],
            **fc1, "fc2_s9": line["fc2 s9"], "shapes": shapes}


# ---------------------------------------------------------------------------
# Sixth slice: the repaired divisions, the f32 server, the mesh
# ---------------------------------------------------------------------------

def _tie_data(shape, dtype, axis: int, seed: int) -> torch.Tensor:
    """Random data whose every slice along ``axis`` holds its amax (1.5)
    and a run of elements at exactly amax / 2: rounding ties of x / s."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 0.5).clamp(-1.4, 1.4).movedim(axis, -1)
    x[..., 0] = 1.5
    x[..., 1:9] = 0.75
    x[..., 9:13] = -0.75
    return x.movedim(-1, axis).to(dtype).contiguous()


def phase_quant_bits():
    """The card's scale bits and int8 (e4m3) values against the CPU's for
    the four quantizers that divide by 127 (448): ``quantize_weight``,
    ``quantize_weight_fp8`` (d30 qkv-shaped weights), ``quantize_tokens``
    (the INT8 KV of a scale-9 layer) and the dynamic scales of
    ``conv2d_nhwc_w8a8``, on bf16 and f32 data full of ties."""
    def same(a, b):
        if a.dtype == torch.float8_e4m3fn:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        return torch.equal(a.cpu(), b.cpu())

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        w = _tie_data((2, 1920, 5760), dtype, axis=-2, seed=1)
        for fn in (quantize_weight, quantize_weight_fp8):
            c, g = fn(w), fn(w.to(DEV))
            rows.append((f"{fn.__name__} {str(dtype)[6:]}",
                         same(c.scale, g.scale), same(c.q, g.q)))
        x = _tie_data((32, 256, 1920), dtype, axis=-1, seed=2)
        (cq, cs), (gq, gs) = quantize_tokens(x), quantize_tokens(x.to(DEV))
        rows.append((f"quantize_tokens {str(dtype)[6:]}", same(cs, gs),
                     same(cq, gq)))
    seen = []  # the CPU's operands, then the card's
    real = conv_s8_ops.conv3x3_s8

    def capture(xq, wq, scale, bias, out_dtype):
        seen.append((xq, wq, scale))
        return real(xq, wq, scale, bias, out_dtype)

    conv_s8_ops.conv3x3_s8 = capture
    try:
        cp = {"w": _tie_data((160, 160, 3, 3), torch.float32, axis=1, seed=3),
              "b": torch.zeros(160)}
        cx = _tie_data((2, 32, 32, 160), torch.bfloat16, axis=-1, seed=4)
        conv_s8_ops.conv2d_nhwc_w8a8(cp, cx)
        conv_s8_ops.conv2d_nhwc_w8a8(_to(cp, DEV), cx.to(DEV))
    finally:
        conv_s8_ops.conv3x3_s8 = real
    (xc, wc, sc), (xg, wg, sg) = seen
    rows.append(("conv2d_nhwc_w8a8 dynamic", same(sc, sg),
                 same(xc, xg) and same(wc, wg)))
    for tag, s_ok, q_ok in rows:
        log(f"[bits] {tag}: card scales bit-equal to the CPU's {s_ok}, "
            f"values bit-equal {q_ok}")
    if not all(s_ok and q_ok for _, s_ok, q_ok in rows):
        raise AssertionError("the card's quantization bits differ from the CPU's")


def phase_f32_server(name):
    """The f32 server (f32 weights and KV cache, the golden f32 NCHW pixel
    decoder, uint8 delivery) at VAR-d30, bucket 16: 16 requests, then the
    same 16 in reverse order, so in other slots: bit-equal images."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    params = init_var_params(var_cfg, seed=0, device=DEV, dtype=torch.float32)
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    srv = GenerationServer(var_cfg, vae_cfg, params, vae, samp=samp,
                           max_batch=SERVE_B, buckets=[SERVE_B],
                           max_wait_ms=20.0, dtype=torch.float32,
                           kv_mode="f32", deliver="u8", device=DEV)
    srv.start()
    try:
        reqs = [((i * 41) % 1000, 50_000 + i) for i in range(SERVE_B)]
        first, wall = _serve(srv, reqs)
        _check_results(first, "serve f32")
        again, wall2 = _serve(srv, reqs[::-1])
        _check_results(again, "serve f32")
    finally:
        srv.stop()
    differ = [i for i in range(SERVE_B)
              if not (first[i].image == again[SERVE_B - 1 - i].image).all()]
    log(f"[serve f32] {name}: {SERVE_B} requests in {wall:.3f} s (the first "
        f"batch, warm-up included) and again in reverse slots in "
        f"{wall2:.3f} s: {SERVE_B - len(differ)} of {SERVE_B} images "
        f"bit-equal")
    if differ:
        i = differ[0]
        d = abs(first[i].image.astype(int) - again[SERVE_B - 1 - i].image.astype(int))
        raise AssertionError(f"the f32 server's pixels depend on the batch "
                             f"slot: {len(differ)} images differ, the first "
                             f"by up to {d.max()} u8 steps")
    del params, vae, srv
    torch.cuda.empty_cache()


def phase_probe_times(launches):
    """Row 9: the probe kernel (``o = x * 2.0``, (8, 512) f32) against its
    plain version (bit-equal, also on an unaligned view), its time beside
    the plain version's, the bound and ``x * 2.0`` as one PyTorch call,
    each host-paced (``cuda_ms``: one launch after another at the host's
    pace) and device-paced (``device_ms``: queued behind a spin kernel);
    ``launches`` per rank from the sharded probe of the mesh phase."""
    x = torch.randn(8, 512, device=DEV)
    got, want = scale_probe_kernel(x), scale_probe_plain(x)
    odd = x.view(-1)[1:]  # 4 bytes off 16-byte alignment: the scalar path
    if not (torch.equal(got, want)
            and torch.equal(scale_probe_kernel(odd), scale_probe_plain(odd))):
        raise AssertionError("scale_probe kernel disagrees with x * 2.0")
    fns = {"kernel": lambda: scale_probe_kernel(x),
           "plain": lambda: scale_probe_plain(x),
           "library": lambda: torch.mul(x, 2.0)}
    host = {k: cuda_ms(f, 200) for k, f in fns.items()}
    dev = {k: device_ms(f, 200) for k, f in fns.items()}
    bound = 2 * x.numel() * 4 / HBM_BPS * 1e3
    log(f"[time] scale_probe (8, 512) f32, host-paced / device-paced ms: "
        f"kernel {host['kernel']:.4f} / {dev['kernel']:.4f}, plain "
        f"{host['plain']:.4f} / {dev['plain']:.4f}, torch.mul(x, 2.0) "
        f"{host['library']:.4f} / {dev['library']:.4f}; bound_ms "
        f"{bound:.7f} (bytes: 16 KiB read, 16 KiB written); bit-equal to the "
        f"plain version; launches per rank in the sharded probe {launches}; "
        f"ptxas {_kernel_ptxas('scale_probe', 'scale_probe_kernel')}")
    return {"name": "scale_probe", "route": "cuda",
            "source": "sdvar_tpu_torch/csrc/scale_probe.cu",
            "replaces": "tests/test_tp_pallas.py:194",
            "launches": launches[0], "launches_per_rank": launches,
            "max_abs_err": (got - want).abs().max().item(),
            "ms": host["kernel"], "plain_ms": host["plain"], "bound_ms": bound,
            "bound_by": "bytes", "library_ms": host["library"],
            "device_paced": {"ms": dev["kernel"], "plain_ms": dev["plain"],
                             "library_ms": dev["library"]}}


MESH_WORLD = 2
MESH_TIMEOUT = 420.0
MESH_LABELS = torch.arange(B) * 61 % 1000
MESH_SEED = 7
SMALL_MESHES = {"1x2": MeshConfig(data=1, model=2),
                "2x1": MeshConfig(data=2, model=1)}


def _mesh_var(var_cfg, mode):
    """VAR-d30 of the mesh phase: the bf16 path's seed with AdaLN biases
    drawn at 0.3 from a seeded generator on the card, as the small stacks'
    are, so the blocks take part (the initialiser's gammas of about 1e-5
    would let no partial sum move a token); quantized for "w8a8"."""
    p = init_var_params(var_cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    b = p["blocks"]["ada_lin_b"]
    b.copy_(torch.randn(b.shape, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(6)) * 0.3)
    if mode == "w8a8":
        p = quantize_var_params(p, mode="w8a8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return p


def _mesh_decode_ids(var_cfg, vae_cfg, params, quant, samp, kv_mode):
    return decode_all_scales(var_cfg, vae_cfg, params, quant, MESH_LABELS,
                             MESH_SEED, samp, return_ids=True, kv_mode=kv_mode,
                             gather=True, device=DEV)[1]


def phase_mesh(name):
    """The mesh paths on two ranks that share cuda:0 (gloo: NCCL refuses
    two ranks on one card), started by ``parallel.launch`` with a deadline:
    a rank that fails or exits non-zero fails the run. Here, before: the
    unsharded d30 decodes the ranks' ids are compared with. After: the
    ranks' reports, held against each other and against those ids."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    quant = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)["quant"]
    ref = {}
    for mode in ("bf16", "w8a8"):
        params = _mesh_var(var_cfg, mode)
        if mode == "bf16":
            gamma = _max_gamma(var_cfg, params, MESH_LABELS.tolist(), DEV)
            log(f"[mesh] d30 params: AdaLN biases drawn at 0.3, largest "
                f"|gamma| {gamma:.3f}")
        ref[mode] = _mesh_decode_ids(var_cfg, vae_cfg, params, quant, samp,
                                     "bf16" if mode == "bf16" else "int8").cpu()
        del params
    del quant
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        logs = launch([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                       out], MESH_WORLD, MESH_TIMEOUT)
        wall = time.time() - t0
        reps = []
        for r in range(MESH_WORLD):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reps.append(json.load(f))
        arrs = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                for r in range(MESH_WORLD)]
    for line in logs[0].splitlines():
        if line.startswith("[mesh"):
            log(line)
    log(f"[mesh] {MESH_WORLD} ranks on cuda:0 (gloo) ran in {wall:.1f} s, "
        f"each exited 0")
    for r in range(1, MESH_WORLD):
        for line in logs[r].splitlines():
            if line.startswith("[mesh] rank") or line.startswith("[mesh d30"):
                log(line)
    for tag in ("d30 1x2 bf16", "d30 1x2 w8a8", "d30 2x1 bf16", "d30 2x1 w8a8",
                "spec 1x2"):
        key = tag.replace(" ", "_") + "_ids"
        a, b = arrs[0][key], arrs[1][key]
        if not np.array_equal(a, b):
            raise AssertionError(f"[mesh] {tag}: the ranks' ids differ at "
                                 f"{(a != b).mean():.4f} of the tokens")
        if tag.startswith("d30"):
            want = ref["bf16" if tag.endswith("bf16") else "w8a8"].numpy()
            share = float((a == want).mean())
            reps[0][tag]["share_equal_unsharded"] = share
            # W8A8 on 1x2 sums int32 partials and quantizes with the whole
            # row's scale: the unsharded ids are required there; bf16
            # partial sums round before the reduce, so bf16 is reported
            gated = tag == "d30 1x2 w8a8"
            log(f"[mesh] {tag}: both ranks' ids identical; share of tokens "
                f"equal to the unsharded decode of the same seeds {share:.6f}"
                f"{' (1 required)' if gated else ''}")
            if gated and share != 1.0:
                raise AssertionError(f"[mesh] {tag}: ids differ from the "
                                     f"unsharded decode on "
                                     f"{1 - share:.6f} of the tokens")
    srv = [rep["server 1x2"] for rep in reps]
    if any(s["delivered_once"] is not True or s["resubmitted_bit_equal"] != SERVE_B
           for s in srv):
        raise AssertionError(f"[mesh] server: {srv}")
    if not np.array_equal(arrs[0]["server_imgs"], arrs[1]["server_imgs"]):
        raise AssertionError("[mesh] server: the model ranks delivered other "
                             "images")
    return reps


def _mesh_run_small(rep, arrs):
    """The small stack on the card under each small mesh: against the
    unsharded card path of this rank (f32 greedy): plain ids equal and
    f_hat within 1e-5 of its size; W8A8 + INT8 KV logits within 1e-5 of
    their size, ids equal, the layer-0 scale-0 KV scale planes bit-equal
    (a rank-local amax would move them)."""
    samp = SamplingConfig(cfg=1.5, top_k=1)
    xs, cond = _small_inputs(_small_stack()[0])
    for quant in (None, "w8a8"):
        vc, qc, p, q = _small_stack(quant)
        qd = _to(q, DEV)
        kv = "int8" if quant else "f32"
        set_tp_mesh(None)
        pd = _to(p, DEV)
        f_ref, ids_ref = decode_all_scales(vc, qc, pd, qd["quant"], [3, 7, 1, 8],
                                           0, samp, torch.float32,
                                           return_ids=True, kv_mode=kv,
                                           device=DEV)
        if quant:
            lg_ref, cache_ref = _small_forward(vc, pd, DEV, xs, cond)
        for tag, mcfg in SMALL_MESHES.items():
            mesh = create_mesh(mcfg)
            set_tp_mesh(mesh)
            ps = shard_tree(pd, var_param_specs(vc, mesh), mesh)
            f_hat, ids = decode_all_scales(vc, qc, ps, qd["quant"], [3, 7, 1, 8],
                                           0, samp, torch.float32,
                                           return_ids=True, kv_mode=kv,
                                           gather=True, device=DEV)
            ok = torch.equal(ids, ids_ref)
            line = f"[mesh small {tag}{' w8a8 int8kv' if quant else ''}] ids equal to the unsharded card path {ok}"
            if quant:
                lg, cache = _small_forward(vc, ps, DEV, xs, cond)
                rel = ((lg - lg_ref).abs().max() / lg_ref.abs().max()).item()
                planes = all(torch.equal(
                    gather_data(getattr(cache, s)[0, :, :1], dim=0).cpu(),
                    getattr(cache_ref, s)[0, :, :1].cpu()) for s in ("k_s", "v_s"))
                ok = ok and rel <= 1e-5 and planes
                line += (f", logits max|d| / max|ref| {rel:.2e} (limit 1e-5), "
                         f"layer-0 scale-0 KV scale planes bit-equal {planes}")
            else:
                rel = ((f_hat - f_ref).abs().max() / f_ref.abs().max()).item()
                ok = ok and rel <= 1e-5
                line += f", f_hat max|d| / max|ref| {rel:.2e} (limit 1e-5)"
            log(f"{line} {'ok' if ok else 'FAIL'}")
            rep[f"small {tag} {quant or 'f32'}"] = ok
            if not ok:
                raise AssertionError(line)
            set_tp_mesh(None)


def _mesh_run_d30(rep, arrs, tag, mcfg):
    """VAR-d30 B=16 on a mesh (``_mesh_var``'s weights), bf16 then W8A8 +
    INT8 KV: one timed decode, its first on the mesh (no warm-up and no
    repeat, to keep the whole script inside its time budget); counts set
    to 0 just before it and read just after it (per rank)."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    quant = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)["quant"]
    mesh = create_mesh(mcfg)
    set_tp_mesh(mesh)
    S, tp = len(PNS), mcfg.model
    for mode in ("bf16", "w8a8"):
        full = _mesh_var(var_cfg, mode)
        params = shard_tree(full, var_param_specs(var_cfg, mesh), mesh)
        del full
        torch.cuda.empty_cache()
        kv = "bf16" if mode == "bf16" else "int8"
        # act-quant: qkv and fc1 once a layer, proj and fc2 twice when the
        # model is split (the scale-only pass, then the quantizing pass
        # with the row's all-reduced scale)
        want = (_want(attention=S * DEPTH, sampler=S) if mode == "bf16" else
                _want(attention_int8=S * DEPTH, sampler=S, int8_matmul=S,
                      act_quantize=(4 if tp == 1 else 6) * S * DEPTH))
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        ids = _mesh_decode_ids(var_cfg, vae_cfg, params, quant, samp, kv)
        torch.cuda.synchronize()
        lat = [(time.time() - t0) * 1e3]
        launches = _read_counts()
        key = f"d30 {tag} {mode}"
        rep[key] = {"launches": launches, "latent_ms": lat,
                    "rows_per_rank": B // mcfg.data,
                    "heads_per_rank": DEPTH // tp}
        arrs[key.replace(" ", "_") + "_ids"] = ids.cpu().numpy()
        ok = launches == want and ids.shape == (B, var_cfg.L)
        log(f"[mesh d30 {tag} {mode}] rank {mesh.rank}: B={B} ({B // mcfg.data} "
            f"rows, {DEPTH // tp} heads per rank) latent {min(lat):.1f} ms "
            f"(runs {', '.join(f'{t:.1f}' for t in lat)}); launches per "
            f"decode {launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[mesh] {key}: launches {launches} != {want}")
        del params
        torch.cuda.empty_cache()
    set_tp_mesh(None)


def _mesh_run_server(rep, arrs):
    """The mesh server (1x2, W8A8 + INT8 KV, u8, bucket 16; its kernels
    warmed by the d30 decodes before it): 32 requests, each delivered once
    on each rank (one data group each), then 16 of them again in reverse
    order: bit-equal images."""
    var_cfg, vae_cfg = VARConfig(depth=DEPTH), VQVAEConfig()
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    params = _quantized_var(var_cfg, "w8a8")
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    srv = GenerationServer(var_cfg, vae_cfg, params, vae, samp=samp,
                           max_batch=SERVE_B, buckets=[SERVE_B],
                           max_wait_ms=20.0, dtype=torch.bfloat16,
                           kv_mode="int8", deliver="u8",
                           mesh_cfg=MeshConfig(data=1, model=2), device=DEV)
    del params
    srv.start()
    try:
        reqs = [((i * 43) % 1000, 40_000 + i) for i in range(2 * SERVE_B)]
        c0 = srv.stats["completed"]
        results, wall = _serve(srv, reqs)
        _check_results(results, "mesh server")
        once = (srv.stats["completed"] - c0 == len(reqs)
                and len({r.id for r in results}) == len(reqs)
                and not srv._results)
        again, _ = _serve(srv, reqs[:SERVE_B][::-1])
        _check_results(again, "mesh server")
    finally:
        srv.stop()
    same = sum(bool((results[i].image == again[SERVE_B - 1 - i].image).all())
               for i in range(SERVE_B))
    lat = sorted(r.latency_s * 1e3 for r in results)
    rep["server 1x2"] = {"delivered_once": once, "resubmitted_bit_equal": same,
                         "img_per_s": len(reqs) / wall, "wall_s": wall,
                         "p50_ms": lat[len(lat) // 2]}
    arrs["server_imgs"] = np.stack([r.image for r in results])
    log(f"[mesh server 1x2] rank {DIST.get_rank()}: {len(reqs)} requests in "
        f"{wall:.3f} s, {len(reqs) / wall:.2f} img/s delivered, p50 "
        f"{lat[len(lat) // 2]:.1f} ms; each delivered once {once}; {SERVE_B} "
        f"again in reverse slots: {same} of {SERVE_B} bit-equal")
    del srv, vae
    torch.cuda.empty_cache()


def _mesh_run_spec(rep, arrs):
    """The speculative engine on the 1x2 mesh: VAR-d16 -> VAR-d30, bf16,
    force_accept_all at gamma 2: 5 verify calls, every scale accepted."""
    vae_cfg = VQVAEConfig()
    d_cfg, t_cfg = var_config_pair(DRAFT_DEPTH, DEPTH)
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    vae = init_vqvae_params(vae_cfg, seed=1, device=DEV, eini=1.0)
    mesh = create_mesh(MeshConfig(data=1, model=2))
    set_tp_mesh(mesh)
    specs = var_param_specs(t_cfg, mesh), var_param_specs(d_cfg, mesh)
    p30 = shard_tree(init_var_params(t_cfg, seed=0, device=DEV,
                                     dtype=torch.bfloat16), specs[0], mesh)
    p16 = shard_tree(init_var_params(d_cfg, seed=5, device=DEV,
                                     dtype=torch.bfloat16), specs[1], mesh)
    eng = SpeculativeEngine(vae_cfg, d_cfg, t_cfg, vae, p16, p30, mesh=mesh,
                            device=DEV)
    spec = SpeculativeConfig(gamma=2, force_accept_all=True)
    eng.generate_speculative(MESH_LABELS, 4, spec, samp)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    f_hat, st, ids = eng.generate_speculative(MESH_LABELS, 4, spec, samp,
                                              return_ids=True)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    launches = _read_counts()
    S = len(PNS)
    want = _want(attention=DRAFT_DEPTH * st.draft_calls + DEPTH * st.target_calls,
                 sampler=st.draft_calls)
    ok = (st.target_calls == 5 and st.accept_count == S and launches == want
          and f_hat.shape == (B, 32, 16, 16) and bool(torch.isfinite(f_hat).all()))
    rep["spec 1x2"] = {"stats": st.as_dict(), "latent_ms": ms,
                       "launches": launches}
    arrs["spec_1x2_ids"] = ids.cpu().numpy()
    log(f"[mesh spec 1x2] rank {mesh.rank}: d16 -> d30 force_accept_all "
        f"gamma=2: {st.as_dict()}; latent {ms:.1f} ms; launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[mesh] spec: {st.as_dict()}, {launches} != {want}")
    set_tp_mesh(None)
    del eng, p16, p30
    torch.cuda.empty_cache()


def _mesh_gloo_rate(rep):
    """What one model-split collective costs here: the all-reduce (sum) of
    a scale-9 proj output of this rank, (2B*256, 1920), as bf16 (the bf16
    path) and as int32 (the W8A8 path), over the 1x2 mesh's gloo group,
    through host memory; host clock around 5 calls each after one warm-up,
    each ending in a synchronize."""
    mesh = create_mesh(MeshConfig(data=1, model=MESH_WORLD))
    rates = {}
    for dtype in (torch.bfloat16, torch.int32):
        t = torch.ones(2 * B * 256, DEPTH * 64, dtype=dtype, device=DEV)
        mesh.all_reduce(t)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.time()
            mesh.all_reduce(t)
            torch.cuda.synchronize()
            ms.append((time.time() - t0) * 1e3)
        mb = t.numel() * t.element_size() / 1e6
        rates[str(dtype)[6:]] = {"mb": mb, "ms": min(ms), "runs_ms": ms}
        log(f"[mesh gloo] rank {mesh.rank}: all_reduce of {mb:.1f} MB "
            f"{str(dtype)[6:]} (2B*256 x 1920) over 2 ranks on one card: "
            f"{min(ms):.2f} ms (runs {', '.join(f'{x:.2f}' for x in ms)}), "
            f"{mb / min(ms):.3f} GB/s of the tensor")
        del t
    rep["gloo all_reduce"] = rates


def mesh_rank_main(out_dir: str) -> int:
    """One rank of ``phase_mesh``: the sharded probe, the small stacks, the
    d30 decodes, the mesh server and the speculative engine; writes its
    report and its ids for the parent."""
    DIST.initialize()
    torch.cuda.set_device(DIST.rank_device())
    rank = DIST.get_rank()
    rep, arrs = {"rank": rank}, {}
    mesh = create_mesh(MeshConfig(data=1, model=MESH_WORLD))
    set_tp_mesh(mesh)
    x = torch.randn(8, 512, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(9))
    _reset_counts()
    got = sharded_scale_probe(x)
    torch.cuda.synchronize()
    n = scale_probe_kernel.launches
    ok = (torch.equal(got, scale_probe_kernel(x))
          and torch.equal(got, scale_probe_plain(x)))
    rep["probe"] = {"launches": n, "bit_equal": ok}
    log(f"[mesh probe] rank {rank}: the sharded probe (this rank's 256 "
        f"columns, then all-gathered) bit-equal to one unsharded launch and "
        f"to x * 2.0 {ok}; {n} launch on this rank")
    if not ok or n != 1:
        raise AssertionError(f"the sharded probe: bit-equal {ok}, {n} "
                             f"launches on this rank (want 1)")
    set_tp_mesh(None)
    _mesh_gloo_rate(rep)
    _mesh_run_small(rep, arrs)
    for tag, mcfg in (("1x2", MeshConfig(data=1, model=2)),
                      ("2x1", MeshConfig(data=2, model=1))):
        _mesh_run_d30(rep, arrs, tag, mcfg)
    _mesh_run_server(rep, arrs)
    _mesh_run_spec(rep, arrs)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    DIST.shutdown()
    return 0


# ---------------------------------------------------------------------------
# the eleventh slice: VAR training (d16 256px bs 32, AdamW) and the repairs
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_DEPTH = 32, 16
TRAIN_PREFIX = 424  # the sequence at prog_si = 8 (scales up to 13x13)


def _grad_err(got, want):
    """max|d| / max|want| of a gradient, f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _rounding_apart(got, want, rel: float = 1e-3) -> bool:
    """Whether two bf16 results of one f32 computation, summed in other
    orders, are at most one bf16 rounding apart beyond ``rel`` of their
    size: |d| <= 2^-7 |want| + rel max|want|, element by element."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= want.abs() * 2.0 ** -7
                 + rel * want.abs().max()).all())


def _train_att_bound(Bq, L, H, hd, bias):
    """(bound ms, bound_by) of the training attention: q, k, v and the bias
    read once, o written once (bf16), against 4*hd flops per (query, key)
    pair the block-causal bias lets through (this run's bias), at the bf16
    peak."""
    pairs = int((bias > float("-inf")).sum().item())
    nbytes = 2 * Bq * H * hd * 4 * L + 4 * L * L
    flops = 4 * Bq * H * hd * pairs
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_train_attention():
    """Kernel row 1 at the training shape (B=32, H=16, hd=64, bf16, q/k/v
    strided views of one fused projection, the block-causal f32 bias), at
    the full 680 tokens and the prog_si = 8 prefix (424): the forward
    against ``attention_plain`` at the row-1 checks' tolerance; the
    Function's dq/dk/dv within 1e-3 of their size of autograd through
    ``attention_composition`` (the JAX package's reference, whose VJP the
    whole-tensor backward is: bf16 probabilities in bf16) and, in f32, of
    autograd through ``attention_plain``; a forced-chunk backward (f32
    probabilities, as the JAX package's chunked backward) in f32 within
    1e-5 of the whole-tensor one, in bf16 at most one bf16 rounding beyond
    1e-3 of their size from autograd through ``attention_plain`` (f32
    probabilities too). The gap that the probabilities' bf16 rounding opens
    in bf16 is printed, not gated. Then the times. Then the same at the
    d36-512 training step's shape (``_train_attention_d36``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    H, hd = TRAIN_DEPTH, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for L in (680, TRAIN_PREFIX):
        bias = device_bias(dev, block_causal_prefix, PNS, L)
        for dtype in ((torch.bfloat16, torch.float32) if L == 680
                      else (torch.bfloat16,)):
            qkv = torch.randn(TRAIN_B, L, 3, H, hd, device=dev, generator=g)
            qkv[:, :, :2] = torch.nn.functional.normalize(qkv[:, :, :2], dim=-1) * 4
            qkv = qkv.to(dtype)
            go = torch.randn(TRAIN_B, L, H, hd, device=dev, generator=g).to(dtype)
            q, k, v = qkv.unbind(2)
            got = attention_kernel(q, k, v, bias, 1.0).float()
            want = attention_plain(q.float(), k.float(), v.float(), bias, 1.0)
            err = (got - want).abs().max().item()
            ok = (err <= 1e-4 if dtype == torch.float32 else
                  torch.allclose(got, want, rtol=2e-2, atol=2e-2))
            grads = {}
            fns = {"function": ATT.attention, "chunked": ATT.attention,
                   "composition": ATT.attention_composition,
                   "plain": attention_plain}
            for tag, fn in fns.items():
                x = qkv.detach().requires_grad_()
                qx, kx, vx = x.unbind(2)
                set_attention_bwd_chunk(136 if tag == "chunked" else 0)
                try:
                    grads[tag] = torch.autograd.grad(
                        fn(qx, kx, vx, bias, 1.0), x, go)[0]
                finally:
                    set_attention_bwd_chunk(None)

            def rel(a, b):
                return max(_grad_err(grads[a][:, :, i], grads[b][:, :, i])
                           for i in range(3))

            g_err, p_gap = rel("function", "composition"), rel("function", "plain")
            c_err, c_gap = rel("chunked", "plain"), rel("chunked", "function")
            bf16 = dtype == torch.bfloat16
            ok = ok and g_err <= 1e-3 and (bf16 or p_gap <= 1e-3)
            ok = ok and (all(_rounding_apart(grads["chunked"][:, :, i],
                                             grads["plain"][:, :, i])
                             for i in range(3)) if bf16 else c_gap <= 1e-5)
            tag = f"[train attention] B={TRAIN_B} L={L} H={H} hd={hd} {str(dtype)[6:]}"
            log(f"{tag}: forward max|d| {err:.3e}; Function dq/dk/dv against "
                f"autograd through attention_composition: max|d| / max|ref| "
                f"{g_err:.2e} (limit 0.001), through attention_plain "
                f"{p_gap:.2e} ({'printed: bf16 against f32 probabilities' if bf16 else 'limit 0.001'}); "
                f"forced chunks of 136 against the whole-tensor backward "
                f"{c_gap:.2e} ({'printed' if bf16 else 'limit 1e-05'}), "
                f"against autograd through attention_plain {c_err:.2e} "
                f"({'within one bf16 rounding beyond 0.001 of their size' if bf16 else 'printed'}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: the attention or its gradient "
                                     f"disagrees")
            if dtype != torch.bfloat16:
                continue
            del grads
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            k_ms = cuda_ms(lambda: attention_kernel(q, k, v, bias, 1.0), 20)
            p_ms = cuda_ms(lambda: attention_plain(q, k, v, bias, 1.0), 5, warmup=1)
            l_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias.to(dtype),
                                        scale=1.0), 20)
            x = qkv.detach().requires_grad_()
            qx, kx, vx = x.unbind(2)

            def fwd_bwd():
                y = ATT.attention(qx, kx, vx, bias, 1.0)
                torch.autograd.grad(y, x, go)

            fb_ms = cuda_ms(fwd_bwd, 5, warmup=1)
            bound, by = _train_att_bound(TRAIN_B, L, H, hd, bias)
            out[L] = {"kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                      "bound_ms": bound, "bound_by": by,
                      "function_fwd_bwd_ms": fb_ms, "max_abs_err": err}
            log(f"[time] {tag}, block-causal bias: kernel_ms {k_ms:.4f} "
                f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
                f"(scaled_dot_product_attention, the same float attn_mask) "
                f"bound_ms {bound:.4f} ({by}); the Function's forward + "
                f"backward {fb_ms:.4f} ms")
            del x, qx, kx, vx
        torch.cuda.empty_cache()
    out["d36-512"] = _train_attention_d36(dev, g)
    torch.cuda.empty_cache()
    return out

def _train_attention_d36(dev, g):
    """Kernel row 1 at the d36-512 training step's shape (B=2, L=2240,
    H=36, hd=64, bf16, q/k/v strided views of one fused projection, the
    512px block-causal f32 bias), whose query tiles run past the 1024 of
    the high-resolution decode check: the forward within one bf16 step
    at the largest output, 2^-7 of it, of ``attention_plain`` in f32, and
    ``attention_plain`` without the last ring tile of keys (and their
    bias columns) must fall outside that limit; the Function's dq/dk/dv
    as the training step takes them (chunked by shape at this length,
    f32 probabilities) at most one bf16 rounding beyond 1e-3 of their size
    from autograd through ``attention_plain``, and its whole-tensor
    backward within 1e-3 of their size of autograd through
    ``attention_composition``. Then the times beside the bound and
    ``scaled_dot_product_attention``."""
    B, L, H, hd = D36_TRAIN_B, D36_512.L, D36_512.num_heads, 64
    bias = device_bias(dev, block_causal_prefix, PATCH_NUMS_512, L)
    qkv = torch.randn(B, L, 3, H, hd, device=dev, generator=g)
    qkv[:, :, :2] = F.normalize(qkv[:, :, :2], dim=-1) * 4
    qkv = qkv.to(torch.bfloat16)
    go = torch.randn(B, L, H, hd, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    got = attention_kernel(q, k, v, bias, 1.0).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    want = attention_plain(qf, kf, vf, bias, 1.0)
    err = (got - want).abs().max().item()
    lim = 2 ** -7 * want.abs().max().item()
    full = L - (L % KEY_TILE or KEY_TILE)
    drop = (attention_plain(qf, kf[:, :full], vf[:, :full], bias[:, :full], 1.0)
            - want).abs().max().item()
    del got, want, qf, kf, vf
    grads = {}
    for tag, fn, chunk in (("function", ATT.attention, None),
                           ("whole", ATT.attention, 0),
                           ("composition", ATT.attention_composition, None),
                           ("plain", attention_plain, None)):
        x = qkv.detach().requires_grad_()
        qx, kx, vx = x.unbind(2)
        set_attention_bwd_chunk(chunk)
        try:
            grads[tag] = torch.autograd.grad(fn(qx, kx, vx, bias, 1.0), x, go)[0]
        finally:
            set_attention_bwd_chunk(None)
        del x, qx, kx, vx

    def rel(a, b):
        return max(_grad_err(grads[a][:, :, i], grads[b][:, :, i])
                   for i in range(3))

    chunk = ATT.bwd_chunk_for(L, L)
    w_err, c_gap = rel("whole", "composition"), rel("function", "plain")
    apart = all(_rounding_apart(grads["function"][:, :, i], grads["plain"][:, :, i])
                for i in range(3))
    ok = err <= lim and w_err <= 1e-3 and apart and chunk > 0
    tag = f"[train attention] d36-512 B={B} L={L} H={H} hd={hd} bf16"
    log(f"{tag}: forward max|d| {err:.3e} against attention_plain in f32 "
        f"(limit {lim:.3e}, 2^-7 of the largest output; without the last "
        f"{L - full} keys, one ring tile, the plain version is {drop:.3e} "
        f"off); the Function's dq/dk/dv (chunks of {chunk} query rows, as "
        f"the step takes them) against autograd through attention_plain: "
        f"max|d| / max|ref| {c_gap:.2e}, within one bf16 rounding beyond "
        f"0.001 of their size {apart}; the whole-tensor backward against "
        f"autograd through attention_composition {w_err:.2e} (limit 0.001) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the attention or its gradient disagrees")
    if drop <= lim:
        raise AssertionError(f"{tag}: the limit cannot see a dropped key tile")
    del grads
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    k_ms = cuda_ms(lambda: attention_kernel(q, k, v, bias, 1.0), 20)
    p_ms = cuda_ms(lambda: attention_plain(q, k, v, bias, 1.0), 5, warmup=1)
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias.to(torch.bfloat16), scale=1.0), 20)
    x = qkv.detach().requires_grad_()
    qx, kx, vx = x.unbind(2)

    def fwd_bwd():
        torch.autograd.grad(ATT.attention(qx, kx, vx, bias, 1.0), x, go)

    fb_ms = cuda_ms(fwd_bwd, 5, warmup=1)
    bound, by = _train_att_bound(B, L, H, hd, bias)
    log(f"[time] {tag}, block-causal bias: kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} library_ms {l_ms:.4f} (scaled_dot_product_attention, "
        f"the same float attn_mask) bound_ms {bound:.4f} ({by}); the "
        f"Function's forward + backward {fb_ms:.4f} ms")
    return {"kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound, "bound_by": by, "function_fwd_bwd_ms": fb_ms,
            "max_abs_err": err, "limit": lim, "last_tile_dropped": drop,
            "grad_err_composition": w_err, "grad_gap_plain": c_gap}


def _train_small():
    """The small training stack of the card-vs-CPU check (depth 2, 48px,
    V=64, head_dim 32; deterministic forward, AdaLN biases at 0.3)."""
    vc = VARConfig(depth=2, num_classes=10, patch_nums=SMALL_PNS, vocab_size=64,
                   Cvae=8, head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0)
    qc = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=SMALL_PNS)
    p = init_var_params(vc, seed=3, device="cpu")
    p["blocks"]["ada_lin_b"].normal_(0, 0.3,
                                     generator=torch.Generator().manual_seed(6))
    q = init_vqvae_params(qc, seed=4, device="cpu", eini=1.0)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 3, 48, 48)).astype(np.float32))
    return vc, qc, p, q, img, torch.tensor([0, 3, 5, 9])


def phase_train_small_reference():
    """One f32 ``train_step`` (AdamW, label smoothing 0.1) of the small
    stack on the card against the same step on the CPU plain path, at the
    CPU tests' tolerances: token ids equal, loss and grad_norm within 1e-5
    relative, m and v within 1e-4 of each tensor's size, parameters
    within 1e-6 except at most 0.1% of elements within 2 lr."""
    vc, qc, p, q, img, label = _train_small()
    lr = 1e-4
    res = {}
    for dev in ("cpu", DEV):  # copies: a step writes into its state
        st = TR.init_train_state(_to(p, dev, copy=True))
        vae = _to(q, dev)
        _, gt, _ = TR.tokenize(vc, qc, vae, img.to(dev))
        _reset_counts()
        st, m = TR.train_step(vc, qc, st, vae, img.to(dev), label.to(dev), lr,
                              0.05, None, label_smooth=0.1, dtype=torch.float32)
        torch.cuda.synchronize()
        res[dev] = (gt.cpu(), st, {k: float(v) for k, v in m.items()},
                    attention_kernel.launches)
    (gc, sc, mc, _), (gg, sg, mg, n_att) = res["cpu"], res[DEV]
    ids_ok = torch.equal(gc, gg)
    scal = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss", "grad_norm"))
    mom = {name: max(_grad_err(a.cpu(), b) for (_, a), (_, b) in zip(
        TR.tree_leaves(sg.opt_state[name]), TR.tree_leaves(sc.opt_state[name])))
        for name in ("mu", "nu")}
    n_far = n_all = 0
    worst = 0.0
    for (_, a), (_, b) in zip(TR.tree_leaves(sg.params), TR.tree_leaves(sc.params)):
        d = (a.cpu().double() - b.double()).abs()
        worst = max(worst, d.max().item())
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    share = n_far / n_all
    ok = (ids_ok and scal <= 1e-5 and max(mom.values()) <= 1e-4
          and share <= 1e-3 and worst <= 2 * lr + 1e-6 and n_att == vc.depth)
    log(f"[train reference] small stack f32 train_step, card vs CPU plain "
        f"path: ids equal {ids_ok}; loss {mg['loss']:.6f} / {mc['loss']:.6f}, "
        f"loss and grad_norm max rel. d {scal:.2e} (limit 1e-5); max|d| / "
        f"size of m {mom['mu']:.2e}, of v {mom['nu']:.2e} (limit 1e-4); "
        f"parameters beyond 1e-6: share "
        f"{share:.6f} (limit 0.001), max|d| {worst:.2e} (limit 2 lr); "
        f"{n_att} f32 hd=32 attention launches (want {vc.depth}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the training step on the card disagrees with "
                             "the CPU")


def _finite_tree(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for _, t in TR.tree_leaves(tree))


@contextlib.contextmanager
def _optimizer_peak():
    """For the block, each call of ``train.trainer.apply_optimizer`` (from
    ``train_step``) records the allocator's peak above what was allocated
    when it started ("added", the largest over the calls) and the peak
    before it ("before": the allocator's peak is reset at each call, so
    max(before, max_memory_allocated()) is the whole block's peak)."""
    real, rec = TR.apply_optimizer, {"added": 0, "before": 0, "calls": 0}

    def measured(*args, **kwargs):
        rec["before"] = max(rec["before"], torch.cuda.max_memory_allocated())
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real(*args, **kwargs)
        rec["added"] = max(rec["added"], torch.cuda.max_memory_allocated() - start)
        rec["calls"] += 1
        return out

    TR.apply_optimizer = measured
    try:
        yield rec
    finally:
        TR.apply_optimizer = real


def _largest_leaf(tree) -> int:
    return max(t.numel() * t.element_size() for _, t in TR.tree_leaves(tree))


def _storage(state) -> list:
    return [t.data_ptr() for _, t in TR.tree_leaves(
        {"params": state.params, "opt_state": state.opt_state})]


def phase_train(name):
    """VAR-d16 at full width (C=1024, 16 heads, V=4096, L=680), 256px,
    global batch 32, SyntheticImageNet, f32 tokenize, bf16 forward, f32
    master weights, AdamW: ``run_training`` for 3 iterations through the
    normal entry point (it evaluates and checkpoints where max_iters stops
    it), then ``train_step`` timed directly (one warm-up, 4 measured steps
    on one batch, host clock around synchronize), then a remat step, a
    prog_si = 8 step, a grad_accum = 2 step and a tokenize_bf16 step, and
    the checkpoint read back on the card. Returns row 1's launches per
    step."""
    tc = TrainConfig(depth=TRAIN_DEPTH, global_batch_size=TRAIN_B, epochs=1)
    dev = torch.device(DEV)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        state, hist = TL.run_training(tc, out_dir=out, max_iters=3,
                                      batch_override=TRAIN_B, device=DEV)
        wall = time.time() - t0
        losses = [h["loss"] for h in hist]
        log(f"[train d16] run_training (d16 256px bs {TRAIN_B}, synthetic "
            f"data, f32 tokenize, bf16 forward, AdamW) 3 iterations + eval "
            f"+ checkpoint in {wall:.1f} s; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}")
        if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[train d16] run_training losses {losses}")
        t0 = time.time()
        back, meta = CK.auto_resume(out, state)
        same = back is not None and meta["step"] == state.step == 3 and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                TR.tree_leaves({"p": back.params, "o": back.opt_state}),
                TR.tree_leaves({"p": state.params, "o": state.opt_state})))
        log(f"[train d16] checkpoint ckpt-00000003 read back on the card "
            f"(auto_resume, {time.time() - t0:.1f} s): bit-equal {same}")
        if not same:
            raise AssertionError("[train d16] the checkpoint round trip differs")
        del back
    ds = SyntheticImageNet(reso=256, length=TRAIN_B, seed=5)
    img_np, lab_np = batch_arrays(ds, list(range(TRAIN_B)))
    img, label = torch.from_numpy(img_np).to(dev), torch.from_numpy(lab_np).to(dev)
    vae = init_vqvae_params(VQVAEConfig(), seed=0, device=DEV)
    var_cfg, vae_cfg = VARConfig(depth=TRAIN_DEPTH), VQVAEConfig()
    gen = torch.Generator(device=dev).manual_seed(2)
    lr, wd = 1e-4, 0.05
    step = functools.partial(TR.train_step, var_cfg, vae_cfg, vae_params=vae,
                             img=img, label_B=label, lr=lr, wd=wd,
                             generator=gen, label_smooth=tc.label_smooth)
    largest = _largest_leaf(state.params)
    ptrs = _storage(state)
    with _optimizer_peak() as opt:
        state, m = step(state)  # warm-up
    torch.cuda.synchronize()
    kept = _storage(state) == ptrs
    log(f"[train d16] the optimizer (apply_optimizer, in place) of the "
        f"warm-up step: added peak {opt['added'] / 2 ** 20:.1f} MiB over the "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, limit "
        f"the largest leaf's {largest / 2 ** 20:.1f} MiB; every state leaf "
        f"in its own storage {kept} "
        f"{'ok' if opt['added'] <= largest and kept else 'FAIL'}")
    if not (opt["calls"] == 1 and opt["added"] <= largest and kept):
        raise AssertionError("[train d16] the optimizer's added peak passes "
                             "the largest leaf, or a leaf moved")
    ms, losses, gnorms = [], [], []
    for _ in range(4):
        _reset_counts()
        t0 = time.perf_counter()
        state, m = step(state)
        losses.append(float(m["loss"]))  # synchronises
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        launches = attention_kernel.launches
        if launches != TRAIN_DEPTH or _read_counts() != _want(attention=TRAIN_DEPTH):
            raise AssertionError(f"[train d16] launches per step {_read_counts()}")
    finite = all(math.isfinite(x) for x in gnorms) and _finite_tree(state.params)
    falls = losses[-1] < losses[0]
    timer = SpanTimer(DEV)  # one more step, its spans on the card's events
    t0 = time.perf_counter()
    state, m = step(state, timer=timer)
    float(m["loss"])
    torch.cuda.synchronize()
    span_ms = (time.perf_counter() - t0) * 1e3
    spans = timer.report()
    mem = memory_stats(DEV)
    log(f"[train d16] spans of one step ({span_ms:.1f} ms, events on the "
        f"card): {_spans_line(spans)} ms; sum "
        f"{sum(v['mean_ms'] for v in spans.values()):.1f} ms; allocator "
        f"{mem['bytes_in_use'] / 2 ** 30:.2f} GiB in use, peak "
        f"{mem['peak_bytes_in_use'] / 2 ** 30:.2f} of "
        f"{mem['bytes_limit'] / 2 ** 30:.2f} GiB")
    with tempfile.TemporaryDirectory() as d:  # one step under the profiler
        t0 = time.perf_counter()
        with trace(d) as prof:
            state, m = step(state)
            float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        with open(os.path.join(d, TRACE_FILE)) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if str(e.get("cat", "")).lower() == "kernel"]
    window = ((max(e["ts"] + e["dur"] for e in kernels)
               - min(e["ts"] for e in kernels)) / 1e3 if kernels else wall)
    log(f"[train d16] one step under utils.profiling.trace (torch.profiler, "
        f"a Chrome trace; {wall:.1f} ms profiled): {len(kernels)} kernel "
        f"events, {busy:.1f} ms of device time in a {window:.1f} ms window "
        f"from the first kernel to the last, busy share {busy / window:.3f}")
    t0 = time.perf_counter()
    for _ in range(3):
        ids = TR.tokenize(var_cfg, vae_cfg, vae, img)[1]
    torch.cuda.synchronize()
    tok_ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = max(opt["before"], torch.cuda.max_memory_allocated()) / 2 ** 30
    best = min(ms)
    log(f"[train d16] train_step, bs {TRAIN_B}: {', '.join(f'{x:.1f}' for x in ms)} "
        f"ms (best {best:.1f} ms, {TRAIN_B / best * 1e3:.2f} img/s); the f32 "
        f"tokenize alone {tok_ms:.1f} ms; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (falling {falls}); grad "
        f"norms {', '.join(f'{x:.3f}' for x in gnorms)} (finite {finite}); "
        f"peak memory {peak:.2f} GiB; {launches} attention launches per step "
        f"(want {TRAIN_DEPTH}) on {name}")
    if not (falls and finite):
        raise AssertionError("[train d16] the loss does not fall or a gradient "
                             "is not finite")
    runs = {}
    state, m = step(state, remat=True)  # the first remat step, untimed
    float(m["loss"])
    for tag, kw, want in (("remat", {"remat": True}, 2 * TRAIN_DEPTH),
                          ("prog_si 8", {"prog_si": 8, "prog_wp": 0.5},
                           TRAIN_DEPTH),
                          ("grad_accum 2", {"grad_accum": 2}, 2 * TRAIN_DEPTH),
                          ("tokenize_bf16", {"tokenize_bf16": True},
                           TRAIN_DEPTH)):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, **kw)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3
        n = attention_kernel.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ok = math.isfinite(loss) and math.isfinite(float(m["grad_norm"])) and n == want
        runs[tag] = n
        log(f"[train d16] {tag} step: loss {loss:.4f}, {t:.1f} ms, peak memory "
            f"{peak:.2f} GiB, {n} attention launches (want {want}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[train d16] the {tag} step")
    ids16 = TR.tokenize(var_cfg, vae_cfg, vae, img, tokenize_bf16=True)[1]
    log(f"[train d16] tokenize_bf16 ids equal to the f32 tokenize's on "
        f"{(ids16 == ids).float().mean().item():.6f} of {ids.numel()} tokens")
    del state, vae
    torch.cuda.empty_cache()
    return {"launches_per_step": launches, "remat_launches_per_step": runs["remat"],
            "optimizer_added_mib": opt["added"] / 2 ** 20,
            "step_ms": best, "img_per_s": TRAIN_B / best * 1e3,
            "tokenize_ms": tok_ms,
            "spans_ms": {k: v["mean_ms"] for k, v in spans.items()},
            "profiled": {"kernels": len(kernels), "device_ms": busy,
                         "window_ms": window, "wall_ms": wall}}


def phase_train_smoke():
    """``python -m sdvar_tpu_torch.train.train_loop --smoke`` on the card
    (its default device), and the time of the f32 hd=32 attention instance
    it runs."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "sdvar_tpu_torch.train.train_loop",
                          "--smoke"], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    line = next((x for x in out.stdout.splitlines() if x.startswith("[smoke]")), "")
    log(f"[train smoke] --smoke on the card: exit {out.returncode} in "
        f"{time.time() - t0:.1f} s: {line}")
    if out.returncode != 0 or "cuda" not in line:
        raise AssertionError(f"--smoke failed: {out.stderr[-2000:]}")
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, 14, 2, 32, device=dev, generator=g) for _ in range(3))
    bias = device_bias(dev, block_causal_prefix, SMALL_PNS, 14)
    f_ms = cuda_ms(lambda: attention_kernel(q, k, v, bias, 1.0), 50)
    f_dev = device_ms(lambda: attention_kernel(q, k, v, bias, 1.0), 50)
    log(f"[time] attention f32 hd=32 (the --smoke stack: B=2 L=14 H=2): "
        f"{f_ms:.4f} ms a launch at the host's pace, {f_dev:.4f} device-paced; "
        f"ptxas {_kernel_ptxas('attention', 'attention_f32_kernelILi32EfLb0E')}")
    return {"ms": f_ms, "device_ms": f_dev}


def phase_sampler_widths():
    """Repair (a), and the kernel past the decode's vocab. At V = 8196,
    16384 and 32768 (the kernel takes every multiple of 4; a row past 8192
    is read in device memory) ``sample_with_top_k_top_p`` launches the
    kernel once and sends no row to the plain sampler, its ids equal to
    ``sample_plain``'s (bit for bit at top_p = 0; with top_p on 0.999 of
    the rows, as the row-3 checks hold it: integer masses against f32
    sums). At V = 8194 (not a multiple of 4) the rows go to
    ``sample_plain`` on the card: bit-equal, no launch, the rows counted.
    Returns the kernel's and the plain version's times at the wide widths."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(8)
    M, out = B * 100, {}
    for V in (8194, 8196, 16384, 32768):
        logits = torch.randn(M, V, device=dev, generator=g) * 4
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=dev,
                              generator=g, dtype=torch.int32)
        taken = V % 4 == 0
        for top_p in (0.0, 0.96):
            _reset_counts()
            ids = sample_with_top_k_top_p(logits[None], seeds, 900, top_p,
                                          vocab=V)
            torch.cuda.synchronize()
            n, rows = sample_kernel.launches, sample_kernel.plain_rows
            agree = (ids.reshape(-1) == sample_plain(logits, seeds, 900, top_p)
                     ).float().mean().item()
            need = 0.999 if taken and top_p else 1.0
            want = (1, 0) if taken else (0, M)
            ok = agree >= need and (n, rows) == want
            log(f"[sampler widths] V={V} M={M} top_k=900 top_p={top_p}: ids "
                f"equal to sample_plain on {agree:.6f} of the rows (need "
                f"{need}), kernel launches {n}, rows routed to the plain "
                f"sampler {rows} (want {want[0]} and {want[1]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the sampler at V={V} top_p={top_p}")
        if taken and V > SMP.SMEM_V:
            k_ms = cuda_ms(lambda: sample_kernel(logits, seeds, 900, 0.96), 20)
            p_ms = cuda_ms(lambda: sample_plain(logits, seeds, 900, 0.96), 3,
                           warmup=1)
            n_topk = sample_plain(logits, seeds, 900, 0.0, return_mask=True)[1].sum()
            bound, by = sampler_bound(M, V, int(n_topk))
            out[V] = {"M": M, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                      "bound_by": by}
            log(f"[time] sampler M={M} V={V} top_k=900 top_p=0.96 (the row in "
                f"device memory): kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                f"bound_ms {bound:.4f} ({by})")
        del logits, seeds
    return out


MESH4_WORLD = 4
MESH4_VOCABS = {"heads": 64, "heads+vocab": 66}


def _mesh4_stack(vocab):
    vc = VARConfig(depth=6, num_classes=10, patch_nums=SMALL_PNS,
                   vocab_size=vocab, Cvae=8, head_dim=32)
    qc = VQVAEConfig(vocab_size=vocab, z_channels=8, ch=32, patch_nums=SMALL_PNS)
    p = init_var_params(vc, seed=0, device="cpu")
    p["blocks"]["ada_lin_b"].normal_(0, 0.3,
                                     generator=torch.Generator().manual_seed(6))
    q = init_vqvae_params(qc, seed=1, device="cpu", eini=1.0)["quant"]
    return vc, qc, _to(p, DEV), _to(q, DEV)


def mesh4_rank_main(out_dir: str) -> int:
    """One of four ranks on cuda:0 (gloo): the 6-head small stack at
    model=4 (the heads whole on every rank; once with the vocab 66 whole
    too) against the unsharded card decode on this rank."""
    DIST.initialize()
    torch.cuda.set_device(DIST.rank_device())
    rank = DIST.get_rank()
    mesh = create_mesh(MeshConfig(data=1, model=MESH4_WORLD))
    samp = SamplingConfig(cfg=1.5, top_k=1)
    rep = {}
    for tag, vocab in MESH4_VOCABS.items():
        vc, qc, p, q = _mesh4_stack(vocab)
        set_tp_mesh(None)
        _reset_counts()
        f_ref, ids_ref = decode_all_scales(vc, qc, p, q, [3, 7, 1, 8], 7, samp,
                                           torch.float32, return_ids=True,
                                           kv_mode="f32", device=DEV)
        want = _read_counts()
        set_tp_mesh(mesh)
        ps = shard_tree(p, var_param_specs(vc, mesh), mesh)
        _reset_counts()
        f_hat, ids = decode_all_scales(vc, qc, ps, q, [3, 7, 1, 8], 7, samp,
                                       torch.float32, return_ids=True,
                                       kv_mode="f32", gather=True, device=DEV)
        got = _read_counts()
        set_tp_mesh(None)
        rel = ((f_hat - f_ref).abs().max() / f_ref.abs().max()).item()
        rep[tag] = {"ids_equal": torch.equal(ids, ids_ref), "fhat_rel": rel,
                    "launches": got, "unsharded_launches": want,
                    "qkv_cols": ps["blocks"]["qkv_w"].shape[-1]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    DIST.shutdown()
    return 0


def phase_mesh_replicated():
    """Repair (b): four ranks sharing cuda:0 through gloo decode the
    6-head small stack at model=4 (heads whole on every rank, the other
    widths split; then the vocab 66 whole too): ids equal to the unsharded
    card decode, f_hat within 1e-5 of its size, each rank's kernel
    launches those of the unsharded decode."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        launch([sys.executable, os.path.abspath(__file__), "--mesh4-rank", out],
               MESH4_WORLD, 300.0)
        wall = time.time() - t0
        reps = []
        for r in range(MESH4_WORLD):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    for tag in MESH4_VOCABS:
        rows = [rep[tag] for rep in reps]
        ok = all(r["ids_equal"] and r["fhat_rel"] <= 1e-5
                 and r["launches"] == r["unsharded_launches"] for r in rows)
        log(f"[mesh 1x4 {tag} whole] 4 ranks on cuda:0 (gloo, {wall:.1f} s): "
            f"ids equal to the unsharded card decode "
            f"{[r['ids_equal'] for r in rows]}, f_hat max|d| / max|ref| "
            f"{max(r['fhat_rel'] for r in rows):.2e} (limit 1e-5), qkv columns "
            f"a rank {rows[0]['qkv_cols']} (whole), launches a rank "
            f"{ {k: v for k, v in rows[0]['launches'].items() if v} } "
            f"(the unsharded decode's) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[mesh 1x4 {tag}] {rows}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):  # tuples: the INT8 weight leaves
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, dev, copy=False):
    if isinstance(tree, dict):
        return {k: _to(v, dev, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev, copy) for v in tree]
    if isinstance(tree, tuple):  # an INT8 weight leaf keeps its class
        return type(tree)(*(_to(v, dev, copy) for v in tree))
    return tree.to(dev, copy=copy)


# ---------------------------------------------------------------------------
# the twelfth slice: training on a mesh, the VQVAE trainer, the spans, the
# native loader
# ---------------------------------------------------------------------------

TRAIN_MESHES = {"2x1": MeshConfig(data=2, model=1),
                "1x2": MeshConfig(data=1, model=2)}
TRAIN_MESH_TIMEOUT = 900.0
# d8, not d16, to keep the whole run inside half its time limit (gloo
# through host memory makes a mesh step cost seconds, in proportion to
# depth)
TRAIN_MESH_DEPTH = 8
TRAIN_SEED = 2  # the generator of the one batch's training draws
TRAIN_LR, TRAIN_WD = 1e-4, 0.05
# The mesh's gates against one card, relative: step 1's loss and grad
# norm, and step 3's loss (after two AdamW updates). Step 1's read 0 and
# 1.96e-07 on an H100 (NVIDIA H100 80GB HBM3, 700 W); 1e-4 leaves room for
# the bf16 partial products the ranks sum in another order. A replicated
# leaf's gradient counted twice moves the grad norm; a gradient of the
# wrong direction moves step 3's loss.
TRAIN_MESH_RTOL = 1e-4


def _train_batch():
    """The one batch of the timed steps (``phase_train``'s): 32 synthetic
    256px images."""
    ds = SyntheticImageNet(reso=256, length=TRAIN_B, seed=5)
    img_np, lab_np = batch_arrays(ds, list(range(TRAIN_B)))
    dev = torch.device(DEV)
    return torch.from_numpy(img_np).to(dev), torch.from_numpy(lab_np).to(dev)


def _fresh_mesh_state(mesh=None):
    """The VAR-d8 train state ``run_training`` starts from (seed 0), whole or
    this rank's shard of it."""
    tc = TrainConfig(depth=TRAIN_MESH_DEPTH, global_batch_size=TRAIN_B, epochs=1)
    vae_cfg, var_cfg, vae, state = TL.build_everything(tc, seed=0, device=DEV,
                                                       mesh=mesh)
    return tc, vae_cfg, var_cfg, vae, state


def _digests(tree) -> dict:
    """sha256 of each leaf's bytes, by path."""
    import hashlib

    return {path: hashlib.sha256(t.detach().contiguous().cpu().numpy()
                                 .tobytes()).hexdigest()
            for path, t in TR.tree_leaves(tree)}


def _free_card(tag: str) -> None:
    """Drop this process's cached blocks (after a collection: a reference
    cycle can hold a tensor) and log the card's free memory and this
    process's share."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[memory] {tag}: the card {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} "
        f"GiB free; this process {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved")


def _spans_line(rep) -> str:
    return ", ".join(f"{k} {v['mean_ms']:.1f}" for k, v in rep.items())


def _train_mesh_run(tag, mcfg, out_dir, ref):
    """One rank of one mesh: ``run_training`` for 3 iterations (eval and
    the checkpoint where max_iters stops it), the gathered parameters'
    digests; then the one batch from the fresh state: 3 steps with the
    reference's draws, the first held against the single-card step, the
    last 2 timed with their spans; the launches of every step; the
    digests of the leaves this rank holds whole."""
    rank = DIST.get_rank()
    tc = TrainConfig(depth=TRAIN_MESH_DEPTH, global_batch_size=TRAIN_B, epochs=1)
    _free_card(f"train mesh {tag} rank {rank}, before")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, hist = TL.run_training(tc, out_dir=os.path.join(out_dir, tag),
                                  max_iters=3, batch_override=TRAIN_B,
                                  mesh_cfg=mcfg, device=DEV)
    wall = time.time() - t0
    var_cfg = VARConfig(depth=TRAIN_MESH_DEPTH)
    mesh = create_mesh(mcfg)
    whole = unshard_tree(state.params, var_param_specs(var_cfg, mesh), mesh)
    ckpt_digests = _digests(whole) if rank == 0 else {}
    del whole, state
    run_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _free_card(f"train mesh {tag} rank {rank}, after run_training (its peak "
               f"{run_peak:.2f} GiB)")
    set_tp_mesh(mesh)
    try:
        tc, vae_cfg, var_cfg, vae, state = _fresh_mesh_state(mesh)
        img, label = _train_batch()
        rows = mesh.rows(TRAIN_B)
        gen = torch.Generator(device=torch.device(DEV)).manual_seed(TRAIN_SEED)
        timer = SpanTimer(DEV)
        losses, gnorms, ms, counts = [], [], [], []
        for i in range(3):
            _reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = TR.train_step(var_cfg, vae_cfg, state, vae, img[rows],
                                     label[rows], TRAIN_LR, TRAIN_WD, gen,
                                     label_smooth=tc.label_smooth,
                                     timer=timer if i else None)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            gnorms.append(float(m["grad_norm"]))
            counts.append(_read_counts())
        specs = var_param_specs(var_cfg, mesh)
        replicated = _digests({
            path: t for path, t in TR.tree_leaves(state.params)
            if not TR.split_axes(_spec_at(specs, path), mesh)})
        spans = timer.report()
    finally:
        set_tp_mesh(None)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    best = min(ms[1:])
    d_loss = abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])
    d_norm = abs(gnorms[0] - ref["grad_norms"][0]) / abs(ref["grad_norms"][0])
    d_last = abs(losses[-1] - ref["losses"][-1]) / abs(ref["losses"][-1])
    launches_ok = all(c == _want(attention=TRAIN_MESH_DEPTH) for c in counts)
    falls = losses[-1] < losses[0]
    ok = (max(d_loss, d_norm, d_last) <= TRAIN_MESH_RTOL and launches_ok
          and falls and all(math.isfinite(x) for x in losses + gnorms))
    run_losses = [h["loss"] for h in hist]
    log(f"[train mesh {tag}] rank {rank}: run_training 3 iterations + eval + "
        f"checkpoint in {wall:.1f} s, losses "
        f"{', '.join(f'{x:.4f}' for x in run_losses)}; the one batch, "
        f"{TRAIN_B // mcfg.data} rows a rank: step 1 loss {losses[0]:.5f} "
        f"(one card {ref['losses'][0]:.5f}, rel. d {d_loss:.2e}), grad norm "
        f"{gnorms[0]:.6f} (one card {ref['grad_norms'][0]:.6f}, rel. d "
        f"{d_norm:.2e}), step 3 loss {losses[-1]:.6f} (one card "
        f"{ref['losses'][-1]:.6f}, rel. d {d_last:.2e}), limit "
        f"{TRAIN_MESH_RTOL:g} each; grad norms of steps 2-3 "
        f"{', '.join(f'{x:.6f}' for x in gnorms[1:])} (one card "
        f"{', '.join(f'{x:.6f}' for x in ref['grad_norms'][1:])}, printed); "
        f"losses {', '.join(f'{x:.4f}' for x in losses)} (falling {falls}); steps "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms (best of the last 2 "
        f"{best:.1f} ms, {TRAIN_B / best * 1e3:.2f} img/s); peak memory "
        f"{peak:.2f} GiB; attention launches a step "
        f"{[c['attention'] for c in counts]} (want {TRAIN_MESH_DEPTH}, no other "
        f"kernel) {'ok' if ok else 'FAIL'}")
    log(f"[train mesh {tag}] rank {rank}: spans, mean ms a step: "
        f"{_spans_line(spans)}")
    del state, vae, img
    _free_card(f"train mesh {tag} rank {rank}, after")
    return {"ok": ok, "run_losses": run_losses, "run_s": wall,
            "step1_loss": losses[0], "step1_grad_norm": gnorms[0],
            "rel_d": {"step1_loss": d_loss, "step1_grad_norm": d_norm,
                      "step3_loss": d_last},
            "losses": losses, "grad_norms": gnorms, "ms": ms, "best_ms": best,
            "img_per_s": TRAIN_B / best * 1e3, "peak_gib": peak,
            "launches_per_step": [c["attention"] for c in counts],
            "spans_ms": {k: v["mean_ms"] for k, v in spans.items()},
            "replicated_digests": replicated, "ckpt_digests": ckpt_digests}


def _spec_at(specs, path: str):
    """The spec of the leaf at a ``tree_leaves`` path."""
    for k in path.split("/"):
        specs = specs[k]
    return specs


def _train_mesh_small():
    """The small f32 stack (``_train_small``) on each mesh against the
    single-device ``train_step`` on this card with the same weights (the
    rank's own reference), ``tests/test_torch_train_mesh.py``'s bar: loss
    and grad norm within rtol/atol 1e-4, Adam's gathered mu and nu after
    the step (0.1 g and 0.05 g^2 of the clipped gradient) within 1e-4 of
    each leaf's size, the gathered parameters within 2e-4. One AdamW step
    at lr 1e-4 moves a parameter by at most about 1e-4, so the moments
    are what hold the backward and the data mean."""
    vc, qc, p, q, img, label = _train_small()
    vae, img, label = _to(q, DEV), img.to(DEV), label.to(DEV)

    def step(state, rows):
        return TR.train_step(vc, qc, state, vae, img[rows], label[rows], 1e-4,
                             0.05, None, label_smooth=0.1, dtype=torch.float32)

    ref, m = step(TR.init_train_state(_to(p, DEV)), slice(None))
    ref_loss, ref_norm = float(m["loss"]), float(m["grad_norm"])
    out = {}
    for tag, mcfg in TRAIN_MESHES.items():
        mesh = create_mesh(mcfg)
        set_tp_mesh(mesh)
        try:
            st = TR.shard_train_state(TR.init_train_state(_to(p, DEV)), vc, mesh)
            st, m = step(st, mesh.rows(img.shape[0]))
            specs = var_param_specs(vc, mesh)
            whole = {k: unshard_tree(t, specs, mesh) for k, t in (
                ("params", st.params), ("mu", st.opt_state["mu"]),
                ("nu", st.opt_state["nu"]))}
        finally:
            set_tp_mesh(None)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        err = max(((a - b).abs() - 2e-4 * b.abs()).max().item()
                  for (_, a), (_, b) in zip(TR.tree_leaves(whole["params"]),
                                            TR.tree_leaves(ref.params)))
        moments = {k: float(np.max([_grad_err(a, b) for (_, a), (_, b) in zip(
            TR.tree_leaves(whole[k]), TR.tree_leaves(ref.opt_state[k]))]))
            for k in ("mu", "nu")}  # np.max: a NaN leaf fails the gate
        ok = (abs(loss - ref_loss) <= 1e-4 + 1e-4 * abs(ref_loss)
              and abs(norm - ref_norm) <= 1e-4 + 1e-4 * abs(ref_norm)
              and err <= 2e-4 and max(moments.values()) <= 1e-4)
        out[tag] = {"ok": ok, "loss": loss, "ref_loss": ref_loss,
                    "grad_norm": norm, "ref_grad_norm": ref_norm,
                    "param_excess": err, "mu_err": moments["mu"],
                    "nu_err": moments["nu"]}
        log(f"[train mesh small {tag}] rank {DIST.get_rank()}: f32 train_step "
            f"on the mesh, loss {loss:.6f} against {ref_loss:.6f} on one card, "
            f"grad norm {norm:.6f} against {ref_norm:.6f} (rtol/atol 1e-4); "
            f"mu and nu max|d| / max|ref| a leaf {moments['mu']:.2e}, "
            f"{moments['nu']:.2e} (limit 1e-4); parameters: max(|d| - 2e-4 "
            f"|ref|) {err:.2e} (limit 2e-4) {'ok' if ok else 'FAIL'}")
    return out


def train_mesh_rank_main(out_dir: str) -> int:
    """One of two ranks on cuda:0 (gloo) of ``phase_train_mesh``."""
    DIST.initialize()
    torch.cuda.set_device(DIST.rank_device())
    rank = DIST.get_rank()
    with open(os.path.join(out_dir, "ref.json")) as f:
        ref = json.load(f)
    rep = {"rank": rank}
    for tag, mcfg in TRAIN_MESHES.items():
        rep[tag] = _train_mesh_run(tag, mcfg, out_dir, ref)
    rep["small"] = _train_mesh_small()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    DIST.shutdown()
    return 0 if all(rep[t]["ok"] for t in TRAIN_MESHES) and all(
        v["ok"] for v in rep["small"].values()) else 1


def phase_train_mesh(name):
    """VAR-d8 (C=512; cut from d16 for the time budget), 256px,
    global batch 32, bf16 forward, f32 tokenize, AdamW, on a 2x1 (data)
    and a 1x2 (model: heads, FFN hidden,
    6C and vocab split) mesh of two ranks that share the card through gloo
    (``parallel.launch``; NCCL refuses two ranks on one card). Here,
    before: the single-card steps 1-3 of the fresh state on the one batch
    and its draws. The ranks: ``run_training(mesh_cfg=...)`` for 3
    iterations, then the one batch (``_train_mesh_run``) and the small
    f32 stack. After: the gates, and each mesh's checkpoint loaded on one
    card, bit-equal to the gathered parameters. Returns the ranks'
    reports."""
    tc, vae_cfg, var_cfg, vae, state = _fresh_mesh_state()
    img, label = _train_batch()
    gen = torch.Generator(device=torch.device(DEV)).manual_seed(TRAIN_SEED)
    ref = {"losses": [], "grad_norms": []}
    for _ in range(3):
        state, m = TR.train_step(var_cfg, vae_cfg, state, vae, img, label,
                                 TRAIN_LR, TRAIN_WD, gen,
                                 label_smooth=tc.label_smooth)
        ref["losses"].append(float(m["loss"]))
        ref["grad_norms"].append(float(m["grad_norm"]))
    del state, vae, img, m
    _free_card("train mesh parent, before the ranks")
    log(f"[train mesh] one card, the fresh d{TRAIN_MESH_DEPTH} state's 3 steps on the one "
        f"batch: losses {', '.join(f'{x:.6f}' for x in ref['losses'])}, grad "
        f"norms {', '.join(f'{x:.6f}' for x in ref['grad_norms'])}")
    with tempfile.TemporaryDirectory() as out:
        with open(os.path.join(out, "ref.json"), "w") as f:
            json.dump(ref, f)
        t0 = time.time()
        logs = launch([sys.executable, os.path.abspath(__file__),
                       "--train-mesh-rank", out], MESH_WORLD, TRAIN_MESH_TIMEOUT,
                      env=dict(os.environ,
                               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        wall = time.time() - t0
        for r in range(MESH_WORLD):
            for line in logs[r].splitlines():
                if line.startswith(("[train mesh", "[memory]")):
                    log(line)
        reps = []
        for r in range(MESH_WORLD):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reps.append(json.load(f))
        log(f"[train mesh] {MESH_WORLD} ranks on cuda:0 (gloo through host "
            f"memory; NCCL across cards has never run) in {wall:.1f} s, each "
            f"exited 0")
        template = _fresh_mesh_state()[4]
        for tag in TRAIN_MESHES:
            a, b = (rep[tag]["replicated_digests"] for rep in reps)
            same = a == b and len(a) > 0
            ranks_losses = [rep[tag]["losses"] for rep in reps]
            log(f"[train mesh {tag}] the {len(a)} leaves each rank holds whole "
                f"bit-equal across the ranks after 3 steps: {same}; both "
                f"ranks' losses equal: {ranks_losses[0] == ranks_losses[1]}")
            if not same or ranks_losses[0] != ranks_losses[1]:
                raise AssertionError(f"[train mesh {tag}] the ranks disagree")
            t0 = time.time()
            back, meta = CK.auto_resume(os.path.join(out, tag), template)
            ok = (back is not None and meta["step"] == 3
                  and _digests(back.params) == reps[0][tag]["ckpt_digests"])
            log(f"[train mesh {tag}] the checkpoint rank 0 wrote (the whole "
                f"tree) loaded on one card in {time.time() - t0:.1f} s: step "
                f"{meta['step']}, parameters bit-equal to the gathered ones "
                f"{ok}")
            if not ok:
                raise AssertionError(f"[train mesh {tag}] the checkpoint differs")
            del back
            shutil.rmtree(os.path.join(out, tag))
        del template
    torch.cuda.empty_cache()
    return reps


def phase_vae_train(name):
    """``vae_train_step`` (SGD, the EMA codebook hits) on the default VQVAE
    at 256px, B=8, f32, 3 steps on one batch: the loss falls and the usage
    is finite; then a small VQVAE, 3 steps on the card against the CPU:
    losses and every parameter within 1e-4 of their size."""
    _free_card("vae train, before")
    vae_cfg = VQVAEConfig()
    params = init_vqvae_params(vae_cfg, seed=3, device=DEV, eini=1.0)
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (8, 3, 256, 256)).astype(np.float32)).to(DEV)
    st = VT.init_vae_train_state(vae_cfg, params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        st, m = VT.vae_train_step(vae_cfg, st, img, 1e-3)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    usage = m["usage_per_scale"].cpu()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = losses[-1] < losses[0] and bool(torch.isfinite(usage).all())
    log(f"[vae train] default VQVAE 256px B=8 f32 vae_train_step x3: losses "
        f"{', '.join(f'{x:.5f}' for x in losses)} (falling "
        f"{losses[-1] < losses[0]}); {', '.join(f'{x:.1f}' for x in ms)} ms; "
        f"usage per scale {[round(float(x), 3) for x in usage]} %; peak "
        f"memory {peak:.2f} GiB on {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[vae train] the loss does not fall or the usage "
                             "is not finite")
    del st, params, img, m
    torch.cuda.empty_cache()
    small = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=SMALL_PNS)
    p = init_vqvae_params(small, seed=3, device="cpu", eini=1.0)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (2, 3, 48, 48)).astype(np.float32))
    res = {}
    for dev in ("cpu", DEV):  # copies: a step writes into its state
        s = VT.init_vae_train_state(small, _to(p, dev, copy=True))
        ls = []
        with full_f32():
            for _ in range(3):
                s, m = VT.vae_train_step(small, s, x.to(dev), 1e-3)
                ls.append(float(m["loss"]))
        res[dev] = (s, ls)
    (sc, lc), (sg, lg) = res["cpu"], res[DEV]
    worst = max(_grad_err(a.cpu(), b) for (_, a), (_, b) in zip(
        TR.tree_leaves(sg.params), TR.tree_leaves(sc.params)))
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    ok = worst <= 1e-4 and d_loss <= 1e-4
    log(f"[vae train] small VQVAE 3 steps, card against the CPU: losses max "
        f"rel. d {d_loss:.2e}, parameters max|d| / size {worst:.2e} (limit "
        f"1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[vae train] the card disagrees with the CPU")
    return {"ms": ms, "peak_gib": peak}


def phase_native_loader(name):
    """The native C++ loader (``train/native_loader.py``): built from
    ``csrc/dataloader.cpp`` with g++ into build/native/, or the reason it
    did not build. A temp folder of 32 images (PIL-written JPEGs, or PNGs
    from the library's own writer where PIL is absent); where the library
    built, one batch of it with its shapes and range checked; then one
    iteration of ``run_training(data_root=...)`` on the card, through the
    library, or through the Python path (PIL) where it did not build."""
    from sdvar_tpu_torch.train import native_loader as NL

    t0 = time.time()
    built = NL.native_available()
    log(f"[native loader] built: {built} ({time.time() - t0:.1f} s)"
        + ("" if built else f"; reason: {NL.build_error()}"))
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None and not built:
        log("[native loader] neither PIL nor the library here: no folder run")
        return {"built": False, "run_training": False}
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        for c in range(4):  # 32 images: an epoch of 4 batches of 8
            d = os.path.join(root, f"class{c}")
            os.makedirs(d)
            arrs = rng.integers(0, 255, (8, 300, 340, 3), dtype=np.uint8)
            if Image is not None:
                for i, a in enumerate(arrs):
                    Image.fromarray(a).save(os.path.join(d, f"{i}.jpg"))
            else:
                NL.write_pngs_native(d, arrs)
        if built:
            paths = sorted(os.path.join(r, f) for r, _, fs in os.walk(root)
                           for f in fs)
            loader = NL.NativeImageLoader(paths, [0] * len(paths), reso=256,
                                          train=True, seed=0, num_threads=4)
            imgs, _ = loader.batch(list(range(len(paths))))
            loader.close()
            ok = (imgs.shape == (len(paths), 3, 256, 256)
                  and float(imgs.min()) >= -1.0 and float(imgs.max()) <= 1.0)
            log(f"[native loader] {len(paths)} "
                f"{'JPEGs (PIL)' if Image else 'PNGs (the library writer)'}: "
                f"batch {imgs.shape} in [{imgs.min():.3f}, {imgs.max():.3f}] "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("[native loader] batch shape or range")
        if Image is None:
            log("[native loader] run_training(data_root=...) skipped: its "
                "held-out split reads the folder through PIL, absent here")
            return {"built": built, "run_training": False}
        tc = TrainConfig(depth=TRAIN_DEPTH, global_batch_size=8, epochs=1)
        t0 = time.time()
        _, hist = TL.run_training(tc, data_root=root,
                                  out_dir=os.path.join(tmp, "out"),
                                  max_iters=1, batch_override=8, device=DEV)
    ok = len(hist) == 1 and math.isfinite(hist[0]["loss"])
    log(f"[native loader] run_training(data_root=...) d16 bs 8, 1 iteration "
        f"through {'the native loader' if built else 'the Python path'} on "
        f"the card in {time.time() - t0:.1f} s: loss {hist[0]['loss']:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[native loader] run_training")
    torch.cuda.empty_cache()
    return {"built": built, "run_training": True}


# ---------------------------------------------------------------------------
# the thirteenth slice: high-resolution generation (VAR-d36 512px with
# shared AdaLN, the 1024px preset at the d16 width) through bench_512's and
# bench_1024's run(), the presets' small stacks against the CPU, the
# stacked cache past 2^31 elements, kernel rows 1-6 at the new shapes
# ---------------------------------------------------------------------------

D36_512 = VARConfig(depth=36, patch_nums=PATCH_NUMS_512, shared_aln=True)
D16_1024 = VARConfig(depth=16, patch_nums=PATCH_NUMS_1024)
HIGHRES_MODES = ("bf16", "w8a8-int8kv")


def highres_per_decode(cfg: VARConfig) -> dict:
    """Kernel launches per decode of each mode, from depth x scales: one
    attention a layer and scale; with W8A8 weights four act-quants a layer
    and scale (the qkv, proj and fc1 inputs, the fused fc2 input) and the
    int8 head once a scale; one sampler a scale."""
    n, S = cfg.depth * cfg.num_scales, cfg.num_scales
    w8a8 = dict(act_quantize=4 * n, int8_matmul=S, sampler=S)
    return {"bf16": dict(attention=n, sampler=S),
            "w8a8": dict(attention=n, **w8a8),
            "w8a8-int8kv": dict(attention_int8=n, **w8a8)}


def _highres_phase(tag, cfg, run, batch, hw):
    """One configuration through its tool's ``run()`` (counts set to 0
    just before, read just after): the launch counts against depth x
    scales times the decodes each mode ran (a decode that replays its
    block stack's graphs counts only its head and sampler), plus one
    conv3x3_s8 a quantized site and all-int8 pixel-decoder call; seed 2 twice the same
    ids and seed 3 others; every image finite, in [0, 1], (batch, 3, hw,
    hw); the ``generate_images`` image, where the tool made one, within
    1e-6 of the golden decoder's on the same seed's latent."""
    _reset_counts()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    per = highres_per_decode(cfg)
    want = {}
    for mode in HIGHRES_MODES:
        replays = out[mode]["replays"]
        for k, n in per[mode].items():
            eager = k in ("int8_matmul", "sampler")  # outside the graphs
            want[k] = (want.get(k, 0) + n * (out[mode]["decodes"] - replays)
                       + (n * replays if eager else 0))
        int8 = out[mode]["pixels"].get("nhwc-int8")
        if int8 is not None:
            want["conv3x3_s8"] = (want.get("conv3x3_s8", 0)
                                  + int8["sites_quantized"] * int8["calls"])
    want = _want(**want)
    decodes = {m: out[m]["decodes"] for m in HIGHRES_MODES}
    log(f"[{tag}] kernel launches over {decodes} decodes and the pixel "
        f"decodes: {counts} (want {want}); per decode {per}")
    if counts != want:
        raise AssertionError(f"[{tag}] launch counts {counts} != {want}")
    rows = {}
    for mode in HIGHRES_MODES:
        row = out[mode]
        if not row["same_seed_ids_equal"] or not row["other_seed_ids_differ"]:
            raise AssertionError(f"[{tag}] {mode}: the same seed must give "
                                 f"the same ids, another seed other ids")
        for pname, pix in row["pixels"].items():
            img = pix["image"]
            ok = (tuple(img.shape) == (batch, 3, hw, hw)
                  and bool(torch.isfinite(img).all())
                  and img.min().item() >= 0 and img.max().item() <= 1)
            if not ok:
                raise AssertionError(f"[{tag}] {mode} {pname}: bad images "
                                     f"{tuple(img.shape)}")
        entry = ""
        if row["image"] is not None:
            d = (row["image"] - row["pixels"]["f32"]["image"]).abs().max().item()
            entry = (f"; generate_images(seed 2) against the golden decode of "
                     f"the seed-2 latent: max|d| {d:.2e} (bit-equal "
                     f"{row['entry_equals_f32']})")
            if d > 1e-6:
                raise AssertionError(f"[{tag}] {mode}: generate_images differs "
                                     f"from the same seed's decode")
        rows[mode] = {
            "decodes": row["decodes"], "ms": row["ms"],
            "img_per_s": row["img_per_s"], "times_ms": row["times_ms"],
            "first_s": row["first_s"], "peak_gib": row["peak_gib"],
            "launches_per_decode": per[mode],
            "other_seed_ids_differ": row["other_seed_ids_differ"],
            "pixels": {k: {kk: v for kk, v in p.items() if kk != "image"}
                       for k, p in row["pixels"].items()}}
        log(f"[{tag}] {mode}: seed 2 twice identical ids, seed 3 "
            f"{row['other_seed_ids_differ']:.3f} of ids differ; images finite, "
            f"in [0, 1], ({batch}, 3, {hw}, {hw}){entry}")
    del out
    torch.cuda.empty_cache()
    return {"modes": rows, "launches": counts, "wall_s": wall}


def phase_d36_512(name):
    """Path A: VAR-d36 512px with shared AdaLN at B=4, bf16 and W8A8 +
    INT8 KV, through ``bench_512.run`` (``generate_images``, the latent
    decodes, the golden, channels-last bf16 and calibrated all-int8 pixel
    decoders at 512px)."""
    log(f"[d36-512] {name}: bench_512.run(4, {HIGHRES_MODES}, repeats=1)")
    return _highres_phase("d36-512", D36_512, lambda: bench_512.run(
        4, HIGHRES_MODES, repeats=1, device=DEV), 4, 512)


def phase_d16_1024(name):
    """Path B: the 1024px preset at the d16 width, B=2, bf16 and W8A8 +
    INT8 KV, through ``bench_1024.run`` (the latent decodes, the
    channels-last bf16 pixel decoder at 1024px)."""
    log(f"[d16-1024] {name}: bench_1024.run(16, 2, {HIGHRES_MODES}, repeats=1)")
    return _highres_phase("d16-1024", D16_1024, lambda: bench_1024.run(
        16, 2, HIGHRES_MODES, repeats=1, device=DEV), 2, 1024)


def phase_cache_past_2_31(name):
    """The stacked bf16 cache past 2^31 elements: VAR-d36 512px at B=8 (16
    CFG rows; K and V each 36 x 16 x 2240 x 2304 elements), one decode with
    the cache-kernel switch off, then the cache filled with NaN and the
    same decode with it on: bit-equal f_hat and ids, 360 fused writes
    (rows 7 and 8 write the layers past the 2^31-th element) and no
    attention_kernel launch, counted at the switched-on decode's capture
    (the cache is reused, so the decodes replay CUDA graphs)."""
    vae_cfg = VQVAEConfig(patch_nums=PATCH_NUMS_512)
    params = init_var_params(D36_512, seed=0, device=DEV, dtype=torch.bfloat16)
    quant = init_vqvae_params(vae_cfg, seed=1, device=DEV)["quant"]
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    labels = torch.arange(8) * 61 % 1000
    cache = KVCache.create(D36_512, 16, device=DEV)
    n = cache.k.numel()
    if n <= 2 ** 31:
        raise AssertionError(f"[cache 2^31] the cache holds only {n} elements")

    def decode():
        torch.cuda.synchronize()
        t0 = time.time()
        f_hat, ids = decode_all_scales(D36_512, vae_cfg, params, quant, labels,
                                       9, samp, return_ids=True, cache=cache,
                                       device=DEV)
        torch.cuda.synchronize()
        return f_hat, ids, (time.time() - t0) * 1e3

    decode()  # the unfused path's first call at these shapes
    f_off, ids_off, off_ms = decode()
    cache.k.fill_(float("nan"))
    cache.v.fill_(float("nan"))
    set_cache_kernel(True)
    try:
        _reset_counts()
        decode()  # captures the switched-on graphs: the counters tick here
        counts = _read_counts()
        cache.k.fill_(float("nan"))
        cache.v.fill_(float("nan"))
        f_on, ids_on, on_ms = decode()
    finally:
        set_cache_kernel(False)
    S, n_att = D36_512.num_scales, D36_512.depth * D36_512.num_scales
    want = _want(cache_write=n_att, sampler=S)
    same = torch.equal(f_off, f_on) and torch.equal(ids_off, ids_on)
    log(f"[cache 2^31] {name}: VAR-d36 512px B=8, K and V {n} elements each "
        f"({2 * n * 2 / 2 ** 30:.2f} GiB): switch off {off_ms:.1f} ms, on "
        f"{on_ms:.1f} ms (the cache NaN-filled before it); f_hat and ids "
        f"bit-equal {same}; launches {counts}")
    if counts != want:
        raise AssertionError(f"[cache 2^31] launch counts {counts} != {want}")
    if not same:
        raise AssertionError("[cache 2^31] the fused cache write differs from "
                             "the unfused path past 2^31 elements")
    del params, cache
    torch.cuda.empty_cache()
    return {"elements": n, "cache_write": counts["cache_write"],
            "off_ms": off_ms, "on_ms": on_ms}


HIGHRES_SMALL = {"512 shared AdaLN": (PATCH_NUMS_512, True),
                 "1024": (PATCH_NUMS_1024, False)}


@contextlib.contextmanager
def _plain_on_card():
    """The quantized forward's kernels swapped for their plain versions on
    CUDA tensors, for a witness only (never on a gated path): attention
    (float and INT8 K/V) through ``set_attention_impl("plain")``, the
    act-quant and the int8 head through their plain functions."""
    saved = (QOPS.act_quantize, MM.int8_matmul)
    QOPS.act_quantize, MM.int8_matmul = act_quantize_plain, int8_matmul_plain
    set_attention_impl("plain")
    try:
        yield
    finally:
        QOPS.act_quantize, MM.int8_matmul = saved
        set_attention_impl("auto")


def _logit_gaps(want, got):
    """(share of the tokens whose logits differ by more than 1e-5 of the
    reference's size, the largest such difference over that size)."""
    tok = (want - got).abs().amax(-1) / want.abs().max()
    return (tok > 1e-5).float().mean().item(), tok.max().item()


def phase_highres_small_reference():
    """Each preset's small stack on the card against the CPU plain path,
    greedy. f32: ids equal, f_hat within 1e-5 of its size. W8A8 + INT8 KV
    (f32 activations): one cached forward over every scale and a greedy
    decode. At these lengths (2240 and 9451 tokens) the quantized forward
    has activations and cached keys whose f32 value lies within the two
    paths' last-bit differences of an int8 rounding step; each such step
    moves the logits of its token, and through the cache those of every
    later token, by up to about 1e-3 of their size (measured at 512: 6.7%
    of the tokens past 1e-5, the largest 1.55e-3; at 1024: 4.2%, 6.6e-4;
    the small stack of ``phase_small_reference_quant``, 14 tokens, has no
    such step). A wrong scale or index moves them by their own size. So:
    the logits within 5e-3 of their size at every token, the share past
    1e-5 printed. The witness of that cause: the same forward on the card
    with every kernel swapped for its plain version (``_plain_on_card``,
    no launch counted) against the CPU and against the kernels, each
    share and largest printed (measured at 512: plain on the card vs the
    CPU 6.6% and 1.55e-3, as the kernels; kernels vs plain on the card
    0.8% and 1.1e-3); a kernel fault would show as kernels vs plain on
    the card far beyond plain on the card vs the CPU. A greedy
    decode parts from the CPU's at the first argmax whose top two lie
    closer than that, and its later scales differ from there (measured at
    1024: 99.3% of the ids equal); a broken decode loop agrees on about
    1/64 of them. So: the ids equal on the first five scales and at 95% of
    the tokens, the first scale that differs printed."""
    samp = SamplingConfig(cfg=1.5, top_k=1)
    for tag, (pns, shared) in HIGHRES_SMALL.items():
        vc, qc, p0, q0 = _small_stack(pns=pns, shared=shared)
        out = {}
        for dev in ("cpu", DEV):
            p, q = _to(p0, dev), _to(q0, dev)
            f_hat, ids = decode_all_scales(vc, qc, p, q["quant"], [3, 7], 0,
                                           samp, torch.float32,
                                           return_ids=True, device=dev)
            out[dev] = (f_hat.cpu(), ids.cpu())
        same = torch.equal(out["cpu"][1], out[DEV][1])
        rel = ((out["cpu"][0] - out[DEV][0]).abs().max()
               / out["cpu"][0].abs().max()).item()
        log(f"[reference {tag}] small stack ({vc.num_scales} scales, L="
            f"{vc.L}) f32 greedy, card vs CPU plain path: ids equal {same}, "
            f"f_hat max|d| / max|ref| {rel:.2e} (limit 1e-5)")
        if not same or rel > 1e-5:
            raise AssertionError(f"[reference {tag}] the card disagrees with "
                                 f"the CPU reference")

        vc, qc, p, q = _small_stack("w8a8", pns, shared)
        xs, cond = _small_inputs(vc)
        out = {}
        for dev in ("cpu", DEV):
            pd, qd = _to(p, dev), _to(q, dev)
            logits, _ = _small_forward(vc, pd, dev, xs, cond)
            ids = decode_all_scales(vc, qc, pd, qd["quant"], [3, 7], 0, samp,
                                    torch.float32, return_ids=True,
                                    kv_mode="int8", device=dev)[1]
            out[dev] = (logits.view(-1, vc.vocab_size), ids.cpu())
        before = _read_counts()
        with _plain_on_card():
            lp = _small_forward(vc, _to(p, DEV), DEV, xs, cond)[0]
        if _read_counts() != before:
            raise AssertionError("the plain witness launched a kernel")
        lc, lg = out["cpu"][0], out[DEV][0]
        lp = lp.view(-1, vc.vocab_size)
        far, rel = _logit_gaps(lc, lg)
        wit = {"plain on the card vs CPU": _logit_gaps(lc, lp),
               "kernels vs plain on the card": _logit_gaps(lp, lg)}
        ic, ig = out["cpu"][1], out[DEV][1]
        head = vc.begin_ends[4][1]
        head_same = torch.equal(ic[:, :head], ig[:, :head])
        frac = (ic == ig).float().mean().item()
        parted = [si for si, (bg, ed) in enumerate(vc.begin_ends)
                  if not torch.equal(ic[:, bg:ed], ig[:, bg:ed])]
        log(f"[reference {tag}] quantized small stack (w8a8, int8 KV, f32), "
            f"card vs CPU plain path: tokens whose logits differ by more than "
            f"1e-5 of their size {far:.2e}, largest {rel:.2e} (limit 5e-3); "
            + "; ".join(f"{k} {f:.2e}, largest {r:.2e}"
                        for k, (f, r) in wit.items())
            + f"; greedy ids equal on the first five scales {head_same}, at "
            f"{frac:.5f} of the tokens (need 0.95), first scale that differs "
            f"{parted[0] if parted else None}")
        if rel > 5e-3 or not head_same or frac < 0.95:
            raise AssertionError(f"[reference {tag}] the quantized card path "
                                 f"disagrees with the CPU reference")


def _att_bytes(Bq, Lq, Lk, H, kv_dtype):
    """(bound bytes, K/V bytes one launch stages) of rows 1 and 2."""
    plan = attention_plan(Bq, Lq, Lk, H, 64, torch.bfloat16, kv_dtype)
    if kv_dtype == torch.int8:
        nbytes = 2 * H * 64 * Bq * 2 * Lq + H * 64 * Bq * 2 * Lk + 2 * Bq * Lk * 4
    else:
        nbytes = 2 * H * 64 * Bq * (2 * Lq + 2 * Lk)
    return nbytes, plan["kv_bytes_staged"]


# (tag, 2B, Lq, Lk, H): the last scale of each high-resolution decode
HIGHRES_ATT = (("512 scale 9", 8, 1024, 2240, 36),
               ("1024 scale 13", 4, 4096, 9451, 16))


def phase_highres_kernel_times(per_decode, conv_sites):
    """Rows 1-6 at the high-resolution decodes' largest shapes, each held
    against its plain version there (rows 2-6 with the tolerances of the
    256px checks; row 1, whose outputs have a spread of about
    1/sqrt(0.78 Lk) here, within one bf16 step at the largest output,
    2^-7 of it, both being bf16, and the plain version without the last
    ring tile of keys must fall outside that limit) and timed with CUDA events after warm-up, beside its bound and the
    library call; ``per_decode``: {config: highres_per_decode(cfg)},
    ``conv_sites``: the 512px all-int8 decoder's quantized sites. Returns
    {row name: {shape: figures}}."""
    g = torch.Generator(device=DEV).manual_seed(13)
    sdpa = F.scaled_dot_product_attention
    out = {k: {} for k in ("attention", "attention_int8", "sampler",
                           "act_quantize", "int8_matmul", "conv3x3_s8")}
    for tag, Bq, Lq, Lk, H in HIGHRES_ATT:
        cfg = "d36-512" if Lk == D36_512.L else "d16-1024"
        cache = torch.randn(2, Bq, Lk, H * 64, device=DEV, generator=g)
        q = (F.normalize(torch.randn(Bq, Lq, H, 64, device=DEV, generator=g),
                         dim=-1) * 4).to(torch.bfloat16)
        k = cache[0].view(Bq, Lk, H, 64)
        k.copy_(F.normalize(k, dim=-1))
        cache = cache.to(torch.bfloat16)
        k, v = (cache[i].view(Bq, Lk, H, 64) for i in (0, 1))
        got = attention_kernel(q, k, v, None, 1.0).float()
        want = attention_plain(q, k, v, None, 1.0).float()
        err = (got - want).abs().max().item()
        lim = 2 ** -7 * want.abs().max().item()
        full = Lk - (Lk % KEY_TILE or KEY_TILE)
        drop = (attention_plain(q, k[:, :full], v[:, :full], None, 1.0)
                .float() - want).abs().max().item()
        ok = err <= lim
        del got, want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(lambda: attention_kernel(q, k, v, None, 1.0), 10)
        plain = cuda_ms(lambda: attention_plain(q, k, v, None, 1.0), 1, warmup=1)
        lib = cuda_ms(lambda: sdpa(qt, kt, vt, scale=1.0), 10)
        bound, by = attention_bound(Bq, Lq, Lk, H, 64, 2)
        nbytes, staged = _att_bytes(Bq, Lq, Lk, H, torch.bfloat16)
        out["attention"][tag] = {
            "launches_per_decode": per_decode[cfg]["bf16"]["attention"],
            "max_abs_err": err, "limit": lim, "last_tile_dropped": drop,
            "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
            "kv_bytes_staged": staged}
        log(f"[time highres] attention {tag} (2B={Bq} Lq={Lq} Lk={Lk} H={H} "
            f"hd=64 bf16): max|d| {err:.3e} (limit {lim:.3e}, one bf16 "
            f"step at the largest output; the plain version without the "
            f"last {Lk - full} keys, one ring tile, is {drop:.3e} off) "
            f"{'ok' if ok else 'FAIL'}; "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
            f"(scaled_dot_product_attention) bound_ms {bound:.4f} ({by}); K/V "
            f"bytes staged {staged} beside the bound's {nbytes} bytes in all; "
            f"grid {attention_plan(Bq, Lq, Lk, H, 64, torch.bfloat16, torch.bfloat16)['grid']}")
        if not ok:
            raise AssertionError(f"attention kernel disagrees at {tag}")
        if drop <= lim:
            raise AssertionError(f"the limit at {tag} cannot see a dropped "
                                 f"key tile")
        del cache, k, v, qt, kt, vt

        vals, scales = _int8_cache(Bq, Lk, H * 64, g)
        q8 = (torch.randn(Bq, Lq, H, 64, device=DEV, generator=g)
              * 1e-3).to(torch.bfloat16)
        k8, v8, sc8 = _int8_kv(vals, scales, Lk, H, 64)
        got = attention_kernel(q8, k8, v8, None, 1.0, kv_scales=sc8).float()
        want = attention_plain(q8, k8, v8, None, 1.0, kv_scales=sc8).float()
        err = (got - want).abs().max().item()
        lim = 2e-2 * want.abs().max().item()
        del got, want
        kd, vd = (dequantize_tokens(t.reshape(Bq, Lk, H * 64), s)
                  .view(Bq, Lk, H, 64).transpose(1, 2)
                  for t, s in ((k8, sc8[0]), (v8, sc8[1])))
        q8t = q8.transpose(1, 2)
        ms = cuda_ms(lambda: attention_kernel(q8, k8, v8, None, 1.0,
                                              kv_scales=sc8), 10)
        plain = cuda_ms(lambda: attention_plain(q8, k8, v8, None, 1.0,
                                                kv_scales=sc8), 1, warmup=1)
        lib = cuda_ms(lambda: sdpa(q8t, kd, vd, scale=1.0), 10)
        bound, by = attention_int8_bound(Bq, Lq, Lk, H, 64)
        nbytes, staged = _att_bytes(Bq, Lq, Lk, H, torch.int8)
        out["attention_int8"][tag] = {
            "launches_per_decode":
                per_decode[cfg]["w8a8-int8kv"]["attention_int8"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
            "kv_bytes_staged": staged}
        log(f"[time highres] attention_int8 {tag} (2B={Bq} Lq={Lq} Lk={Lk} "
            f"H={H} hd=64 q bf16, k/v int8): max|d| {err:.3e} (limit "
            f"{lim:.3e}) {'ok' if err <= lim else 'FAIL'}; kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} library_ms {lib:.4f} (SDPA on k/v "
            f"dequantised beforehand, untimed) bound_ms {bound:.4f} ({by}); "
            f"K/V bytes staged {staged} beside the bound's {nbytes}")
        if err > lim:
            raise AssertionError(f"INT8-KV attention disagrees at {tag}")
        del vals, scales, k8, v8, kd, vd
        torch.cuda.empty_cache()

    # row 3: the 1024 decode's last scale, B=2: 2 x 4096 rows
    M, V = 8192, 4096
    logits = torch.randn(M, V, device=DEV, generator=g) * 4
    noise = -torch.log(-torch.log(
        torch.rand(M, V, device=DEV, generator=g).clamp_(1e-7, 1 - 1e-7)))
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=DEV,
                          generator=g, dtype=torch.int32)
    ids, mask = sample_kernel(logits, None, 900, 0.96, noise=noise,
                              return_mask=True)
    ids_p, mask_p = sample_plain(logits, None, 900, 0.96, noise=noise,
                                 return_mask=True)
    rows_eq = ((mask == mask_p).all(-1) & (ids == ids_p)).float().mean().item()
    err = (mask.int() - mask_p.int()).abs().max().item()
    ms = cuda_ms(lambda: sample_kernel(logits, seeds, 900, 0.96), 20)
    plain = cuda_ms(lambda: sample_plain(logits, seeds, 900, 0.96), 2, warmup=1)
    n_topk = sample_plain(logits, seeds, 900, 0.0, return_mask=True)[1].sum()
    bound, by = sampler_bound(M, V, n_topk.item())
    out["sampler"]["M8192 V4096"] = {
        "launches_per_decode": {c: per_decode[c]["bf16"]["sampler"]
                                for c in per_decode},
        "max_abs_err": err, "rows_equal": rows_eq, "ms": ms,
        "plain_ms": plain, "library_ms": None, "bound_ms": bound,
        "bound_by": by}
    log(f"[time highres] sampler M={M} V={V} top_k=900 top_p=0.96: rows "
        f"equal with noise {rows_eq:.6f} (need 0.999) "
        f"{'ok' if rows_eq >= 0.999 else 'FAIL'}; kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} library_ms none bound_ms {bound:.4f} ({by})")
    if rows_eq < 0.999:
        raise AssertionError("sampler kernel disagrees at M=8192")
    del logits, noise, seeds, mask, mask_p

    # row 4: d36's rows at the 512 decode's last scale (2B x 1024 = 8192):
    # K=2304 (the qkv, proj and fc1 inputs) and the fc2 input K=9216 with
    # its bias and GELU, bf16; and that fc2 input in f32 (three loads a
    # thread)
    C = D36_512.embed_dim
    for K, gelu, dtype in ((C, False, torch.bfloat16), (4 * C, True, torch.bfloat16),
                           (4 * C, True, torch.float32)):
        x = (torch.randn(M, K, device=DEV, generator=g) * 3).to(dtype)
        bias = (torch.randn(K, device=DEV, generator=g).to(dtype)
                if gelu else None)
        q8, s8 = act_quantize_kernel(x, bias, gelu)
        qp, sp = act_quantize_plain(x, bias, gelu)
        s_rel = ((s8 - sp).abs() / sp).max().item()
        d = (q8.int() - qp.int()).abs()
        frac = (d != 0).float().mean().item()
        ok = (s_rel <= 1e-6 and d.max().item() <= 1 and frac < 1e-3
              and (gelu or frac == 0.0))
        ms = cuda_ms(lambda: act_quantize_kernel(x, bias, gelu), 20)
        plain = cuda_ms(lambda: act_quantize_plain(x, bias, gelu), 3, warmup=1)
        bound, by = act_quantize_bound(M, K, gelu, x.element_size())
        plan = quant_plan(M, K, dtype)
        tag = f"M{M} K{K} {str(dtype)[6:]}{' gelu' if gelu else ''}"
        out["act_quantize"][tag] = {
            "launches_per_decode": {c: per_decode[c]["w8a8-int8kv"]["act_quantize"]
                                    for c in per_decode},
            "max_abs_err": float(d.max().item()), "scale_max_rel": s_rel,
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "bound_ms": bound, "bound_by": by, "loads_a_thread": plan["nv"]}
        log(f"[time highres] act_quantize {tag}: scales max rel {s_rel:.3e}, "
            f"dq != 0 on {frac:.2e} {'ok' if ok else 'FAIL'}; kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} library_ms none bound_ms "
            f"{bound:.4f} ({by}); {plan['group']} threads a row, {plan['nv']} "
            f"loads a thread")
        if not ok:
            raise AssertionError(f"act_quantize disagrees at {tag}")
    del x, bias, q8, qp

    # row 5: the d36 head, f32 x (the W8A8 decode's head is weight-only
    # int8 on an f32 x), 2B x 1024 rows
    N = D36_512.vocab_size
    xm = torch.randn(M, C, device=DEV, generator=g)
    qw = quantize_weight(torch.randn(C, N, device=DEV, generator=g) * 0.02)
    wd = dequantize_weight(qw, torch.float32)
    got = int8_matmul_kernel(xm, qw.q, qw.scale)
    want = int8_matmul_plain(xm, qw.q, qw.scale)
    err = (got - want).abs().max().item()
    lim = 1e-5 * want.abs().max().item()
    ms = cuda_ms(lambda: int8_matmul_kernel(xm, qw.q, qw.scale), 20)
    plain = cuda_ms(lambda: int8_matmul_plain(xm, qw.q, qw.scale), 3)
    lib = cuda_ms(lambda: torch.matmul(xm, wd), 20)
    bound, by = int8_matmul_bound(M, C, N, 4, 4)
    out["int8_matmul"][f"M{M} K{C} N{N} f32 head"] = {
        "launches_per_decode": {c: per_decode[c]["w8a8-int8kv"]["int8_matmul"]
                                for c in per_decode},
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
        "bound_ms": bound, "bound_by": by}
    log(f"[time highres] int8_matmul d36 head (M={M} K={C} N={N}, f32 x): "
        f"max|d| {err:.3e} (limit {lim:.3e}) {'ok' if err <= lim else 'FAIL'}; "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"(torch.matmul on the dequantised weight, untimed dequant) bound_ms "
        f"{bound:.4f} ({by})")
    if err > lim:
        raise AssertionError("int8_matmul disagrees at the d36 head")
    del xm, qw, wd, got, want

    # row 6: the 512px pixel decoder's top level at B=4
    shape = (4, 512, 512, 160, 160)
    Bc, Hc, Wc, Cc, Oc = shape
    x8 = torch.randint(-127, 128, (Bc, Hc, Wc, Cc), device=DEV, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (Oc, 3, 3, Cc), device=DEV, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(Oc, device=DEV, generator=g) * 2e-3
    bias = torch.randn(Oc, device=DEV, generator=g)
    got = conv3x3_s8_kernel(x8, wk, scale, bias)
    want = conv3x3_s8_plain(x8, wk, scale, bias)
    same = torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item()
    del got, want
    ms = cuda_ms(lambda: conv3x3_s8_kernel(x8, wk, scale, bias), 10)
    plain = cuda_ms(lambda: conv3x3_s8_plain(x8, wk, scale, bias), 1, warmup=1)
    xb = torch.randn(Bc, Cc, Hc, Wc, device=DEV, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    wb = torch.randn(Oc, Cc, 3, 3, device=DEV, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    c_ms = cuda_ms(lambda: F.conv2d(xb, wb, bias.to(torch.bfloat16), padding=1), 10)
    bound, by = conv3x3_s8_bound(*shape, 2)
    plan = conv_plan(*shape)
    out["conv3x3_s8"]["512px top level B=4"] = {
        "launches_per_pixel_decode": conv_sites,
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": None,
        "bf16_conv_ms": c_ms, "bound_ms": bound, "bound_by": by}
    log(f"[time highres] conv3x3_s8 (B,H,W,C,O)={shape} ({plan['path']} path, "
        f"grid {plan.get('grid')}): bit-equal {same} {'ok' if same else 'FAIL'}; "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms none bound_ms "
        f"{bound:.4f} ({by}); bf16_conv_ms {c_ms:.4f} (F.conv2d, cuDNN, the "
        f"conv the site replaces)")
    if not same:
        raise AssertionError("conv3x3_s8 disagrees at the 512px top level")
    del x8, wk, xb, wb
    torch.cuda.empty_cache()
    return out


def phase_highres(name):
    """The thirteenth slice's phases, after the card is freed of the
    earlier phases' models and caches."""
    _free_card("before the high-resolution phases")
    t0 = time.time()
    res = {"d36-512": phase_d36_512(name)}
    _free_card("after d36-512")
    res["d16-1024"] = phase_d16_1024(name)
    _free_card("after d16-1024")
    res["cache 2^31"] = phase_cache_past_2_31(name)
    phase_highres_small_reference()
    per = {"d36-512": highres_per_decode(D36_512),
           "d16-1024": highres_per_decode(D16_1024)}
    sites = (res["d36-512"]["modes"]["bf16"]["pixels"]["nhwc-int8"]
             ["sites_quantized"])
    with full_f32():
        res["times"] = phase_highres_kernel_times(per, sites)
    log(f"[highres] phases took {time.time() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# the fourteenth slice: the training tools, through their run()
# ---------------------------------------------------------------------------

def _reference_var_state_dict(cfg: VARConfig, p) -> dict:
    """The reference VAR state_dict of the port tree ``p`` (nn.Linear
    weights (out, in), per-layer tensors unstacked), on the CPU."""
    C, H = cfg.embed_dim, cfg.num_heads
    sd = {"word_embed.weight": p["word_embed"]["w"].T,
          "word_embed.bias": p["word_embed"]["b"],
          "class_emb.weight": p["class_emb"],
          "pos_start": p["pos_start"].reshape(1, cfg.first_l, C),
          "pos_1LC": p["pos_1LC"].reshape(1, cfg.L, C),
          "lvl_embed.weight": p["lvl_embed"],
          "head_nm.ada_lin.1.weight": p["head_nm"]["w"].T,
          "head_nm.ada_lin.1.bias": p["head_nm"]["b"],
          "head.weight": p["head"]["w"].T, "head.bias": p["head"]["b"]}
    b = p["blocks"]
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        sd.update({pre + "attn.mat_qkv.weight": b["qkv_w"][i].T,
                   pre + "attn.q_bias": b["q_bias"][i],
                   pre + "attn.v_bias": b["v_bias"][i],
                   pre + "attn.proj.weight": b["proj_w"][i].T,
                   pre + "attn.proj.bias": b["proj_b"][i],
                   pre + "ffn.fc1.weight": b["fc1_w"][i].T,
                   pre + "ffn.fc1.bias": b["fc1_b"][i],
                   pre + "ffn.fc2.weight": b["fc2_w"][i].T,
                   pre + "ffn.fc2.bias": b["fc2_b"][i],
                   pre + "attn.scale_mul_1H11": b["scale_mul"][i].reshape(1, H, 1, 1),
                   pre + "ada_lin.1.weight": b["ada_lin_w"][i].T,
                   pre + "ada_lin.1.bias": b["ada_lin_b"][i]})
    return {k: v.detach().cpu().contiguous().clone() for k, v in sd.items()}


def phase_convert(name):
    """``convert_checkpoint.run`` on a VAR-d16 state_dict with random
    weights in the reference's key layout, wrapped as a training
    checkpoint: the port checkpoint it writes, read with a template of
    ``init_var_params`` on the card, bit-equal to ``var_params_from_torch``
    of the same state_dict."""
    cfg = VARConfig(depth=TRAIN_DEPTH)
    sd = _reference_var_state_dict(cfg, init_var_params(cfg, seed=21, device=DEV))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "var_d16.pth")
        torch.save({"trainer": {"var_wo_ddp": sd}}, path)
        t0 = time.time()
        res = convert_checkpoint.run(os.path.join(d, "out"), var=path,
                                     depth=TRAIN_DEPTH)
        wall = time.time() - t0
        got, meta = CK.load_checkpoint(res["var"], init_var_params(cfg, seed=0,
                                                                   device=DEV))
    want = var_params_from_torch(cfg, sd, device=DEV)
    pairs = list(zip(TR.tree_leaves(got), TR.tree_leaves(want)))
    same = all(pa == pb and torch.equal(a, b) for (pa, a), (pb, b) in pairs)
    ok = same and meta["kind"] == "var" and meta["depth"] == TRAIN_DEPTH
    log(f"[convert] d16 reference state_dict ({len(sd)} tensors, trainer "
        f"wrapper) -> ckpt-00000000 in {wall:.1f} s; read back on {name}: "
        f"{len(pairs)} leaves bit-equal to var_params_from_torch {same}, meta "
        f"{meta} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[convert] the converted checkpoint differs")


def phase_pretokenize(name):
    """``pretokenize.run`` on 64 synthetic 256px images, one pass, on the
    card: ``TokenDataset`` reads back ids equal to ``train.trainer.tokenize``
    of the same images (the f32 encoder, the same seeded VQVAE)."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        m = pretokenize.run(d, passes=1, synthetic_len=64, seed=0)
        wall = time.time() - t0
        ds = TokenDataset(d)
        got = torch.from_numpy(np.stack([ds[i][0] for i in range(len(ds))]))
    img, _ = batch_arrays(SyntheticImageNet(reso=256, length=64, seed=0),
                          list(range(64)))
    vae = init_vqvae_params(VQVAEConfig(), seed=0, device=DEV)
    img = torch.from_numpy(img).to(DEV)
    want = torch.cat([TR.tokenize(VARConfig(), VQVAEConfig(), vae,
                                  img[i:i + 32])[1] for i in (0, 32)]).cpu()
    same = torch.equal(got.long(), want.long())
    log(f"[pretokenize] 64 images x 1 pass -> {m['num_shards']} shard, L="
        f"{m['L']}, in {wall:.1f} s on {name}; TokenDataset ids equal to "
        f"train.trainer.tokenize's: {same}")
    if not same or got.shape != (64, 680):
        raise AssertionError("[pretokenize] the stored ids differ")


def phase_bench_train(name):
    """``bench_train``'s step (f32 tokenize and the token path), varonly
    and tokenize (f32 and channels-last bf16) at VAR-d16 B=32: ms/step,
    img/s, MFU against 989 TFLOP/s and the allocator's peak."""
    res = {}
    for tag, argv in (("step", ["step", "16", "32", "3"]),
                      ("step tokens", ["step", "16", "32", "3", "tokens"]),
                      ("varonly", ["varonly", "16", "32"]),
                      ("tokenize f32", ["tokenize", "32"]),
                      ("tokenize nhwc", ["tokenize", "32", "nhwc"])):
        _free_card(f"bench_train {tag}, before")
        r = bench_train.run(argv)
        ok = r["ms"] > 0 and math.isfinite(r["ms"]) and all(
            math.isfinite(x) for x in r.get("losses", [r.get("loss", 0.0)]))
        res[tag] = {k: r[k] for k in ("ms", "img_per_s", "mfu", "peak_gib")
                    if k in r}
        log(f"[bench_train] {tag}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in res[tag].items()) + f" on {name} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[bench_train] {tag}")
    return res


def phase_profile_train(name):
    """``profile_train.run(16, 32)``: one remat step on the token path
    under torch.profiler; kernel row 1 launched 32 times in it (16 layers,
    each forward run again in the backward)."""
    _free_card("profile_train, before")
    r = profile_train.run(TRAIN_DEPTH, TRAIN_B)
    want = 2 * TRAIN_DEPTH
    ok = r["attention_launches"] == want and r["total_ms"] > 0
    log(f"[profile_train] d16 B=32 remat step {r['step_ms']:.1f} ms; profiled: "
        f"device {r['total_ms']:.1f} ms, busy share {r['busy_share']:.3f}; "
        f"categories " + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
            r["categories"].items(), key=lambda kv: -kv[1]))
        + f"; attention backward {r['attention_backward_ms']:.1f} ms; "
        f"{r['attention_launches']} row-1 launches (want {want}) on {name} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[profile_train] row-1 launches or device time")
    return {k: r[k] for k in ("step_ms", "total_ms", "busy_share", "categories",
                              "attention_backward_ms", "attention_launches")}


def phase_adjudicate_mfu(name):
    """``adjudicate_mfu.run(16, 32, iters=2)``: the token-path step, the
    five GEMM shapes in their three passes, row 1's forward and the
    Function's forward + backward, the residual and the verdict."""
    _free_card("adjudicate_mfu, before")
    r = adjudicate_mfu.run(TRAIN_DEPTH, TRAIN_B, iters=2)
    ok = all(math.isfinite(r[k]) and r[k] > 0 for k in (
        "step_ms", "mfu", "gemm_floor_ms", "attn_est_ms", "attn_fwd_bwd_ms"))
    log(f"[adjudicate_mfu] step {r['step_ms']:.1f} ms, MFU {r['mfu']:.4f}, GEMM "
        f"floor {r['gemm_floor_ms']:.1f} ms at {r['gemm_tflops']:.0f} TFLOP/s, "
        f"attention 3 x forward {r['attn_est_ms']:.1f} ms / measured "
        f"{r['attn_fwd_bwd_ms']:.1f} ms on {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[adjudicate_mfu] a figure is not finite")
    return {k: r[k] for k in ("step_ms", "mfu", "gemm_floor_ms", "gemm_tflops",
                              "attn_est_ms", "attn_fwd_bwd_ms", "residual_ms")}


def phase_calib_pixels(name):
    """``calib_pixels.run(train_vae=5, cal_batches=2, iters=2)``: kernel
    row 6 at every eligible site of the dynamic W8A8 decode and at every
    quantized site of each calibrated one, a finite verdict."""
    _free_card("calib_pixels, before")
    r = calib_pixels.run(train_vae=5, cal_batches=2, iters=2)
    rows = r["rows"]
    per = {k: v["conv_launches"] for k, v in rows.items()}
    bad = [k for k, v in rows.items() if k.startswith("calib")
           and v["conv_launches"] != v["sites_quantized"]]
    ok = (per["w8a8_dynamic"] == r["sites"] and per["nhwc_bf16"] == 0
          and not bad and math.isfinite(r["best_err"])
          and math.isfinite(r["bf16_err"]))
    log(f"[calib_pixels] {r['sites']} eligible sites; conv3x3_s8 launches per "
        f"decode {per}; verdict {r['verdict']} (best {r['best_err']:.5f} vs "
        f"bf16 {r['bf16_err']:.5f}) on {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[calib_pixels] row-6 launches {per} (sites "
                             f"{r['sites']}), or a non-finite verdict")
    return {"sites": r["sites"], "launches_per_decode": per,
            "verdict": r["verdict"]}


def phase_train_pair(name):
    """``train_pair`` with its geometry cut (4 classes of 32 images, 4
    held out, one pass): prep, the d8 target and the d4 draft 24 iterations
    each at batch 16, a sweep (the target-only decode, both per-scale
    profiles, gamma 2 at threshold 0.5: kernel rows 1 and 3), then the
    drill: a control run to 2.5 epochs, the same run SIGKILLed mid-epoch 2
    and relaunched, its epoch-2 checkpoint bit-equal to the control's."""
    _free_card("train_pair, before")
    with tempfile.TemporaryDirectory() as work:
        geo = ["--work", work, "--classes", "4", "--per-class", "32",
               "--per-class-val", "4"]
        t0 = time.time()
        train_pair.run(geo + ["prep", "--passes", "1"])
        fit = {role: train_pair.run(geo + ["train", "--role", role, "--bs", "16",
                                           "--max-iters", "24"])
               for role in ("target", "draft")}
        t_train = time.time() - t0
        _reset_counts()
        rows = train_pair.run(geo + ["sweep", "--gammas", "2", "--thresholds",
                                     "0.5", "--iters", "1"])
        counts = _read_counts()
        t0 = time.time()
        drill = train_pair.run(geo + ["drill", "--bs", "16"])
        t_drill = time.time() - t0
    profiles = [r["match_rates"] for r in rows if r["kind"].startswith("profile")]
    sweep = [r for r in rows if r["kind"] == "sweep"]
    ok = (len(sweep) == 1 and sweep[0]["target_calls"] > 0
          and counts["attention"] > 0 and counts["sampler"] > 0
          and all(0.0 <= x <= 1.0 for p in profiles for x in p)
          and all(math.isfinite(f["loss_last"]) for f in fit.values()))
    log(f"[train_pair] prep + target/draft 24 iterations each in {t_train:.1f} "
        f"s (" + ", ".join(f"{k} {v['ms_per_step']:.0f} ms/step" for k, v in
                           fit.items())
        + f"); sweep: profiles {profiles}, row {json.dumps(sweep[0])}, "
        f"launches attention {counts['attention']} sampler {counts['sampler']}; "
        f"drill ({t_drill:.1f} s): killed at it {drill['killed_at']}, resumed "
        f"from step {drill['resumed_from']}, {drill['leaves']} leaves bit-equal "
        f"at step {drill['step']} on {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[train_pair] the sweep or the training")
    return {"sweep_launches": {k: counts[k] for k in ("attention", "sampler")},
            "drill": drill}


def phase_training_tools(name):
    """The fourteenth slice's phases, in the order the tools were ported."""
    res = {}
    for tag, fn in (("convert", phase_convert), ("pretokenize", phase_pretokenize),
                    ("bench_train", phase_bench_train),
                    ("profile_train", phase_profile_train),
                    ("adjudicate_mfu", phase_adjudicate_mfu),
                    ("calib_pixels", phase_calib_pixels),
                    ("train_pair", phase_train_pair)):
        t0 = time.time()
        res[tag] = fn(name)
        log(f"[training tools] {tag} took {time.time() - t0:.1f} s")
    _free_card("after the training tools")
    return res


# the fifteenth slice: VAR-d36 512px trains with f32 master weights and
# AdamW on one card, its state updated in place (the JAX tool's
# ``bench_train step 36 B reso512 remat tokens`` recipe, at B=2)
D36_TRAIN_B = 2


def phase_d36_train(name):
    """VAR-d36 at 512px with shared AdaLN (C=2304, 36 heads, L=2240, 2.35 B
    parameters), f32 master weights, AdamW, bf16 forward, remat: one
    token-path ``train_step`` at B=2 on random ids from seed 7 (the
    quantizer's weights from seed 3, as ``tools/adjudicate_mfu``'s token
    step). Gates: the loss and the grad norm finite; every leaf of the
    parameters and of Adam's state in its own storage after the step, and
    a parameter leaf changed; kernel row 1 launched 72 times (36 layers,
    each forward again in the backward) and no other kernel; the
    optimizer's added peak (``apply_optimizer``, above what is allocated
    when it starts) at most the largest leaf's bytes (a stacked fc1_w,
    2.85 GiB). Prints the step's time (the first at this shape), the
    optimizer's added peak and the allocator's peak."""
    _free_card("d36-512 train f32, before")
    dev = torch.device(DEV)
    cfg, vae_cfg = D36_512, VQVAEConfig(patch_nums=PATCH_NUMS_512)
    t0 = time.time()
    state = TR.init_train_state(init_var_params(cfg, seed=0, device=DEV))
    vae = {"quant": init_quantizer_params(
        vae_cfg, torch.Generator(device=dev).manual_seed(3), dev)}
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (D36_TRAIN_B, cfg.L))
                           ).to(dev)
    label = torch.from_numpy(rng.integers(0, 1000, (D36_TRAIN_B,))).to(dev)
    n_params, largest = count_params(state.params), _largest_leaf(state.params)
    before = state.params["head"]["w"].clone()
    ptrs = _storage(state)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with _optimizer_peak() as opt:
        state, m = TR.train_step(
            cfg, vae_cfg, state, vae, ids, label, 1e-4, 0.05,
            TR.step_generator(0, 0, dev), label_smooth=0.1,
            dtype=torch.bfloat16, remat=True, pretokenized=True)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    peak = max(opt["before"], torch.cuda.max_memory_allocated()) / 2 ** 30
    kept = _storage(state) == ptrs
    moved = not torch.equal(before, state.params["head"]["w"])
    want = 2 * cfg.depth
    ok = (math.isfinite(loss) and math.isfinite(gnorm) and kept and moved
          and counts == _want(attention=want) and opt["calls"] == 1
          and opt["added"] <= largest)
    log(f"[d36-512 train f32] VAR-d36 512px shared AdaLN, {n_params / 1e9:.3f} "
        f"B parameters, f32 master weights + AdamW state {state_gib:.2f} GiB "
        f"(init {init_s:.1f} s); one token-path train_step, B={D36_TRAIN_B}, "
        f"remat, bf16 forward: {step_ms:.1f} ms (the first at this shape), "
        f"loss {loss:.4f}, grad norm {gnorm:.4f}; every state leaf in its own "
        f"storage {kept}, a parameter changed {moved}; row 1 launches "
        f"{counts['attention']} (want {want}, no other kernel); the "
        f"optimizer's added peak {opt['added'] / 2 ** 30:.3f} GiB (limit the "
        f"largest leaf, {largest / 2 ** 30:.3f} GiB); the allocator's peak "
        f"{peak:.2f} GiB on {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[d36-512 train f32] a gate failed")
    del state, vae, before, m
    _free_card("d36-512 train f32, after")
    return {"launches_per_step": counts["attention"], "step_ms": step_ms,
            "optimizer_added_gib": opt["added"] / 2 ** 30, "peak_gib": peak,
            "state_gib": state_gib, "loss": loss}


MESH_ROWS = ("attention", "sampler", "attention_int8", "act_quantize",
             "int8_matmul")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase_mesh
        return mesh_rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--mesh4-rank"]:  # one rank of phase_mesh_replicated
        return mesh4_rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--train-mesh-rank"]:  # one rank of phase_train_mesh
        return train_mesh_rank_main(sys.argv[2])
    t_start = time.time()
    name = phase_device_and_build()
    if get_attention_impl() != "auto":  # before any launch gate
        raise AssertionError(f"attention impl {get_attention_impl()!r} at "
                             f"start, not the default 'auto'")
    log("[attention impl] 'auto' (the default): the kernels on the card")
    with full_f32():  # the plain f32 versions' products, as the kernels'
        errs, smp = phase_kernel_checks()
        errs.update(phase_quant_kernel_checks())
        errs.update(phase_cache_kernel_checks())
        errs.update(phase_fused_checks())
    errs.update(phase_conv_checks())
    phase_quant_bits()
    launches = phase_main_path(name)
    launches.update(phase_quant_path(name))
    switched = phase_cache_switch(name)
    spec_launches = phase_speculative(name)
    phase_spec_serving(name)
    conv_launches, per_decode = phase_serving(name)
    phase_f32_server(name)
    phase_small_reference()
    phase_small_reference_quant()
    phase_fp8(name)
    phase_small_reference(quant="fp8")
    phase_sample_fid(name)
    phase_benchmark_cli()
    phase_bench_serving()
    phase_bench()
    probe_mesh_placement.run()  # a 1x1 mesh: the same launches and bits
    wide = phase_sampler_widths()
    t_train = time.time()
    train_att = phase_train_attention()
    phase_train_small_reference()
    train = phase_train(name)
    smoke = phase_train_smoke()
    log(f"[train] phases took {time.time() - t_train:.1f} s")
    t_train = time.time()
    train_mesh = phase_train_mesh(name)
    log(f"[train mesh] phase took {time.time() - t_train:.1f} s")
    t_train = time.time()
    phase_vae_train(name)
    phase_native_loader(name)
    log(f"[vae train, native loader] phases took {time.time() - t_train:.1f} s")
    t_tools = time.time()
    tools = phase_training_tools(name)
    log(f"[training tools] phases took {time.time() - t_tools:.1f} s")
    t_d36 = time.time()
    d36_train = phase_d36_train(name)
    log(f"[d36-512 train f32] phase took {time.time() - t_d36:.1f} s")
    highres = phase_highres(name)
    phase_mesh_replicated()
    t_mesh = time.time()
    reps = phase_mesh(name)
    log(f"[mesh] phase took {time.time() - t_mesh:.1f} s")
    with full_f32():
        kernels = phase_kernel_times(launches, errs, smp)
    kernels.append(phase_conv_times(conv_launches, per_decode, errs))
    with full_f32():
        kernels += phase_cache_kernel_times(
            spec_launches["cache_write"],
            switched["w8a8"]["cache_write_int8"], errs)
    kernels.append(phase_probe_times([rep["probe"]["launches"] for rep in reps]))
    kernels.append(phase_microbench(errs))
    for row in kernels:  # launches per rank and decode on the d30 mesh paths
        if row["name"] in MESH_ROWS:
            row["mesh_launches_per_rank"] = {
                tag: reps[0][tag]["launches"][row["name"]]
                for tag in ("d30 1x2 bf16", "d30 1x2 w8a8", "d30 2x1 bf16",
                            "d30 2x1 w8a8")}
    for row in kernels:
        if row["name"] == "sampler":  # rows past 8192, in device memory
            row["wide"] = wide
        if row["name"] == "attention":  # row 1 on the training path
            row["train"] = {"launches_per_step": train["launches_per_step"],
                            "remat_launches_per_step":
                                train["remat_launches_per_step"],
                            "mesh_launches_per_step_per_rank": {
                                tag: train_mesh[0][tag]["launches_per_step"]
                                for tag in TRAIN_MESHES},
                            "d36_512_f32_remat_launches_per_step":
                                d36_train["launches_per_step"],
                            "L680": train_att[680],
                            "L424": train_att[TRAIN_PREFIX],
                            "d36_512_B2_L2240": train_att["d36-512"],
                            "smoke_f32_hd32": smoke}
    for row in kernels:  # launches of the training tools' runs
        if row["name"] == "attention":
            row["tools"] = {
                "profile_train_remat_step":
                    tools["profile_train"]["attention_launches"],
                "train_pair_sweep": tools["train_pair"]["sweep_launches"]["attention"]}
        if row["name"] == "sampler":
            row["tools"] = {"train_pair_sweep":
                            tools["train_pair"]["sweep_launches"]["sampler"]}
        if row["name"] == "conv3x3_s8":
            row["tools"] = {"calib_pixels_per_decode":
                            tools["calib_pixels"]["launches_per_decode"]}
    for row in kernels:  # rows 1-6 at the high-resolution shapes
        if row["name"] in highres["times"]:
            row["highres"] = highres["times"][row["name"]]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
