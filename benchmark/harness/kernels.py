"""Kernel-name classification of device operations, a frozen copy of the
port's ``tools/profile_decode.py`` categories (first match wins), with
cuDNN's Winograd kernels added to the convolutions. The port's own
kernels are named by their ``__global__`` names in
``sdvar_tpu_torch/csrc/*.cu``: a later change that renames one needs a
change of this file, that is, a benchmark change."""

from __future__ import annotations

CATEGORIES = (
    ("port attention kernel", ("attention_mma_kernel", "attention_f32_kernel")),
    ("port sampler kernel", ("::sample_kernel(", "sample_kernel")),
    ("port int8 matmul kernel", ("int8_matmul_wgmma_kernel",)),
    ("port act-quant kernel", ("act_quantize_kernel",)),
    ("port int8 conv kernel", ("conv3x3_s8_kernel", "conv3x3_s8_tma_kernel")),
    ("int8 GEMM (cuBLASLt, _int_mm)", ("s8", "i8", "imma", "int8")),
    ("convolution", ("fprop", "fft", "conv", "dgrad", "wgrad", "winograd")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reduction", ("reduce_kernel",)),
    ("copy / cast", ("copy",)),
)


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy / memset"
    return "other elementwise"


def is_conv(name: str) -> bool:
    return category(name) == "convolution"
