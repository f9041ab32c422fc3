"""Fused W8A8 matmul (per-token activation quantization + int8 product +
scale epilogue in one launch): the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel ``tools/microbench_int8_matmul.py:_pallas_w8a8``
(the JAX microbenchmark's ``pl_s8`` and ``pl_bf16`` modes). The kernel lives
in ``sdvar_tpu_torch/csrc/w8a8_fused.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); its source note gives the bound and the design: one persistent
block an SM quantizes each 256-row strip of x once into a scratch (and, in
the bf16 form, converts the weights once), publishing a flag a strip, then
multiplies 256 x 160 output tiles with wgmma from a TMA-filled ring.
:func:`w8a8_plan` gives the tiles, the grid and the scratch.

Function, for x (..., K) bf16 or f32, wq int8 (K, N) stored K-major (as
``ops.quantization.as_w8a8`` stores it) and ws f32 (N,):

    xq, xs = per-token int8 quantization of x   (``quantize_activation``)
    acc    = xq @ wq      s8=True: exact integer sum; s8=False: an f32 sum
                          of the int-valued operands (the TPU's bf16 form)
    out    = bf16((acc * xs) * ws)               (..., N)

``w8a8_fused_plain`` does these operations in this order with plain
PyTorch ops: the exact sum as an f64 product of the int8 values (every
partial sum is an integer below 2^53) rounded once to f32, as an int32 sum
converts; the f32 form with TF32 off. It is the CPU path and the yardstick
on the card; with ``s8=True`` the kernel gives its bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize_plain
from sdvar_tpu_torch.utils.device import full_f32
from sdvar_tpu_torch.utils.profiling import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_M, TILE_N = 256, 160  # an output tile: two consumer warpgroups x 128 rows
UNIT = 32                  # rows (or weight columns) a quantization unit
STAGES = 4                 # ring stages of 53248 bytes
STAGE_BYTES = (TILE_M + TILE_N) * 128
ALIGN = 1024               # the scratch's parts start 1024-aligned


def _up(v: int) -> int:
    return -(-v // ALIGN) * ALIGN


@functools.lru_cache(maxsize=256)
def w8a8_plan(M: int, K: int, N: int, s8: bool = True, sms: int = 132) -> dict:
    """The fused kernel's geometry: 256 x 160 output tiles walked by a
    persistent grid of at most one block an SM, launched cooperatively (so
    every block is resident, or the launch fails); the quantization units
    (32 rows of x each; in the bf16 form also 32 weight columns each) come
    first in every block's work list, so a tile's strip is quantized once,
    not once per column tile. ``scratch_bytes``: the quantized x (int8, or
    int-valued bf16), xs, the bf16 weights (bf16 form) and one int32 flag
    per strip (and weight tile), each part 1024-aligned, in the CUDA
    source's order."""
    tiles_m, tiles_n = -(-M // TILE_M), -(-N // TILE_N)
    units = -(-M // UNIT) + (0 if s8 else -(-N // UNIT))
    xq = M * K * (1 if s8 else 2)
    flags = tiles_m + (0 if s8 else tiles_n)
    scratch = _up(xq) + _up(M * 4) + (0 if s8 else _up(N * K * 2)) + flags * 4
    return {"tiles_m": tiles_m, "tiles_n": tiles_n, "tiles": tiles_m * tiles_n,
            "units": units, "grid": max(1, min(sms, max(tiles_m * tiles_n, units))),
            "smem_bytes": 1024 + STAGES * STAGE_BYTES,
            "flags": flags, "scratch_bytes": scratch}


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, s8: bool) -> None:
    """Raise on operands the kernel does not take, on either device."""
    if x.dtype not in _DTYPES or x.dim() < 1:
        raise ValueError(f"w8a8_fused: x must be (..., K) float32 or bfloat16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    K = x.shape[-1]
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != K:
        raise ValueError(f"w8a8_fused: needs int8 wq ({K}, N), got {q.dtype} "
                         f"{tuple(q.shape)}")
    N = q.shape[1]
    if q.stride(0) != 1 or (N > 1 and q.stride(1) != K):
        raise ValueError(f"w8a8_fused: wq {tuple(q.shape)} with strides "
                         f"{q.stride()} is not K-major (build it with as_w8a8)")
    if s.shape != (N,) or s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError(f"w8a8_fused: ws must be contiguous float32 ({N},), "
                         f"got {s.dtype} {tuple(s.shape)}")
    if K % (32 if s8 else 16) or N % 8:
        raise ValueError(f"w8a8_fused: K={K} must be a multiple of "
                         f"{32 if s8 else 16} and N={N} of 8")


def w8a8_fused_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     s8: bool = True) -> torch.Tensor:
    """(..., K) @ int8 (K, N) -> bf16 (..., N), in the kernel's order."""
    K, N = q.shape
    xq, xs = act_quantize_plain(x.reshape(-1, K), None, gelu=False)
    if s8:
        acc = (xq.double() @ q.double()).float()
    else:
        with full_f32():
            acc = xq.float() @ q.float()
    return ((acc * xs) * s).to(torch.bfloat16).view(*x.shape[:-1], N)


def _lib():
    fn = _build.load("w8a8_fused").sdvar_w8a8_fused
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, LL, I, I, LL, P, I, P]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def w8a8_fused_kernel(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      s8: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does not
    take (it never falls back to the plain version). Adds one to
    ``w8a8_fused_kernel.launches`` per launch."""
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError("w8a8_fused_kernel: x, wq and ws must be CUDA tensors "
                         "on one device")
    _check(x, q, s, s8)
    K, N = q.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    vec = 16 // x2.element_size()  # the kernel loads 16 bytes at a time
    if (x2.stride(1) != 1 or x2.stride(0) % vec or x2.data_ptr() % 16
            or q.data_ptr() % 16):
        raise ValueError("w8a8_fused_kernel: x needs contiguous rows, 16-byte "
                         f"aligned with a row stride a multiple of {vec}, and "
                         "wq a 16-byte aligned base")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M:
        plan = w8a8_plan(M, K, N, bool(s8), _sms(x.device.index or 0))
        scratch = torch.empty((plan["scratch_bytes"] + ALIGN,), dtype=torch.uint8,
                              device=x.device)
        base = scratch.data_ptr()
        with launch("sdvar.launch.w8a8_fused"):
            err = _lib()(x2.data_ptr(), q.data_ptr(), s.data_ptr(),
                         out.data_ptr(), _DTYPES[x2.dtype], int(bool(s8)), M,
                         N, K, x2.stride(0), base + (-base) % ALIGN,
                         plan["grid"],
                         torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"w8a8_fused_kernel: launch failed with "
                               f"cudaError {err}")
        w8a8_fused_kernel.launches += 1
    return out.view(*x.shape[:-1], N)


w8a8_fused_kernel.launches = 0


def w8a8_fused(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               s8: bool = True) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version; both
    raise on the operands the kernel does not take."""
    if x.device.type == "cpu":
        _check(x, q, s, s8)
        return w8a8_fused_plain(x, q, s, s8)
    return w8a8_fused_kernel(x, q, s, s8)
