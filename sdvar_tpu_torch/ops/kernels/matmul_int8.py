"""INT8-weight matmul: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/matmul_int8.py:_kernel``
(reached through ``int8_matmul`` / ``int8_matmul_blc``). The kernel lives
in ``sdvar_tpu_torch/csrc/matmul_int8.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); its source note gives the bound and the design.
``int8_matmul_plain`` computes the same function, ``(x @ q) * s`` with an
f32 sum and the scale applied to that sum: it is the CPU path and the
yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch

from sdvar_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16/f32 @ int8 (K, N) -> (M, N) in x's dtype:
    ``(x.float() @ q.float()) * s``."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def _lib():
    fn = _build.load("matmul_int8").sdvar_int8_matmul
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_longlong, P]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_kernel(x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (output in x's dtype); raise on
    anything it does not take. Adds one to ``int8_matmul_kernel.launches``
    per launch."""
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError("int8_matmul_kernel: x, q and s must be CUDA tensors "
                         "on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_matmul_kernel: x {x.dtype} not supported "
                         "(float32 or bfloat16)")
    if x.dim() != 2 or q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"int8_matmul_kernel: needs x (M, K) and int8 q (K, N), "
                         f"got {tuple(x.shape)} and {tuple(q.shape)} {q.dtype}")
    M, K = x.shape
    N = q.shape[1]
    if q.shape[0] != K or s.shape != (N,) or s.dtype != torch.float32:
        raise ValueError(f"int8_matmul_kernel: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)} and f32 s {tuple(s.shape)} disagree")
    if K % 8 or N % 16:
        raise ValueError(f"int8_matmul_kernel: K={K} must be a multiple of 8 "
                         f"and N={N} of 16")
    vec = 16 // x.element_size()  # the kernel loads 16 bytes at a time
    if (x.stride(1) != 1 or x.stride(0) % vec or x.data_ptr() % 16
            or not q.is_contiguous() or q.data_ptr() % 16
            or not s.is_contiguous()):
        raise ValueError("int8_matmul_kernel: x needs contiguous rows, 16-byte "
                         f"aligned with a row stride a multiple of {vec}; q "
                         "and s must be contiguous and aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], M, N, K, x.stride(0),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_kernel: launch failed with cudaError {err}")
    int8_matmul_kernel.launches += 1
    return out


int8_matmul_kernel.launches = 0


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s)
    return int8_matmul_kernel(x, q, s)


def int8_matmul_blc(x_blc: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., K) @ int8 (K, N) -> (..., N); flattens the tokens into M."""
    K = x_blc.shape[-1]
    y = int8_matmul(x_blc.reshape(-1, K), q, s)
    return y.view(*x_blc.shape[:-1], q.shape[1])
