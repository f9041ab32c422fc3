"""Fused attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/attention.py:_kernel``,
float-KV and INT8-KV branches. The kernel lives in
``sdvar_tpu_torch/csrc/attention.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); its source note gives the bound and the design. ``attention_plain``
computes the same function in f32 with einsums: it is the CPU path and the
yardstick on the card.

Layouts follow the JAX package: q (B, Lq, H, hd); k/v (B, Lk, H, hd), or
token-major (Lk, B, H, hd) when ``kv_token_major``; bias (Lq, Lk) or None;
``kv_scales`` (ks, vs) f32 per-token scales of int8 k/v, each (B, Lk), or
(Lk, B) when token-major. The kernel takes any batch/token strides as long
as the heads are packed in the last merged dim, so KV-cache slices, their
scale planes and views of the fused qkv projection go in without a copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sdvar_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _scales_bk(kv_scales, kv_token_major: bool):
    """(ks, vs) as (B, Lk) views."""
    ks, vs = kv_scales
    return (ks.t(), vs.t()) if kv_token_major else (ks, vs)


def attention_plain(q, k, v, bias: Optional[torch.Tensor], scale: float,
                    kv_token_major: bool = False,
                    kv_scales=None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v in f32, returned in q's dtype.

    Fully-masked rows give 0, as in the TPU kernel: the row max is clamped
    at -1e30 and the sum at 1e-30, and the division comes after PV (a bare
    softmax would give NaN). With ``kv_scales`` (int8 k/v), the kernel's
    order: the key scale multiplies the scaled scores before the bias, l is
    summed before the value scale folds into p, and p * vs is cast to q's
    dtype before the PV product."""
    kidx = "kbhd" if kv_token_major else "bkhd"
    s = torch.einsum(f"bqhd,{kidx}->bhqk", q.float(), k.float()) * scale
    if kv_scales is not None:
        ks, vs = (t.float()[:, None, None, :]
                  for t in _scales_bk(kv_scales, kv_token_major))
        s = s * ks
    if bias is not None:
        s = s + bias.float()[None, None]
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # (b, h, q, 1)
    if kv_scales is not None:
        p = (p * vs).to(q.dtype).float()
    o = torch.einsum(f"bhqk,{kidx}->bqhd", p, v.float())
    o = o / l.clamp(min=1e-30).permute(0, 2, 1, 3)
    return o.to(q.dtype)


def _lib(int8: bool):
    lib = _build.load("attention")
    fn = lib.sdvar_attention_int8 if int8 else lib.sdvar_attention
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ptrs, strides = (7, 8) if int8 else (5, 6)
        fn.argtypes = ([P] * ptrs + [I] * 6 + [LL] * strides
                       + [ctypes.c_float, P])
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Shared memory of one kernel block for head dim ``hd`` and ``dtype``."""
    fn = _build.load("attention").sdvar_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(hd, _DTYPES[dtype])


def _check_operand(name: str, t: torch.Tensor, dtype, hd: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"attention_kernel: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"attention_kernel: {name} is {t.dtype}, needs {dtype}")
    if t.dim() != 4 or t.stride(-1) != 1 or t.stride(-2) != hd:
        raise ValueError(f"attention_kernel: {name} needs packed heads and a "
                         f"contiguous head dim, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    vec = 16 // t.element_size()  # the kernel loads 16 bytes at a time
    if t.data_ptr() % 16 or t.stride(0) % vec or t.stride(1) % vec:
        raise ValueError(f"attention_kernel: {name} must be 16-byte aligned "
                         f"with strides a multiple of {vec}")


def attention_kernel(q, k, v, bias: Optional[torch.Tensor], scale: float,
                     kv_token_major: bool = False,
                     kv_scales=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does not
    take. Adds one per launch to ``attention_kernel.launches`` (float K/V)
    or ``attention_kernel.launches_int8`` (int8 K/V with ``kv_scales``)."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention_kernel: dtype {q.dtype} not supported")
    B, Lq, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"attention_kernel: head dim {hd} not in {_HEAD_DIMS}")
    int8 = kv_scales is not None
    kv_dtype = torch.int8 if int8 else q.dtype
    _check_operand("q", q, q.dtype, hd)
    for name, t in (("k", k), ("v", v)):
        _check_operand(name, t, kv_dtype, hd)
    if k.shape != v.shape:
        raise ValueError("attention_kernel: k and v must share a shape")
    b_dim, l_dim = (1, 0) if kv_token_major else (0, 1)
    Bk, Lk = k.shape[b_dim], k.shape[l_dim]
    Hk, hdk = k.shape[2:]
    if (Bk, Hk, hdk) != (B, H, hd):
        raise ValueError(f"attention_kernel: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if bias is not None:
        if (bias.dtype != torch.float32 or not bias.is_cuda
                or not bias.is_contiguous() or tuple(bias.shape) != (Lq, Lk)):
            raise ValueError("attention_kernel: bias must be a contiguous "
                             f"float32 CUDA tensor of shape {(Lq, Lk)}")
    if k.device != q.device or v.device != q.device or (
            bias is not None and bias.device != q.device):
        raise ValueError("attention_kernel: operands on different devices")
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    strides = [q.stride(0), q.stride(1), k.stride(b_dim), k.stride(l_dim),
               v.stride(b_dim), v.stride(l_dim)]
    if int8:
        ks, vs = _scales_bk(kv_scales, kv_token_major)
        for t in (ks, vs):
            if (t.dtype != torch.float32 or t.device != q.device
                    or tuple(t.shape) != (B, Lk) or t.stride() != ks.stride()):
                raise ValueError("attention_kernel: kv_scales must be two "
                                 f"float32 ({B}, {Lk}) planes on q's device "
                                 "with one pair of strides")
        ptrs += [ks.data_ptr(), vs.data_ptr()]
        strides += list(ks.stride())
    out = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device)
    ptrs += [bias.data_ptr() if bias is not None else None, out.data_ptr()]
    err = _lib(int8)(
        *ptrs, _DTYPES[q.dtype], B, Lq, Lk, H, hd, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_kernel: launch failed with cudaError {err}")
    if int8:
        attention_kernel.launches_int8 += 1
    else:
        attention_kernel.launches += 1
    return out


attention_kernel.launches = 0
attention_kernel.launches_int8 = 0
