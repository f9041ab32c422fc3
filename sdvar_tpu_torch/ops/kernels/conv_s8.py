"""INT8 3x3 convolution: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/conv_s8.py:_kernel``
(reached through ``conv3x3_s8``). The kernel lives in
``sdvar_tpu_torch/csrc/conv_s8.cu`` (an implicit GEMM on ``mma.sync``
s8 x s8 -> s32 for sm_90a, loaded with ctypes); its source note gives the
bound and the design.

Both versions take x as contiguous int8 (B, H, W, C) and the weights as
contiguous int8 (O, 3, 3, C) ("OHWI": the kernel's K order per output
channel), and compute the NHWC stride-1 "same" convolution's exact s32
sums, then ``float(acc) * scale[o] + bias[o]`` as two separately rounded
f32 operations, cast to ``out_dtype``. ``conv3x3_s8_plain`` is the CPU path
and the yardstick on the card: the two give the same bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_s8_plain(x8: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The exact integer sums from an f64 convolution of the int8 values
    (exact: every partial sum is an integer far below 2^53), then
    ``acc.float() * scale + bias`` cast to ``out_dtype``; (B, H, W, O)."""
    acc = F.conv2d(x8.permute(0, 3, 1, 2).double(),
                   wk.permute(0, 3, 1, 2).double(), padding=1)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    y = acc.float() * scale.float() + bias.float()
    return y.to(out_dtype).contiguous()


def _lib():
    fn = _build.load("conv_s8").sdvar_conv3x3_s8
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def conv3x3_s8_kernel(x8: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does not
    take (it never falls back to the plain version). Adds one to
    ``conv3x3_s8_kernel.launches`` per launch."""
    dev = x8.device
    if not (x8.is_cuda and all(t.device == dev for t in (wk, scale, bias))):
        raise ValueError("conv3x3_s8_kernel: x8, wk, scale and bias must be "
                         "CUDA tensors on one device")
    if out_dtype not in _DTYPES:
        raise ValueError(f"conv3x3_s8_kernel: out_dtype {out_dtype} not "
                         "supported (float32 or bfloat16)")
    if x8.dtype != torch.int8 or wk.dtype != torch.int8 or x8.dim() != 4:
        raise ValueError(f"conv3x3_s8_kernel: needs int8 x (B, H, W, C) and "
                         f"int8 wk (O, 3, 3, C), got {x8.dtype} "
                         f"{tuple(x8.shape)} and {wk.dtype} {tuple(wk.shape)}")
    B, H, W, C = x8.shape
    O = wk.shape[0]
    if tuple(wk.shape) != (O, 3, 3, C):
        raise ValueError(f"conv3x3_s8_kernel: wk {tuple(wk.shape)} is not "
                         f"(O, 3, 3, C={C})")
    if C % 4:
        raise ValueError(f"conv3x3_s8_kernel: C={C} must be a multiple of 4")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (O,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"conv3x3_s8_kernel: {name} must be contiguous "
                             f"float32 ({O},), got {t.dtype} {tuple(t.shape)}")
    if not x8.is_contiguous() or not wk.is_contiguous():
        raise ValueError("conv3x3_s8_kernel: x8 must be a contiguous (B, H, W, "
                         "C) tensor and wk a contiguous (O, 3, 3, C) one")
    if x8.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv3x3_s8_kernel: x8 and wk must be 16-byte aligned")
    out = torch.empty((B, H, W, O), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    err = _lib()(x8.data_ptr(), wk.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), _DTYPES[out_dtype],
                 B, H, W, C, O, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_s8_kernel: launch failed with cudaError {err}")
    conv3x3_s8_kernel.launches += 1
    return out


conv3x3_s8_kernel.launches = 0


def conv3x3_s8_ohwi(x8: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x8.device.type == "cpu":
        return conv3x3_s8_plain(x8, wk, scale, bias, out_dtype)
    return conv3x3_s8_kernel(x8, wk, scale, bias, out_dtype)
