"""The reference's precisions: ``EXACT`` (float32, TF32 off) and the
controls, each the nearest precision below what a configuration states:

- ``CONTROL_BF16``: each tensor the configuration holds in bfloat16 (a
  GEMM's operands, the residual stream) rounded to float8 e4m3, one scale
  a tensor;
- ``CONTROL_F32``: each float32 convolution or matmul in TF32;
- ``CONTROL_INT8``: each operand the configuration quantizes to int8 (a
  GEMM's activations a token, its weights an output column, the KV cache
  a token) rounded to int4 on the same scales' grid, the residual stream
  kept in bfloat16 as the configuration keeps it."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

E4M3_MAX = 448.0


INT4_MAX = 7.0


@dataclass(frozen=True)
class Precision:
    fp8: bool = False        # the configuration's bf16 tensors -> e4m3
    tf32: bool = False       # f32 convolutions and matmuls -> TF32
    int4: bool = False       # the configuration's int8 operands -> int4

    def lower(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """A GEMM operand as the control holds it: e4m3 (one scale a
        tensor) under ``fp8``; under ``int4`` symmetric int4 with one scale
        a slice along ``dim`` (-1: a token's row; -2: a weight's output
        column)."""
        if self.fp8:
            scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
            q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        elif self.int4:
            scale = x.detach().abs().amax(dim, keepdim=True) \
                .clamp(min=1e-30) / INT4_MAX
            q = torch.round(x / scale).clamp(-INT4_MAX, INT4_MAX) * scale
        else:
            return x
        return x + (q - x).detach()   # the rounding's values, x's gradient

    def stream(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream as the control holds it."""
        if self.fp8:
            return self.lower(x)
        if self.int4:   # the configuration keeps it in bfloat16
            return x + (x.to(torch.bfloat16).float() - x).detach()
        return x

    @contextlib.contextmanager
    def f32_math(self):
        """TF32 on (control) or off (exact) for the block, restored after."""
        mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = mm.allow_tf32, cudnn.allow_tf32
        mm.allow_tf32 = cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            mm.allow_tf32, cudnn.allow_tf32 = saved


EXACT = Precision()
CONTROL_BF16 = Precision(fp8=True)        # below bf16
CONTROL_F32 = Precision(tf32=True)        # below an f32 pixel decoder
CONTROL_INT8 = Precision(int4=True)       # below W8A8 and an int8 KV cache
