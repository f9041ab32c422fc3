"""Fused activation quantization: the Triton kernel's wrapper and its plain
version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/quantize.py:_kernel``
(reached through ``act_quantize``). Same function, one pass over a row:

    h = x.float() + bias                                 (bias optional)
    h = 0.5 h (1 + tanh(0.7978845608028654 (h + 0.044715 h^3)))  (gelu)
    s = max(amax(|h|) / 127, 1e-8)                       per token, f32
    q = round_half_even(h / s)  as int8                  (no clip needed)

Numerics against the plain version: the divisions are IEEE round-to-nearest
(``tl.div_rn``, as the plain version's ``/``; a reciprocal multiply would flip
ties), the rounding is ``rint`` (half to even, as ``torch.round`` and
``jnp.round``; CUDA's ``roundf`` rounds half away from zero), and FMA
contraction is off so products and sums round as the plain version's do.
The one function that differs is tanh: libdevice's ``tanhf`` is within
2 ulp of the correctly rounded value, PyTorch's CPU and CUDA tanh within
1, so with ``gelu`` an h may differ in its last bit and a q sitting on a
rounding boundary may move by one step (the checks allow |dq| <= 1 on fewer
than 1e-3 of the elements and scales within 1e-6 relative).

Bound on this card: memory. At the fc2 input of the d30 decode's last
256px scale (M = 2B*256 = 8192 rows at B=16, K = 7680, bf16) it reads
126 MB and writes 63 MB of int8 plus the scales: about 0.056 ms at
3.35 TB/s, against about 14 operations per element. Design: one Triton
program per row holds the whole row (a masked power-of-two block: 8192
lanes for K=7680, 16 per thread) in registers, so x is read once and
written once as int8; masked lanes load 0 and are excluded from the amax. The TPU version's
row-block VMEM budget (``_pick_bm``) and its ``MIN_FUSED_ROWS`` gate are
TPU tuning and are not carried over.

Two more modes serve a row split over ranks (``quantize_activation(
sharded=True)`` in ``ops/quantization.py``): the scales alone, with no int8
store (``act_scale``), and the int8 values under a given scale, with no
amax (``scale=``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch


def _act_rows(x: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool
              ) -> torch.Tensor:
    """The rows the quantization sees: x in f32, plus bias, through GELU."""
    h = x.float()
    if bias is not None:
        h = h + bias.float()
    if gelu:
        h = 0.5 * h * (1.0 + torch.tanh(0.7978845608028654
                                        * (h + 0.044715 * h * h * h)))
    return h


def _row_scale(h: torch.Tensor) -> torch.Tensor:
    amax = h.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor on amax's device, not a Python number: on a CUDA
    # tensor PyTorch turns division by a host number into a product with
    # its reciprocal, whose last bit can differ from the IEEE quotient the
    # kernels take, and an element of exactly amax / 2 (a rounding tie of
    # x / s) then rounds the other way
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)


def act_quantize_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       gelu: bool = True, scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) -> (int8 (..., K), f32 (..., 1) per-token scales). A given
    ``scale`` (f32 (..., 1), at least this row's own) replaces the row's
    own: a row split over ranks quantizes with the scale of the whole row
    (``ops.quantization``'s sharded form)."""
    h = _act_rows(x, bias, gelu)
    s = _row_scale(h) if scale is None else scale
    return torch.round(h / s).to(torch.int8), s


def act_scale_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    gelu: bool = True) -> torch.Tensor:
    """The f32 (..., 1) scales of :func:`act_quantize_plain` alone."""
    return _row_scale(_act_rows(x, bias, gelu))


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """Build the Triton kernel on first use (triton is imported here, never
    at module import: it exists only on the machine with the card)."""
    import triton
    import triton.language as tl

    try:
        from triton.language.extra import libdevice
    except ImportError:  # older layout
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def act_quantize_kernel(x_ptr, b_ptr, q_ptr, s_ptr, K, x_stride,
                            HAS_BIAS: tl.constexpr, GELU: tl.constexpr,
                            HAS_SCALE: tl.constexpr, STORE_Q: tl.constexpr,
                            BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        valid = cols < K
        h = tl.load(x_ptr + row * x_stride + cols, mask=valid,
                    other=0.0).to(tl.float32)
        if HAS_BIAS:
            h = h + tl.load(b_ptr + cols, mask=valid, other=0.0).to(tl.float32)
        if GELU:
            z = 0.7978845608028654 * (h + 0.044715 * h * h * h)
            h = 0.5 * h * (1.0 + libdevice.tanh(z))
        if HAS_SCALE:  # the whole row's scale, given: read, not written
            s = tl.load(s_ptr + row)
        else:
            amax = tl.max(tl.where(valid, tl.abs(h), 0.0), axis=0)
            s = tl.maximum(tl.div_rn(amax, 127.0), 1e-8)
            tl.store(s_ptr + row, s)
        if STORE_Q:  # else the scales alone (a row split over ranks)
            q = libdevice.rint(tl.div_rn(h, s))
            tl.store(q_ptr + row * K + cols, q.to(tl.int8), mask=valid)

    return act_quantize_kernel


def _launch(x: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool,
            scale: Optional[torch.Tensor], store_q: bool):
    if not x.is_cuda:
        raise ValueError("act_quantize_kernel: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() < 1:
        raise ValueError(f"act_quantize_kernel: x must be (..., K) float32 or "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    M = x2.shape[0]
    if bias is not None:
        if (bias.shape != (K,) or bias.device != x.device or bias.stride(0) != 1
                or bias.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"act_quantize_kernel: bias must be a contiguous "
                             f"float32 or bfloat16 ({K},) on x's device")
    q = (torch.empty((M, K), dtype=torch.int8, device=x.device) if store_q
         else None)
    if scale is None:
        s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    else:
        if (scale.dtype != torch.float32 or scale.device != x.device
                or scale.numel() != M):
            raise ValueError(f"act_quantize_kernel: scale must be float32 "
                             f"(..., 1) with one value per row ({M}) on x's "
                             f"device")
        s = scale.reshape(M, 1).contiguous()
    if M:
        block = 1 << max(K - 1, 1).bit_length()
        # 16 elements a thread: 16 warps at K=7680, 4 at K=1920
        _triton_kernel()[(M,)](
            x2, bias if bias is not None else s, q if store_q else s, s, K,
            x2.stride(0),
            HAS_BIAS=bias is not None, GELU=bool(gelu),
            HAS_SCALE=scale is not None, STORE_Q=store_q, BLOCK=block,
            num_warps=min(16, max(4, block // 512)), enable_fp_fusion=False,
        )
        act_quantize_kernel.launches += 1
    return q, s.view(*x.shape[:-1], 1)


def act_quantize_kernel(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        gelu: bool = True, scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Triton kernel on a CUDA tensor; same contract as
    :func:`act_quantize_plain`. Adds one to ``act_quantize_kernel.launches``
    per launch."""
    q, s = _launch(x, bias, gelu, scale, store_q=True)
    return q.view(*x.shape), s


def act_scale_kernel(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     gelu: bool = True) -> torch.Tensor:
    """The same kernel writing the scales alone (no int8 store); same
    contract as :func:`act_scale_plain`. Counted in
    ``act_quantize_kernel.launches``."""
    return _launch(x, bias, gelu, None, store_q=False)[1]


act_quantize_kernel.launches = 0


def act_quantize(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 gelu: bool = True, scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return act_quantize_plain(x, bias, gelu, scale)
    return act_quantize_kernel(x, bias, gelu, scale)


def act_scale(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
              gelu: bool = True) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return act_scale_plain(x, bias, gelu)
    return act_scale_kernel(x, bias, gelu)
