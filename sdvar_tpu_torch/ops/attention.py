"""Attention dispatch: CUDA tensors go to the hand-written kernels, CPU
tensors to their plain PyTorch versions.

The JAX package picks between XLA and Pallas by backend and query size
(a VMEM/grid tuning gate); the port has one kernel for every size, so by
default (``"auto"``) the only choice left is the device the tensors lie
on. ``set_attention_impl`` (the JAX package's switch of
``sdvar_tpu/ops/attention.py:22-28``) lets a caller name the backend of
every attention call below instead: ``"plain"``, the plain PyTorch
version on either device (the counterpart of the JAX package's ``"xla"``
einsum path), or ``"kernel"``, the CUDA kernels (which raise on CPU
tensors). The setting changes only when a caller sets it.

The cache-kernel switch (``set_cache_kernel``, the JAX package's switch of
``sdvar_tpu/ops/attention.py:31-50``, off by default as there) routes every
KV-cached attention of ``models.var`` through ``attention_cache_write``: one
call writes the layer's new keys and values into the cache and attends. The
JAX switch also demands a TPU backend; this one works on both devices (on
the CPU through the plain versions), so the CPU tests cover the switched
path.

Training differentiates the float-KV attention through ``AttentionFn``, the
counterpart of the JAX package's ``custom_vjp`` around its kernel
(``sdvar_tpu/ops/pallas/attention.py:369-389``): the forward is the
kernel (its plain version on the CPU), the backward that package's
backward in plain PyTorch: the whole-tensor VJP of the einsum composition
for Lq * Lk <= 1.5M or Lq < 16, else a flash-style recomputation over
query chunks (``set_attention_bwd_chunk`` overrides the choice).
``attention`` takes it whenever autograd records and a float q, k or v
needs a gradient; inference (no grad, the KV-cache paths, INT8 K/V)
calls the kernel directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from sdvar_tpu_torch.ops.kernels.attention import (
    attention_cache_kernel,
    attention_cache_plain,
    attention_cache_write_kernel,
    attention_cache_write_plain,
    attention_kernel,
    attention_plain,
)

IMPLS = ("auto", "plain", "kernel")
_IMPL = "auto"


def set_attention_impl(impl: str) -> None:
    """Choose the backend of every attention call: one of ``IMPLS``."""
    global _IMPL
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} "
                         f"({' | '.join(IMPLS)})")
    _IMPL = impl


def get_attention_impl() -> str:
    return _IMPL


def _kernel_for(q: torch.Tensor) -> bool:
    """Whether this call launches the kernel (else the plain version)."""
    if _IMPL == "auto":
        return q.device.type != "cpu"
    return _IMPL == "kernel"


_CACHE_KERNEL = False


def set_cache_kernel(on: bool) -> None:
    """Route KV-cached attention through the fused cache-write kernel."""
    global _CACHE_KERNEL
    _CACHE_KERNEL = bool(on)


def use_cache_kernel() -> bool:
    return _CACHE_KERNEL


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], scale: float,
              kv_token_major: bool = False, kv_scales=None) -> torch.Tensor:
    """q: (B, Lq, H, d); k/v: (B, Lk, H, d), or (Lk, B, H, d) when
    ``kv_token_major`` (the JAX package's cache layout); bias: (Lq, Lk)
    additive or None; ``kv_scales``: (ks, vs) f32 per-token scales when k/v
    are int8 KV-cache slices, each (B, Lk), or (Lk, B) when token-major (the
    dequantisation happens inside the kernel). Returns (B, Lq, H, d) in q's
    dtype."""
    if (kv_scales is None and not kv_token_major and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return AttentionFn.apply(q, k, v, bias, scale)
    fn = attention_kernel if _kernel_for(q) else attention_plain
    return fn(q, k, v, bias, scale, kv_token_major, kv_scales)


_BWD_CHUNK_THRESHOLD = 1_500_000  # Lq * Lk above which the backward chunks
_BWD_CHUNK_OVERRIDE: Optional[int] = None


def set_attention_bwd_chunk(chunk: Optional[int]) -> None:
    """Override the backward's chunking: None = by shape (chunk when
    Lq * Lk > 1.5M), 0 = never chunk, n > 0 = chunks of n query rows."""
    global _BWD_CHUNK_OVERRIDE
    _BWD_CHUNK_OVERRIDE = chunk


def bwd_chunk_for(Lq: int, Lk: int) -> int:
    """The backward's query chunk (0: the whole-tensor VJP): the largest
    multiple of 8 up to 256 that divides Lq, or 256 (a padded last chunk)
    if that is below 64."""
    if _BWD_CHUNK_OVERRIDE is not None:
        return _BWD_CHUNK_OVERRIDE
    if Lq * Lk <= _BWD_CHUNK_THRESHOLD or Lq < 16:
        return 0
    best = 0
    for d in range(8, min(Lq, 256) + 1, 8):
        if Lq % d == 0:
            best = d
    return best if best >= 64 else 256


def attention_composition(q, k, v, bias: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v as the JAX package's reference
    composition computes it: f32 scores, the probabilities cast to q's
    dtype, an f32 PV product cast to q's dtype. The backward's
    whole-tensor VJP differentiates this."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[None, None]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _chunked_bwd(q, k, v, bias, scale: float, g, chunk: int, need_db: bool):
    """Flash-style backward over query chunks, recomputing scores and
    probabilities: the peak transient is (B, H, chunk, Lk) f32. A ragged
    last chunk is shorter (the JAX package pads it with zero rows, whose
    cotangent is zero: the same sums). Returns
    (dq, dk, dv, dbias) in the inputs' dtypes, dbias summed over (B, H)."""
    B, Lq, H, hd = q.shape
    k32, v32 = k.float(), v.float()
    dk = torch.zeros(k32.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty((B, Lq, H, hd), dtype=torch.float32, device=q.device)
    db = (torch.empty(bias.shape, dtype=torch.float32, device=q.device)
          if need_db else None)
    for c0 in range(0, Lq, chunk):
        c1 = min(c0 + chunk, Lq)
        q_c, g_c = q[:, c0:c1].float(), g[:, c0:c1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q_c, k32) * scale
        if bias is not None:
            s = s + bias[c0:c1].float()[None, None]
        m = s.amax(dim=-1, keepdim=True).clamp(min=-1e30)
        e = torch.exp(s - m)
        p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, g_c)
        dp = torch.einsum("bqhd,bkhd->bhqk", g_c, v32)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, c0:c1] = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, q_c) * scale
        if need_db:
            db[c0:c1] = ds.sum(dim=(0, 1))
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            db.to(bias.dtype) if need_db else None)


class AttentionFn(torch.autograd.Function):
    """Float-KV attention with the JAX package's backward. q (B, Lq, H, hd),
    k/v (B, Lk, H, hd), bias (Lq, Lk) f32 or None. Forward: the CUDA kernel
    (one ``attention_kernel.launches`` a call) or, on the CPU, its plain
    version. Backward: ``attention_composition``'s VJP, or
    ``_chunked_bwd`` (``bwd_chunk_for``); its products are PyTorch's, as
    the JAX package's are XLA's. dbias only where the bias needs one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        fn = attention_kernel if _kernel_for(q) else attention_plain
        return fn(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        need_db = bias is not None and ctx.needs_input_grad[3]
        chunk = bwd_chunk_for(q.shape[1], k.shape[1])
        if chunk:
            dq, dk, dv, db = _chunked_bwd(q, k, v, bias, ctx.scale, g, chunk,
                                          need_db)
            return dq, dk, dv, db, None
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            b = bias.detach().requires_grad_() if need_db else bias
            out = attention_composition(*leaves, b, ctx.scale)
            grads = torch.autograd.grad(
                out, leaves + ([b] if need_db else []), g)
        return (*grads[:3], grads[3] if need_db else None, None)


def attention_cache(q, cache_k, cache_v, li: int, kv_len: int,
                    bias: Optional[torch.Tensor], scale: float,
                    cache_scales=None) -> torch.Tensor:
    """Attention over keys [0, kv_len) of layer ``li`` of the stacked cache
    (depth, B, L_max, H*hd), read in place; ``cache_scales``: the
    (depth, B, L_max) scale planes of an int8 cache."""
    fn = attention_cache_kernel if _kernel_for(q) else attention_cache_plain
    return fn(q, cache_k, cache_v, li, kv_len, bias, scale, cache_scales)


def attention_cache_write(q, k_new, v_new, cache_k, cache_v, li: int,
                          cache_begin: int, kv_len: int,
                          bias: Optional[torch.Tensor], scale: float,
                          new_scales=None, cache_scales=None) -> torch.Tensor:
    """Write k_new/v_new (B, Lq, H, hd) into layer ``li`` of the cache at
    [cache_begin, kv_len) (int8 rows with their (B, Lq) ``new_scales``),
    then attend over [0, kv_len); kv_len must be cache_begin + Lq."""
    fn = (attention_cache_write_kernel if _kernel_for(q)
          else attention_cache_write_plain)
    return fn(q, k_new, v_new, cache_k, cache_v, li, cache_begin, kv_len,
              bias, scale, new_scales, cache_scales)
