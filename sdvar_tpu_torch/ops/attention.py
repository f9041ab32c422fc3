"""Attention dispatch: CUDA tensors go to the hand-written kernels, CPU
tensors to their plain PyTorch versions.

The JAX package picks between XLA and Pallas by backend and query size
(a VMEM/grid tuning gate); the port has one kernel for every size, so the
only choice left is the device the tensors lie on.

The cache-kernel switch (``set_cache_kernel``, the JAX package's switch of
``sdvar_tpu/ops/attention.py:31-50``, off by default as there) routes every
KV-cached attention of ``models.var`` through ``attention_cache_write``: one
call writes the layer's new keys and values into the cache and attends. The
JAX switch also demands a TPU backend; this one works on both devices (on
the CPU through the plain versions), so the CPU tests cover the switched
path.
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
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale, kv_token_major, kv_scales)
    return attention_kernel(q, k, v, bias, scale, kv_token_major, kv_scales)


def attention_cache(q, cache_k, cache_v, li: int, kv_len: int,
                    bias: Optional[torch.Tensor], scale: float,
                    cache_scales=None) -> torch.Tensor:
    """Attention over keys [0, kv_len) of layer ``li`` of the stacked cache
    (depth, B, L_max, H*hd), read in place; ``cache_scales``: the
    (depth, B, L_max) scale planes of an int8 cache."""
    fn = attention_cache_plain if q.device.type == "cpu" else attention_cache_kernel
    return fn(q, cache_k, cache_v, li, kv_len, bias, scale, cache_scales)


def attention_cache_write(q, k_new, v_new, cache_k, cache_v, li: int,
                          cache_begin: int, kv_len: int,
                          bias: Optional[torch.Tensor], scale: float,
                          new_scales=None, cache_scales=None) -> torch.Tensor:
    """Write k_new/v_new (B, Lq, H, hd) into layer ``li`` of the cache at
    [cache_begin, kv_len) (int8 rows with their (B, Lq) ``new_scales``),
    then attend over [0, kv_len); kv_len must be cache_begin + Lq."""
    fn = (attention_cache_write_plain if q.device.type == "cpu"
          else attention_cache_write_kernel)
    return fn(q, k_new, v_new, cache_k, cache_v, li, cache_begin, kv_len,
              bias, scale, new_scales, cache_scales)
