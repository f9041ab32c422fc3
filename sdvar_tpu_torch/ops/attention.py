"""Attention dispatch: CUDA tensors go to the hand-written kernel, CPU
tensors to its plain PyTorch version.

The JAX package picks between XLA and Pallas by backend and query size
(a VMEM/grid tuning gate); the port has one kernel for every size, so the
only choice left is the device the tensors lie on.
"""

from __future__ import annotations

from typing import Optional

import torch

from sdvar_tpu_torch.ops.kernels.attention import attention_kernel, attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], scale: float,
              kv_token_major: bool = False) -> torch.Tensor:
    """q: (B, Lq, H, d); k/v: (B, Lk, H, d), or (Lk, B, H, d) when
    ``kv_token_major`` (the JAX package's cache layout); bias: (Lq, Lk)
    additive or None. Returns (B, Lq, H, d) in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale, kv_token_major)
    return attention_kernel(q, k, v, bias, scale, kv_token_major)
