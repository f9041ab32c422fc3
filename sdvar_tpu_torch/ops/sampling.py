"""Top-k / top-p sampling through the fused sampler, CFG batch helpers and
per-request seed streams (``request_seeds``, ``fold_seeds``, ``row_seeds``).

Sampling always goes through the fused sampler (CUDA kernel on the card,
its plain version on the CPU) with one seed per row. A row's seed depends
only on (request seed, scale, position within the scale), the counterpart
of the JAX package's ``fold_key(key, si)`` + ``_row_seeds_from_keys``: a
request's tokens do not depend on its batch slot, nor on how the scale
loop is driven.

CFG rows use the ``[cond ‖ uncond]`` layout. Under a mesh each data rank
holds its own requests' rows, ``[cond_r ‖ uncond_r]``: block r of the JAX
package's shard-local CFG layout, a row permutation that leaves each
request's bits as they are; a rank computes the whole batch's request
seeds and takes its slice (``engine/decode.py``), so a request's stream
hashes its global slot.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from sdvar_tpu_torch.ops.kernels.sampling import fmix32, mul32
from sdvar_tpu_torch.ops.partition import sharded_fused_sample

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_STREAM = 0x7F4A7C15  # keeps fold_seeds' constants apart from row_seeds'


def request_seeds(seed: Union[int, Sequence[int], torch.Tensor], batch: int,
                  device) -> torch.Tensor:
    """(B,) int64 request seeds in [0, 2^32). An int seeds the whole batch
    (request b gets a hash of (seed, b)); a sequence or tensor gives one
    seed per request."""
    if isinstance(seed, int):
        b = torch.arange(batch, dtype=torch.int64, device=device)
        base = fmix32(torch.tensor(seed & _MASK32, dtype=torch.int64,
                                   device=device))
        return fmix32(base ^ mul32(b, _GOLDEN))
    s = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(-1)
    if s.shape[0] != batch:
        raise ValueError(f"need {batch} request seeds, got {s.shape[0]}")
    return s & _MASK32


def fold_seeds(req_seeds: torch.Tensor, data: int) -> torch.Tensor:
    """(B,) request seeds -> (B,) request seeds of the sub-stream ``data``
    (a non-negative int): a pure function of (seed, data), the counterpart
    of the JAX package's ``fold_key`` for per-request streams. The
    speculative engine folds its draft and target streams out of a
    request's seed this way."""
    return fmix32(req_seeds ^ fmix32((data * _GOLDEN + _STREAM) & _MASK32))


def row_seeds(req_seeds: torch.Tensor, si: int, l: int) -> torch.Tensor:
    """(B,) request seeds -> (B*l,) int32 seeds for scale ``si`` with ``l``
    tokens: fold the scale into each request's stream, then XOR the
    position times the golden ratio (as ``_row_seeds_from_keys`` does)."""
    s = fmix32(req_seeds ^ (((si + 1) * _GOLDEN) & _MASK32))
    pos = mul32(torch.arange(l, dtype=torch.int64, device=req_seeds.device),
                _GOLDEN)
    rows = (s[:, None] ^ pos[None, :]).reshape(-1)
    return torch.where(rows >= 2 ** 31, rows - 2 ** 32, rows).to(torch.int32)


def sample_with_top_k_top_p(logits_BlV: torch.Tensor, seeds: torch.Tensor,
                            top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Sample (B, l) int32 ids from (B, l, V) logits with top-k / top-p
    filtering and Gumbel-max; ``seeds`` holds one int32 seed per row
    (B*l,), see :func:`row_seeds`. Through the fused sampler
    (``ops.partition.sharded_fused_sample``: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors); under a mesh the logits
    are this rank's rows and vocab columns, gathered over "model" first."""
    B, l, V = logits_BlV.shape
    ids = sharded_fused_sample(logits_BlV.float().reshape(B * l, V), seeds,
                               top_k, top_p)
    return ids.reshape(B, l)


def greedy(logits_BlV: torch.Tensor) -> torch.Tensor:
    return logits_BlV.argmax(-1).to(torch.int32)


def cfg_pair(cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
    """Stack cond/uncond (B, ...) rows into the (2B, ...) CFG batch."""
    if cond.shape != uncond.shape:
        raise ValueError(f"cfg_pair: {tuple(cond.shape)} vs {tuple(uncond.shape)}")
    return torch.cat([cond, uncond], dim=0)


def cfg_double(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (2B, ...): the shared input repeated for cond and uncond."""
    return cfg_pair(x, x)


def cfg_halves(y: torch.Tensor):
    """(2B, ...) -> (cond (B, ...), uncond (B, ...)); inverse of cfg_pair."""
    B = y.shape[0] // 2
    return y[:B], y[B:]


def cfg_mix(logits_2BlV: torch.Tensor, t) -> torch.Tensor:
    """Classifier-free guidance over a doubled batch: (1+t)*cond - t*uncond.
    ``t`` is a scalar or a per-token (l,) vector."""
    cond, uncond = cfg_halves(logits_2BlV)
    if isinstance(t, torch.Tensor) and t.dim() == 1:
        t = t[None, :, None]
    return (1.0 + t) * cond - t * uncond
