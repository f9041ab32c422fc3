"""Fused top-k / top-p / Gumbel-max sampler: the Triton kernel's wrapper and
its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/sampling.py:_kernel``
(reached through ``fused_sample``) with its per-row-seed noise. Same
semantics, bit for bit where integer arithmetic decides:

  - the top-k threshold is the largest t with count(u >= t) >= k, found by
    32-step bisection on the ordered int32 image u of the f32 bits; ties at
    the threshold are kept;
  - the nucleus threshold over the kept set is the largest t with
    mass(u > t) >= top_p * Z, by the same bisection on exp-masses; the
    argmax is always kept;
  - Gumbel noise is -log(-log(u01)) with u01 = b24 * 2^-24 + 2^-25 from the
    murmur3 row hash of (row seed, column), or an explicit ``noise`` input.

Bound on this card: one read of the (M, V) f32 logits (67 MB at the
256px scale-9 shape M = V = 4096, ~20 us at 3.35 TB/s). The function
itself needs only a few operations per logit (a radix select finds the
same exact thresholds in a few passes, and the noise is needed only for
the kept set), so memory bounds it; the 64 bisection passes of this
kernel cost about 180 operations per logit and make it compute-bound in
practice. Design: one Triton program per row holds the whole 4096-wide row
in registers across all 64 passes, so the logits are read from device
memory once; the TPU's (bm, V) VMEM row blocks are not carried over.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

_MASK32 = 0xFFFFFFFF
_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), in 16-bit halves so that
    no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def rowhash_bits(row_seeds: torch.Tensor, V: int) -> torch.Tensor:
    """Per-row random bits, the murmur3 finalizer over (row seed, column):
    (M,) int32 -> (M, V) int64 in [0, 2^32). Equal, as uint32, to the JAX
    package's ``_rowhash_bits``."""
    seeds = row_seeds.to(torch.int64) & _MASK32
    col = torch.arange(V, dtype=torch.int64, device=row_seeds.device)
    return fmix32((seeds[:, None] + mul32(col, 0x9E3779B9)[None, :]) & _MASK32)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """24 random bits -> uniform in (0, 1) -> Gumbel noise, f32."""
    b24 = ((bits >> 8) & 0xFFFFFF).to(torch.float32)
    u01 = b24 * (2.0 ** -24) + 2.0 ** -25
    return -torch.log(-torch.log(u01))


def _bisect(pred, M: int, device) -> torch.Tensor:
    """Largest int32 t with pred(t) true per row (pred monotone: true at
    INT32_MIN). 32 steps of overflow-safe floor-average bisection."""
    lo = torch.full((M,), _INT32_MIN, dtype=torch.int32, device=device)
    hi = torch.full((M,), _INT32_MAX, dtype=torch.int32, device=device)
    for _ in range(32):
        mid = (lo & hi) + ((lo ^ hi) >> 1)
        ge = pred(mid[:, None])
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    return lo


def sample_plain(logits: torch.Tensor, row_seeds: Optional[torch.Tensor],
                 top_k: int = 0, top_p: float = 0.0,
                 noise: Optional[torch.Tensor] = None,
                 return_mask: bool = False):
    """(M, V) logits -> (M,) int32 ids (and the (M, V) int8 keep mask when
    ``return_mask``). ``noise``: explicit (M, V) Gumbel noise in place of
    the row hash of ``row_seeds``."""
    x = logits.float()
    M, V = x.shape
    i = x.view(torch.int32)
    u = torch.where(i >= 0, i, i ^ 0x7FFFFFFF)  # monotone ordered image
    keep = torch.ones_like(x, dtype=torch.bool)
    if 0 < top_k < V:
        lo = _bisect(lambda t: (u >= t).sum(-1) >= top_k, M, x.device)
        keep = u >= lo[:, None]
    if 0.0 < top_p < 1.0:
        m = torch.where(keep, x, torch.full_like(x, -1e30)).amax(-1, keepdim=True)
        e = torch.where(keep, torch.exp(x - m), torch.zeros_like(x))
        pZ = e.sum(-1) * torch.tensor(top_p, dtype=torch.float32)
        lo = _bisect(
            lambda t: torch.where(u > t, e, torch.zeros_like(e)).sum(-1) >= pZ,
            M, x.device)
        umax = u.amax(-1, keepdim=True)
        keep = keep & ((u > lo[:, None]) | (u == umax))
    g = noise.float() if noise is not None else gumbel_from_bits(
        rowhash_bits(row_seeds, V))
    score = torch.where(keep, x + g, torch.full_like(x, -1e30))
    ids = score.argmax(-1).to(torch.int32)
    if return_mask:
        return ids, keep.to(torch.int8)
    return ids


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
    def fused_sample_kernel(x_ptr, seed_ptr, noise_ptr, ids_ptr, mask_ptr,
                            V, top_k, top_p,
                            DO_TOPK: tl.constexpr, DO_TOPP: tl.constexpr,
                            HAS_NOISE: tl.constexpr, WRITE_MASK: tl.constexpr,
                            BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        valid = cols < V
        x = tl.load(x_ptr + row * V + cols, mask=valid, other=0.0)
        ib = x.to(tl.int32, bitcast=True)
        u = tl.where(ib >= 0, ib, ib ^ 0x7FFFFFFF)
        u = tl.where(valid, u, -2147483647 - 1)
        keep = valid
        if DO_TOPK:
            lo = tl.zeros([1], dtype=tl.int32) - 2147483647 - 1
            hi = tl.zeros([1], dtype=tl.int32) + 2147483647
            for _ in range(32):
                mid = (lo & hi) + ((lo ^ hi) >> 1)
                cnt = tl.sum(((u >= mid) & valid).to(tl.int32), axis=0)
                ge = cnt >= top_k
                lo = tl.where(ge, mid, lo)
                hi = tl.where(ge, hi, mid)
            keep = keep & (u >= lo)
        if DO_TOPP:
            m = tl.max(tl.where(keep, x, -1e30), axis=0)
            e = tl.where(keep, libdevice.exp(x - m), 0.0)
            pZ = top_p * tl.sum(e, axis=0)
            lo = tl.zeros([1], dtype=tl.int32) - 2147483647 - 1
            hi = tl.zeros([1], dtype=tl.int32) + 2147483647
            for _ in range(32):
                mid = (lo & hi) + ((lo ^ hi) >> 1)
                mass = tl.sum(tl.where(u > mid, e, 0.0), axis=0)
                ge = mass >= pZ
                lo = tl.where(ge, mid, lo)
                hi = tl.where(ge, hi, mid)
            umax = tl.max(u, axis=0)
            keep = keep & ((u > lo) | (u == umax))
        if WRITE_MASK:
            tl.store(mask_ptr + row * V + cols, keep.to(tl.int8), mask=valid)
        if HAS_NOISE:
            g = tl.load(noise_ptr + row * V + cols, mask=valid, other=0.0)
        else:
            seed = tl.load(seed_ptr + row).to(tl.uint32, bitcast=True)
            h = seed + cols.to(tl.uint32) * 0x9E3779B9
            h = h ^ (h >> 16)
            h = h * 0x85EBCA6B
            h = h ^ (h >> 13)
            h = h * 0xC2B2AE35
            h = h ^ (h >> 16)
            b24 = ((h >> 8) & 0xFFFFFF).to(tl.float32)
            u01 = b24 * 5.9604644775390625e-08 + 2.9802322387695312e-08
            g = -libdevice.log(-libdevice.log(u01))
        score = tl.where(keep, x + g, -1e30)
        tl.store(ids_ptr + row, tl.argmax(score, axis=0).to(tl.int32))

    return fused_sample_kernel


def sample_kernel(logits: torch.Tensor, row_seeds: Optional[torch.Tensor],
                  top_k: int = 0, top_p: float = 0.0,
                  noise: Optional[torch.Tensor] = None,
                  return_mask: bool = False):
    """Launch the Triton kernel on CUDA tensors; same contract as
    :func:`sample_plain`. Adds one to ``sample_kernel.launches`` per
    launch."""
    if not logits.is_cuda:
        raise ValueError("sample_kernel: logits must be a CUDA tensor")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError("sample_kernel: logits must be (M, V) float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    logits = logits.contiguous()
    M, V = logits.shape
    if noise is not None:
        if noise.shape != logits.shape or noise.device != logits.device:
            raise ValueError("sample_kernel: noise must match logits")
        noise = noise.float().contiguous()
        seeds = torch.empty((1,), dtype=torch.int32, device=logits.device)
    else:
        if (row_seeds is None or row_seeds.shape != (M,)
                or row_seeds.dtype != torch.int32
                or row_seeds.device != logits.device):
            raise ValueError("sample_kernel: row_seeds must be (M,) int32 on "
                             "the logits' device")
        seeds = row_seeds.contiguous()
    ids = torch.empty((M,), dtype=torch.int32, device=logits.device)
    mask = (torch.empty((M, V), dtype=torch.int8, device=logits.device)
            if return_mask else ids)
    block = 1 << max(V - 1, 1).bit_length()
    _triton_kernel()[(M,)](
        logits, seeds, noise if noise is not None else logits, ids, mask,
        V, int(top_k), float(top_p),
        DO_TOPK=0 < top_k < V, DO_TOPP=0.0 < top_p < 1.0,
        HAS_NOISE=noise is not None, WRITE_MASK=return_mask,
        BLOCK=block, num_warps=8,
    )
    sample_kernel.launches += 1
    if return_mask:
        return ids, mask
    return ids


sample_kernel.launches = 0
