"""Fused top-k / top-p / Gumbel-max sampler: the CUDA kernel's wrapper, its
launch geometry and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/sampling.py:_kernel``
(reached through ``fused_sample``) with its per-row-seed noise. Same
semantics, bit for bit where integer arithmetic decides:

  - the top-k threshold is the largest t with count(u >= t) >= k on the
    ordered int32 image u of the f32 bits, i.e. the k-th largest u; ties at
    the threshold are kept;
  - the nucleus threshold over the kept set is the largest t with
    mass(u > t) >= top_p * Z; the argmax is always kept;
  - Gumbel noise is -log(-log(u01)) with u01 = b24 * 2^-24 + 2^-25 from the
    murmur3 row hash of (row seed, column), or an explicit ``noise`` input.

The plain version finds both thresholds by 32-step bisection, as the TPU
kernel does. The kernel (``sdvar_tpu_torch/csrc/sampler.cu``, CUDA C++ for
sm_90a, loaded with ctypes) finds the same values with one block a row,
the row in shared memory (a row wider than ``SMEM_V`` stays in device
memory, and its nucleus skips the columns below the top-k threshold
instead of setting the kept ones aside): 2048 bins linear in x over the participants'
range (``LINEAR_BINS``: 32 coarse bins, top-k's counted in per-thread byte
counters, the nucleus's masses by integer atomics; then the chosen coarse
bin's 64 fine bins), a warp scan for the bin where the weight from the top
reaches the target, then an exact ranking of that bin's few elements by
their ordered keys (a crowded bin: ``RADIX_DIGITS`` radix passes). For
top-k the weight is 1 and the target k, so the mask is bit-equal to the
plain version's. The nucleus runs over the kept columns, set aside: the
weight of a column is exp(x - max) as an integer with :func:`mass_bits`
fractional bits and the target ceil(top_p * sum); the sums are exact
integers in no order (the same bits every run), where the plain version
sums in f32, so a row whose mass lands within an f32 step of the threshold
may differ. The noise is drawn only for the kept columns.

Bound on this card: one read of the (M, V) f32 logits (67 MB at the 256px
scale-9 shape M = V = 4096, 0.020 ms at 3.35 TB/s); the function needs a
few integer operations a logit for the top-k threshold and about 25 a kept
logit for the rest, so memory bounds it. Geometry: :func:`sampler_plan`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sdvar_tpu_torch.ops.kernels import _build

LINEAR_BINS = (32, 64)       # the select's coarse bins and fine bins in each
CANDIDATES = 128             # a fine bin of at most this many is ranked directly
RADIX_DIGITS = (8, 8, 8, 8)  # a crowded bin's radix passes, MSB first
MASS_BITS = 50               # fixed-point fraction bits of the nucleus masses
SMEM_V = 8192                # the widest row the kernel holds in shared memory
COUNT_CHUNKS = 63            # chunks a thread counts between byte-counter sums
MAX_THREADS = 256

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


def sampler_takes(V: int) -> bool:
    """Whether the kernel takes rows of width V: a multiple of 4 (the row
    is read in 16-byte chunks), every width the TPU kernel takes (a
    multiple of 128) among them. ``ops.partition.sharded_fused_sample``
    routes other widths to :func:`sample_plain`."""
    return V >= 4 and V % 4 == 0


def mass_bits(V: int) -> int:
    """The nucleus masses' fixed-point fraction bits at width V:
    ``MASS_BITS``, fewer where V masses of at most 2^bits could reach 2^63
    (V > 8192)."""
    return min(MASS_BITS, 63 - (V - 1).bit_length())


@functools.lru_cache(maxsize=1024)
def sampler_plan(M: int, V: int) -> dict:
    """The kernel's launch geometry: one block a row (``grid`` = M) of
    ``threads`` (a power of two, 32-256: one 16-byte chunk of the row a
    thread up to 256 threads, further chunks threads apart; top-k's byte
    counters are summed every ``COUNT_CHUNKS`` chunks) and the dynamic
    shared memory: the row and the columns top-k keeps (4V bytes each, none
    for a row wider than ``SMEM_V``; or top-k's byte counters, 32 rows of
    threads + 4, if more), the fallback's radix histogram (2^8 bins and one
    pad slot a thread, 8 bytes each), the ranked candidates (key and
    weight) and the coarse bins' per-warp weights. Raises on a row the
    kernel does not take: V % 4 != 0."""
    if not sampler_takes(V):
        raise ValueError(f"sampler kernel: V={V} must be a multiple of 4")
    if M < 1 or M > 2 ** 31 - 1:
        raise ValueError(f"sampler kernel: M={M} rows")
    vec = V // 4
    threads = min(MAX_THREADS, max(32, 1 << (vec - 1).bit_length()))
    row = 4 * V if V <= SMEM_V else 0
    kept = max(row, LINEAR_BINS[0] * (threads + 4))  # or top-k's counters
    smem = (row + kept + ((1 << RADIX_DIGITS[0]) + threads) * 8
            + CANDIDATES * (4 + 8) + threads // 32 * LINEAR_BINS[0] * 8)
    return {"grid": M, "threads": threads, "smem_bytes": smem}


@functools.lru_cache(maxsize=1)
def _lib():
    fn = _build.load("sampler").sdvar_sample
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, ctypes.c_longlong, I, I, ctypes.c_float, I, P]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(V: int, threads: int) -> int:
    """The dynamic shared memory the CUDA source gives a launch (to hold
    :func:`sampler_plan` to it)."""
    fn = _build.load("sampler").sdvar_sample_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(V, threads)


def _aligned(t: torch.Tensor, what: str) -> torch.Tensor:
    """t, contiguous; raise unless its base is 16-byte aligned."""
    if not t.is_contiguous():
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"sample_kernel: {what} must be 16-byte aligned")
    return t


def sample_kernel(logits: torch.Tensor, row_seeds: Optional[torch.Tensor],
                  top_k: int = 0, top_p: float = 0.0,
                  noise: Optional[torch.Tensor] = None,
                  return_mask: bool = False):
    """Launch the CUDA kernel on CUDA tensors; same contract as
    :func:`sample_plain`. Raises on anything it does not take (it never
    falls back to the plain version). Adds one to
    ``sample_kernel.launches`` per launch. The host path is kept short: at
    the decode's first scales the launch, not the card, sets the pace."""
    if not logits.is_cuda:
        raise ValueError("sample_kernel: logits must be a CUDA tensor")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError("sample_kernel: logits must be (M, V) float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    M, V = logits.shape
    plan = sampler_plan(M, V)
    logits = _aligned(logits, "logits")
    device = logits.device
    seeds_ptr = noise_ptr = None
    if noise is not None:
        if noise.shape != logits.shape or noise.device != device:
            raise ValueError("sample_kernel: noise must match logits")
        noise = _aligned(noise.float(), "noise")
        noise_ptr = noise.data_ptr()
    else:
        if (row_seeds is None or row_seeds.shape != (M,)
                or row_seeds.dtype != torch.int32
                or row_seeds.device != device):
            raise ValueError("sample_kernel: row_seeds must be (M,) int32 on "
                             "the logits' device")
        if not row_seeds.is_contiguous():
            row_seeds = row_seeds.contiguous()
        seeds_ptr = row_seeds.data_ptr()
    ids = torch.empty((M,), dtype=torch.int32, device=device)
    mask = (torch.empty((M, V), dtype=torch.int8, device=device)
            if return_mask else None)
    err = _lib()(logits.data_ptr(), seeds_ptr, noise_ptr, ids.data_ptr(),
                 None if mask is None else mask.data_ptr(), M, V, int(top_k),
                 float(top_p), plan["threads"],
                 torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"sample_kernel: launch failed with cudaError {err}")
    sample_kernel.launches += 1
    if return_mask:
        return ids, mask
    return ids


sample_kernel.launches = 0
sample_kernel.plain_rows = 0  # rows of widths the kernel does not take
