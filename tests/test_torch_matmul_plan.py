"""The INT8-weight matmul's launch geometry (``matmul_plan``) and its exact
three-piece bf16 split (``split_bf16x3``), on the CPU.

The plan is held at every shape the VAR-d30 decodes launch: the ``w8``
decode's block GEMMs at B=16 (M = 32 pn^2 over the ten scales, (K, N) of
qkv, proj, fc1 and fc2) and its f32 head, the W8A8 head at B=32 (M doubled)
and the 1x2 mesh rank's head (N = 2048). The split is held on f32 data
across the exponent range: the pieces add back to x bit for bit, and the
f64 sum of the pieces' products with int8 weights equals the f64 product.
"""

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.ops.kernels.matmul_int8 import (
    BLOCK_K,
    MAX_SMEM,
    SMS,
    TILES,
    _cost,
    _smem_bytes,
    matmul_plan,
    split_bf16x3,
)

PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
BF16, F32 = torch.bfloat16, torch.float32
BLOCK_GEMMS = ((1920, 5760), (1920, 1920), (1920, 7680), (7680, 1920))
CASES = ([(f"w8 B=16 s{i} K={K} N={N}", 32 * pn * pn, K, N, BF16)
          for i, pn in enumerate(PNS) for K, N in BLOCK_GEMMS]
         + [(f"head B=16 s{i}", 32 * pn * pn, 1920, 4096, F32)
            for i, pn in enumerate(PNS)]
         + [(f"head B=32 s{i}", 64 * pn * pn, 1920, 4096, F32)
            for i, pn in enumerate(PNS)]
         + [(f"head 1x2 s{i}", 32 * pn * pn, 1920, 2048, F32)
            for i, pn in enumerate(PNS)])


@pytest.mark.parametrize("tag,M,K,N,dtype", CASES, ids=[c[0] for c in CASES])
def test_matmul_plan_geometry(tag, M, K, N, dtype):
    plan = matmul_plan(M, N, K, dtype)
    wg, bn, bm = plan["warpgroups"], plan["block_n"], plan["block_m"]
    sp = plan["splits"]
    gx, gy, gz = plan["grid"]
    assert (wg, bn) in TILES[dtype] and plan["stages"] in (3, 4)
    assert sp in (1, 2, 4, 8) and gz == sp
    assert bm == 64 * wg and plan["threads"] == 128 * wg
    assert plan["block_k"] == BLOCK_K == 64
    # every output tile once, no empty block; every split has K tiles
    assert gx * bn >= N > (gx - 1) * bn
    assert gy * bm >= M > (gy - 1) * bm
    assert gx <= 2 ** 31 - 1 and gy <= 65535
    assert -(-K // 64) >= 2 * sp
    assert plan["smem_bytes"] == _smem_bytes(dtype, wg, bn, plan["stages"])
    assert plan["smem_bytes"] <= MAX_SMEM
    if sp > 1:  # the partial tile fits in the ring it replaces
        assert bm * (bn + 4) * 4 <= plan["stages"] * (
            bm * 64 * (4 if dtype == F32 else 2) + 64 * bn)
    if dtype == F32:  # the head: width and split by M alone
        assert bn == (128 if M > 256 else 64) and sp == (4 if M <= 256 else 1)
    else:  # the cheapest tile and split; at scale 9 the widest, unsplit
        k_tiles = -(-K // 64)
        best = min(_cost(M, N, k_tiles, w, b, p) for w, b in TILES[dtype]
                   for p in (1, 2, 4, 8) if p == 1 or k_tiles >= 2 * p)
        assert _cost(M, N, k_tiles, wg, bn, sp) == best
        if M == 8192:
            assert (wg, bn, sp) == (2, 128, 1)
        if M == 32:  # scale 0: a block's latency bounds it, K is split
            assert sp > 1 and gx * gy * sp >= SMS // 2


@pytest.mark.parametrize("M", [32 * pn * pn for pn in PNS] + [64 * pn * pn for pn in PNS])
def test_matmul_plan_head_columns_follow_m_alone(M):
    """A 1x2 model rank's head (2048 of the 4096 vocab columns) runs on the
    tile width and split of K of the whole head, so each column's products
    are the unsharded ones, added in the same order."""
    half, whole = (matmul_plan(M, N, 1920, F32) for N in (2048, 4096))
    assert (half["block_n"], half["splits"]) == (whole["block_n"], whole["splits"])


@pytest.mark.parametrize("dtype,wg,bn,stages,want", [
    # 1 KiB slack + stages x (x tile + int8 tile) + two bf16 weight tiles
    (BF16, 2, 128, 4, 1024 + 4 * (16384 + 8192) + 2 * 16384),
    (BF16, 2, 128, 3, 1024 + 3 * (16384 + 8192) + 2 * 16384),
    (BF16, 1, 64, 4, 1024 + 4 * (8192 + 4096) + 2 * 8192),
    (F32, 2, 128, 3, 1024 + 3 * (32768 + 8192) + 2 * 16384),
    (F32, 1, 128, 4, 1024 + 4 * (16384 + 8192) + 2 * 16384)])
def test_matmul_plan_shared_memory(dtype, wg, bn, stages, want):
    plan = matmul_plan(8192, 4096, 1920, dtype, warpgroups=wg, block_n=bn,
                       stages=stages)
    assert plan["smem_bytes"] == want <= MAX_SMEM


@pytest.mark.parametrize("M,N,K,dtype,kw,msg", [
    (8, 4096, 1920, torch.float16, {}, "not supported"),
    (8, 4096, 1922, F32, {}, "multiple of 8"),
    (8, 4100, 1920, F32, {}, "multiple of 8"),
    (0, 4096, 1920, F32, {}, "no launch"),
    (8, 4096, 1920, BF16, {"stages": 2}, "no tile"),
    (8, 4096, 1920, F32, {"block_n": 256}, "no tile"),
    (8, 4096, 1920, F32, {"warpgroups": 2, "block_n": 64}, "no tile"),
    (8, 4096, 1920, BF16, {"warpgroups": 4}, "no tile"),
    (8, 4096, 1920, BF16, {"splits": 3}, "no tile"),
    (64 * 65536 + 1, 64, 64, BF16, {"warpgroups": 1}, "row blocks")])
def test_matmul_plan_refuses(M, N, K, dtype, kw, msg):
    with pytest.raises(ValueError, match=msg):
        matmul_plan(M, N, K, dtype, **kw)


def _wide_f32(rng, n):
    """f32 values with random signs and exponents from 2^-102 to 2^100,
    random 24-bit significands (and a few exact powers of two and values
    that round up to the next binade)."""
    x = (rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-102, 101, n))
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[:8] = np.float32(2.0) ** np.arange(-4, 4)
    x[8:16] = np.nextafter(np.float32(2.0) ** np.arange(-4, 4), np.float32(0))
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_bf16x3_rebuilds_x_bit_for_bit(seed):
    x = _wide_f32(np.random.default_rng(seed), 100_000)
    hi, mid, lo = split_bf16x3(torch.from_numpy(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, torch.from_numpy(x).to(torch.bfloat16))
    back = (hi.float() + mid.float()) + lo.float()
    assert np.array_equal(back.numpy().view(np.uint32), x.view(np.uint32))
    exact = hi.double() + mid.double() + lo.double()
    assert np.array_equal(exact.numpy(), x.astype(np.float64))
    # each piece is at most half an ulp of the one before
    big = hi.double().abs() > 0
    assert (mid.double().abs()[big] <= hi.double().abs()[big] * 2.0 ** -8).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16x3_products_are_exact(seed):
    """Piece by int8 products are exact in f32, and their f64 sum is the f64
    product x * q, elementwise across the exponent range and as a dot
    product over K = 1920 (x within 2^8 of each other in size, so every
    f64 partial sum is exact)."""
    rng = np.random.default_rng(seed)
    x = _wide_f32(rng, 50_000)
    q = rng.integers(-127, 128, x.size).astype(np.float64)
    hi, mid, lo = (p.double().numpy() for p in split_bf16x3(torch.from_numpy(x)))
    for piece in (hi, mid, lo):
        assert np.array_equal((piece.astype(np.float32) * q.astype(np.float32))
                              .astype(np.float64), piece * q)
    assert np.array_equal(hi * q + mid * q + lo * q, x.astype(np.float64) * q)

    xs = (rng.uniform(1.0, 2.0, (8, 1920)) * rng.choice([-1.0, 1.0], (8, 1920))
          * np.exp2(rng.integers(-4, 4, (8, 1920)))).astype(np.float32)
    qs = rng.integers(-127, 128, (1920, 16)).astype(np.float64)
    hi, mid, lo = (p.double().numpy() for p in split_bf16x3(torch.from_numpy(xs)))
    assert np.array_equal(hi @ qs + mid @ qs + lo @ qs, xs.astype(np.float64) @ qs)
