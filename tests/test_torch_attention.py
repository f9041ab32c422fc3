"""Port attention (plain versions, the CPU path) against the JAX package's
Pallas kernels in interpret mode: batch-major and token-major K/V, with and
without an additive bias holding -inf entries and a fully masked row; and
the full-cache and cache-write forms against ``ops/pallas/experimental.py``
(the JAX token-major caches permuted to the port's batch-major layout)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdvar_tpu.ops.pallas.attention import pallas_attention
from sdvar_tpu.ops.pallas.experimental import (
    pallas_attention_cache,
    pallas_attention_cache_write,
)
from sdvar_tpu.ops.quantization import quantize_tokens as j_quantize_tokens
from sdvar_tpu_torch.ops.attention import (
    attention,
    attention_cache,
    attention_cache_write,
)
from sdvar_tpu_torch.ops.kernels.attention import KEY_TILE, attention_plain

B, H, HD = 2, 2, 64  # H*hd a multiple of 128, so the Pallas kernel really runs


def _inputs(Lq, Lk, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, Lk, H, HD)).astype(np.float32)
    v = rng.standard_normal((B, Lk, H, HD)).astype(np.float32)
    bias = None
    if with_bias:
        bias = rng.standard_normal((Lq, Lk)).astype(np.float32)
        bias[:, ::3] = -np.inf          # scattered masked keys
        bias[-1, :] = -np.inf           # one fully masked row
    return q, k, v, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("token_major", [False, True])
@pytest.mark.parametrize("Lq,Lk", [(1, 1), (4, 5), (9, 14), (16, 30)])
def test_plain_matches_pallas(Lq, Lk, token_major, with_bias):
    q, k, v, bias = _inputs(Lq, Lk, with_bias)
    if token_major:
        k, v = k.transpose(1, 0, 2, 3).copy(), v.transpose(1, 0, 2, 3).copy()
    scale = 0.125
    want = np.asarray(pallas_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), scale, interpret=True,
        kv_token_major=token_major))
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    None if bias is None else torch.from_numpy(bias), scale,
                    kv_token_major=token_major).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if with_bias:  # the fully masked row gives zeros, not NaN
        assert not got[:, -1].any()


def test_strided_views_match_contiguous():
    """q/k/v as views of a fused qkv projection and of a batch-major cache
    slice give the same result as contiguous copies."""
    rng = np.random.default_rng(1)
    Lq, Lk, Lmax = 9, 14, 20
    qkv = torch.from_numpy(
        rng.standard_normal((B, Lq, 3, H, HD)).astype(np.float32))
    q = qkv.unbind(2)[0]
    cache = torch.from_numpy(
        rng.standard_normal((B, Lmax, H * HD)).astype(np.float32))
    k = cache[:, :Lk].view(B, Lk, H, HD)
    v = (cache[:, :Lk] * 0.5).view(B, Lk, H, HD)
    got = attention(q, k, v, None, 1.0)
    want = attention(q.contiguous(), k.contiguous(), v.contiguous(), None, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _int8_inputs(Lq, Lk, with_bias, seed):
    """int8 token-major k/v, per-token scales (Lk, B) log-uniform in
    [1e-3, 1e2], far from 1 so that folding the value scale into p before
    or after l is summed gives different results."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, HD)).astype(np.float32) * 1e-3
    k = rng.integers(-127, 128, (Lk, B, H, HD), dtype=np.int8)
    v = rng.integers(-127, 128, (Lk, B, H, HD), dtype=np.int8)
    ks, vs = (np.exp(rng.uniform(np.log(1e-3), np.log(1e2), (Lk, B))
                     ).astype(np.float32) for _ in range(2))
    bias = None
    if with_bias:
        bias = rng.standard_normal((Lq, Lk)).astype(np.float32)
        bias[:, ::3] = -np.inf
        bias[-1, :] = -np.inf
    return q, k, v, ks, vs, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("Lq,Lk", [(1, 1), (4, 5), (9, 14), (16, 30)])
def test_int8_kv_plain_matches_pallas(Lq, Lk, with_bias):
    """INT8-KV branch: the plain version against the Pallas kernel in
    interpret mode on token-major int8 K/V with per-token scales. Both
    compute the kernel's order in f32 (rtol 1e-5; outputs reach ~1e4)."""
    q, k, v, ks, vs, bias = _int8_inputs(Lq, Lk, with_bias, Lq + Lk)
    scale = 0.125
    jb = None if bias is None else jnp.asarray(bias)
    want = np.asarray(pallas_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, scale,
        interpret=True, kv_token_major=True,
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs))))
    tb = None if bias is None else torch.from_numpy(bias)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), tb, scale, kv_token_major=True,
                    kv_scales=(torch.from_numpy(ks), torch.from_numpy(vs))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if with_bias:
        assert not got[:, -1].any()
    # the batch-major cache layout with (B, Lk) scale planes gives the same
    bm = attention(torch.from_numpy(q), torch.from_numpy(k).transpose(0, 1),
                   torch.from_numpy(v).transpose(0, 1), tb, scale,
                   kv_scales=(torch.from_numpy(ks).t(), torch.from_numpy(vs).t()))
    np.testing.assert_array_equal(bm.numpy(), got)


def test_int8_kv_equals_dequantised_float_attention():
    """In f32 the fused order computes the same function as attention over
    the dequantised cache (only where the scales multiply differs)."""
    q, k, v, ks, vs, _ = _int8_inputs(9, 14, False, 3)
    qt = torch.from_numpy(q)
    kd = torch.from_numpy(k).float() * torch.from_numpy(ks)[..., None, None]
    vd = torch.from_numpy(v).float() * torch.from_numpy(vs)[..., None, None]
    want = attention(qt, kd, vd, None, 1.0, kv_token_major=True)
    got = attention(qt, torch.from_numpy(k), torch.from_numpy(v), None, 1.0,
                    kv_token_major=True,
                    kv_scales=(torch.from_numpy(ks), torch.from_numpy(vs)))
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("Lk", [1216, 2240, 5355, 9451])
def test_highres_row1_limit_sees_a_dropped_key_tile(Lk):
    """The card's high-resolution check of kernel row 1 (``chip_smoke.py``
    and ``test_torch_highres_kernels.py``: unit keys, q four times a unit
    vector, bf16) holds the kernel within one bf16 step at the largest
    output, 2^-7 of it. At the 512px and 1024px key lengths the plain
    version without the last ring tile of keys (Lk mod 64 keys, or 64)
    falls outside that limit, on a few heads and query rows."""
    rng = np.random.default_rng(Lk)

    def unit(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return torch.nn.functional.normalize(x, dim=-1)

    q = (unit(1, 64, 4, 64) * 4).to(torch.bfloat16)
    k = unit(1, Lk, 4, 64).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((1, Lk, 4, 64))
                         .astype(np.float32)).to(torch.bfloat16)
    want = attention_plain(q, k, v, None, 1.0).float()
    full = Lk - (Lk % KEY_TILE or KEY_TILE)
    drop = attention_plain(q, k[:, :full], v[:, :full], None, 1.0).float()
    assert (drop - want).abs().max() > 2 ** -7 * want.abs().max()


def test_d36_train_row1_limit_sees_a_dropped_key_tile():
    """The card's check of kernel row 1 at the d36-512 training shape
    (``chip_smoke.py``: q and k four times unit vectors, bf16, the 512px
    block-causal bias, L=2240) holds the forward within 2^-7 of the
    largest output of ``attention_plain`` in f32. The plain version
    without the last ring tile of keys and their bias columns falls
    outside that limit (here on 4 heads; the card runs 36)."""
    from sdvar_tpu_torch.config import PATCH_NUMS_512
    from sdvar_tpu_torch.ops.masks import block_causal_prefix

    L = 2240
    bias = torch.from_numpy(block_causal_prefix(PATCH_NUMS_512, L))
    rng = np.random.default_rng(36)
    qkv = torch.from_numpy(rng.standard_normal((1, L, 3, 4, 64)).astype(np.float32))
    qkv[:, :, :2] = torch.nn.functional.normalize(qkv[:, :, :2], dim=-1) * 4
    q, k, v = qkv.to(torch.bfloat16).float().unbind(2)
    want = attention_plain(q, k, v, bias, 1.0)
    full = L - (L % KEY_TILE or KEY_TILE)
    drop = attention_plain(q, k[:, :full], v[:, :full], bias[:, :full], 1.0)
    assert (drop - want).abs().max() > 2 ** -7 * want.abs().max()


DEPTH, LMAX, LI = 3, 48, 1
C = H * HD


def _tm_cache(rng, int8):
    """A JAX token-major (depth, L_max, B, C) K and V cache, and, int8, its
    (depth, B, L_max) scale planes (quantized by the JAX package)."""
    k, v = (rng.standard_normal((DEPTH, LMAX, B, C)).astype(np.float32)
            for _ in range(2))
    if not int8:
        return k, v, None
    (kq, ks), (vq, vs) = (j_quantize_tokens(jnp.asarray(t)) for t in (k, v))
    return (np.asarray(kq), np.asarray(vq),
            tuple(np.ascontiguousarray(np.asarray(t).transpose(0, 2, 1))
                  for t in (ks, vs)))


def _bm(cache_tm):
    """Token-major (depth, L_max, B, C) -> the port's (depth, B, L_max, C)."""
    return torch.from_numpy(np.ascontiguousarray(cache_tm.transpose(0, 2, 1, 3)))


def _mask_bias(Lq, Lk):
    return np.where(np.random.default_rng(9).random((Lq, Lk)) < 0.3,
                    -np.inf, 0.0).astype(np.float32)


@pytest.mark.parametrize("kv_len,Lq,int8,with_bias", [
    (14, 9, False, False), (30, 16, False, True),
    (29, 8, True, False), (40, 8, True, True)])
def test_cache_plain_matches_pallas(kv_len, Lq, int8, with_bias):
    """``attention_cache`` on the CPU against ``pallas_attention_cache``
    (the JAX tests' cases), within the JAX tests' 1e-4."""
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((B, Lq, H, HD)).astype(np.float32)
    ck, cv, cs = _tm_cache(rng, int8)
    bias = _mask_bias(Lq, kv_len) if with_bias else None
    want = np.asarray(pallas_attention_cache(
        jnp.asarray(q), jnp.asarray(ck).reshape(DEPTH, LMAX, B, H, HD),
        jnp.asarray(cv).reshape(DEPTH, LMAX, B, H, HD),
        jnp.asarray(LI, jnp.int32), kv_len,
        None if bias is None else jnp.asarray(bias), 0.125,
        kv_scales=None if cs is None else tuple(jnp.asarray(t) for t in cs),
        interpret=True))
    got = attention_cache(
        torch.from_numpy(q), _bm(ck), _bm(cv), LI, kv_len,
        None if bias is None else torch.from_numpy(bias), 0.125,
        None if cs is None else tuple(torch.from_numpy(t) for t in cs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bg,Lq,kv_len,int8,with_bias", [
    (5, 9, 14, False, False), (14, 16, 30, False, True),
    (21, 8, 29, True, False), (0, 8, 8, True, True)])
def test_cache_write_plain_matches_pallas(bg, Lq, kv_len, int8, with_bias):
    """``attention_cache_write`` on the CPU against
    ``pallas_attention_cache_write`` (the JAX tests' cases): the output
    within 1e-4, the written caches and scale planes exactly equal."""
    rng = np.random.default_rng(bg + 100)
    q = rng.standard_normal((B, Lq, H, HD)).astype(np.float32)
    ck, cv, cs = _tm_cache(rng, int8)
    knew, vnew = (rng.standard_normal((Lq, B, C)).astype(np.float32)
                  for _ in range(2))
    ns = None
    if int8:
        (kq, ks), (vq, vs) = (j_quantize_tokens(jnp.asarray(t))
                              for t in (knew, vnew))
        knew, vnew = np.asarray(kq), np.asarray(vq)
        ns = (np.asarray(ks).T.copy(), np.asarray(vs).T.copy())  # (B, Lq)
    bias = _mask_bias(Lq, kv_len) if with_bias else None
    res = pallas_attention_cache_write(
        jnp.asarray(q), jnp.asarray(knew), jnp.asarray(vnew),
        jnp.asarray(ck).reshape(DEPTH, LMAX, B, H, HD),
        jnp.asarray(cv).reshape(DEPTH, LMAX, B, H, HD),
        jnp.asarray(LI, jnp.int32), bg, kv_len,
        None if bias is None else jnp.asarray(bias), 0.125,
        new_scales=None if ns is None else tuple(jnp.asarray(t) for t in ns),
        cache_scales=None if cs is None else tuple(jnp.asarray(t) for t in cs),
        interpret=True)
    tk, tv = _bm(ck), _bm(cv)
    ts = None if cs is None else tuple(torch.from_numpy(t) for t in cs)
    as_new = lambda t: torch.from_numpy(
        np.ascontiguousarray(t.transpose(1, 0, 2))).view(B, Lq, H, HD)
    got = attention_cache_write(
        torch.from_numpy(q), as_new(knew), as_new(vnew), tk, tv, LI, bg,
        kv_len, None if bias is None else torch.from_numpy(bias), 0.125,
        None if ns is None else tuple(torch.from_numpy(t) for t in ns), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(res[0]), rtol=1e-4,
                               atol=1e-4)
    for port, jax_out in zip((tk, tv), res[1:3]):
        np.testing.assert_array_equal(
            port.numpy(), np.asarray(jax_out).reshape(DEPTH, LMAX, B, C)
            .transpose(0, 2, 1, 3))
    if int8:
        for port, jax_out in zip(ts, res[3:]):
            np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out))
