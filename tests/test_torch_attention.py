"""Port attention (plain version, the CPU path) against the JAX package's
Pallas kernel in interpret mode: batch-major and token-major K/V, with and
without an additive bias holding -inf entries and a fully masked row."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdvar_tpu.ops.pallas.attention import pallas_attention
from sdvar_tpu_torch.ops.attention import attention

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
