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
