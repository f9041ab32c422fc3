"""The JAX package's sampling helpers in the port, held against JAX through
bit-equal masks and JAX's own Gumbel noise handed to the port: ``mask_top_k``,
``mask_top_p``, the top-k-domain sampler, ``gumbel_softmax`` and the
``more_smooth`` scale embedding; and the decode at vocabularies the CUDA
sampler does not take (V = 8196 and 16384), which the CPU runs through the
same plain sampler the card routes them to."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.ops import sampling as JS
from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops import sampling as S
from sdvar_tpu_torch.ops.kernels.sampling import sampler_takes


def _logits(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3


@pytest.mark.parametrize("V,k", [(64, 1), (64, 5), (100, 63), (257, 40)])
def test_mask_top_k_equal(V, k):
    x = _logits((6, 7, V), V + k)
    got = S.mask_top_k(torch.from_numpy(x), k).numpy()
    want = np.asarray(JS.mask_top_k(jnp.asarray(x), k))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.3, 0.9, 0.96])
def test_mask_top_p_equal(p):
    x = _logits((20, 3, 96), int(p * 100))
    got = S.mask_top_p(torch.from_numpy(x), p).numpy()
    want = np.asarray(JS.mask_top_p(jnp.asarray(x), p))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum(-1).min() >= 1  # the largest is never removed


@pytest.mark.parametrize("k,p", [(8, 0.0), (8, 0.9), (50, 0.6)])
def test_top_k_domain_sampler_equal(k, p):
    """JAX's sort-based path (top_k > 0, a scalar key) against the port's
    with JAX's noise for the k-domain."""
    x = _logits((3, 9, 128), k)
    key = jax.random.PRNGKey(k)
    JS.set_sampler_impl("xla")
    try:
        want = np.asarray(JS.sample_with_top_k_top_p(jnp.asarray(x), key, k, p))
    finally:
        JS.set_sampler_impl("auto")
    noise = np.asarray(jax.random.gumbel(key, (3, 9, k), dtype=jnp.float32))
    got = S.sample_top_k_domain(torch.from_numpy(x), k, p,
                                torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_equal(hard):
    x = _logits((4, 5, 64), 3)
    key = jax.random.PRNGKey(11)
    want = np.asarray(JS.gumbel_softmax(jnp.asarray(x), key, tau=0.3, hard=hard))
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, x.shape,
                                                          dtype=jnp.float32)))
    got = S.gumbel_softmax(torch.from_numpy(x), noise, tau=0.3, hard=hard)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_more_smooth_embedding_equals_jax():
    """``scale_step``'s more_smooth branch: the codebook mixed by a
    Gumbel-softmax of the CFG'd logits times (1 + ratio), as the JAX decode
    computes it (same logits, JAX's noise)."""
    x = _logits((2, 9, 64), 5)
    codebook = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for ratio in (0.0, 0.5, 1.0):
        gum_t = max(0.27 * (1 - ratio * 0.95), 0.005)
        soft = JS.gumbel_softmax(jnp.asarray(x) * (1 + ratio), key, tau=gum_t)
        want = np.asarray(jnp.einsum("blv,vc->blc", soft, codebook))
        noise = np.asarray(jax.random.gumbel(key, x.shape, dtype=jnp.float32))
        got = D.smooth_embed(torch.from_numpy(x), ratio,
                             torch.from_numpy(codebook), torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _small(V):
    pns = (1, 2, 3)
    vc = VARConfig(depth=2, num_classes=10, patch_nums=pns, vocab_size=V,
                   Cvae=8, head_dim=32)
    qc = VQVAEConfig(vocab_size=V, z_channels=8, ch=32, patch_nums=pns)
    return (vc, qc, init_var_params(vc, seed=0, device="cpu"),
            init_vqvae_params(qc, seed=1, device="cpu", eini=1.0)["quant"])


def test_more_smooth_decode_runs():
    vc, qc, p, q = _small(64)
    outs = []
    for smooth in (False, True):
        samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9, more_smooth=smooth)
        outs.append(D.decode_all_scales(vc, qc, p, q, [1, 2], seed=4, samp=samp,
                                        return_ids=True, device="cpu"))
    (f0, ids0), (f1, ids1) = outs
    assert torch.isfinite(f1).all() and f1.shape == f0.shape
    assert torch.equal(ids0[:, :1], ids1[:, :1])  # scale 0 samples alike
    assert not torch.equal(f0, f1)


@pytest.mark.parametrize("V", [8194, 8196, 16384])
def test_decode_at_wide_and_refused_widths(V):
    """A small stack with a vocabulary past the decode's decodes through
    ``sample_with_top_k_top_p``: on the card the kernel takes 8196 and
    16384 (rows read in device memory) and 8194 (not a multiple of 4) goes
    to ``sample_plain``, which the CPU runs at every width."""
    assert sampler_takes(V) == (V % 4 == 0)
    vc, qc, p, q = _small(V)
    samp = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
    f_hat, ids = D.decode_all_scales(vc, qc, p, q, [3, 7], seed=1, samp=samp,
                                     return_ids=True, device="cpu")
    assert ids.shape == (2, 14) and int(ids.min()) >= 0 and int(ids.max()) < V
    assert torch.isfinite(f_hat).all()
    again = D.decode_all_scales(vc, qc, p, q, [3, 7], seed=1, samp=samp,
                                return_ids=True, device="cpu")[1]
    assert torch.equal(ids, again)
