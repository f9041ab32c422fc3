"""The port's VQVAE encoder half and the quantizer's encode half against the
JAX package's, on a tiny VQVAE (ch=32, Cvae=8, V=64, 48px images, scales
1-2-3) made by the JAX initialiser and carried over by the weight bridge.

The codebook is the quantizer initialiser's ``eini=1.0`` draw (entries of
order 1, as a trained codebook's are) in place of the default +-1/V one,
whose codes sit so close that f32 rounding alone picks between them.
Bounds: f32 latents within 1e-5 of their size and f32 ids equal; the bf16
and channels-last forms' ids equal to the JAX forms' on at least 99%;
``idx_to_var_input`` and ``embed_to_fhat`` within 1e-5 of their size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import quantizer as JQ
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.utils.from_jax import vqvae_params_from_jax

KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))
B = 16


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, size = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * size, (err, size)


def _jit(fn):
    return jax.jit(fn, static_argnums=0)


@pytest.fixture(scope="module")
def vae():
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    p = _jit(JVQ.init_vqvae_params)(jcfg, jax.random.PRNGKey(0))
    p["quant"] = JQ.init_quantizer_params(jcfg, jax.random.PRNGKey(1), eini=1.0)
    p = jax.tree.map(np.asarray, p)
    img = np.random.default_rng(0).uniform(-1, 1, (B, 3, 48, 48)).astype(np.float32)
    return jcfg, tcfg, p, vqvae_params_from_jax(p, device="cpu"), img


@pytest.fixture(scope="module")
def jax_f(vae):
    """JAX's f32 latent of the images and its per-scale ids."""
    jcfg, _, p, _, img = vae
    f = _jit(JVQ.img_to_f)(jcfg, p, jnp.asarray(img))
    ids = _jit(JQ.encode)(jcfg, p["quant"], f)
    return np.asarray(f), [np.asarray(i) for i in ids]


def _ids(ids):
    return np.concatenate([np.asarray(i) for i in ids], axis=1)


def test_downsample2x_matches_jax(vae):
    _, _, p, tp, _ = vae
    lvl, tlvl = p["encoder"]["down"][0]["downsample"], tp["encoder"]["down"][0]["downsample"]
    x = np.random.default_rng(1).standard_normal((2, 32, 12, 12)).astype(np.float32)
    want = np.asarray(JVQ.downsample2x(lvl, jnp.asarray(x)))
    _close(VQ.downsample2x(tlvl, torch.from_numpy(x)), want)


def test_img_to_f_and_ids_match_jax(vae, jax_f):
    _, tcfg, _, tp, img = vae
    f = VQ.img_to_f(tcfg, tp, torch.from_numpy(img))
    _close(f, jax_f[0])
    got = _ids(VQ.img_to_idxBl(tcfg, tp, torch.from_numpy(img)))
    want = _ids(jax_f[1])
    assert got.dtype == np.int32 and got.shape == (B, 14)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["bf16", "nhwc_bf16", "nhwc_f32"])
def test_other_encoder_forms_match_jax(vae, form):
    jcfg, tcfg, p, tp, img = vae
    x, jx = torch.from_numpy(img), jnp.asarray(img)
    if form == "bf16":
        got = VQ.img_to_idxBl_bf16(tcfg, tp, x)
        want = _jit(JVQ.img_to_idxBl_bf16)(jcfg, p, jx)
    else:
        dt, jdt = ((torch.bfloat16, jnp.bfloat16) if form == "nhwc_bf16"
                   else (torch.float32, jnp.float32))
        got = VQ.img_to_idxBl_nhwc(tcfg, tp, x, dtype=dt)
        want = JQ.encode(jcfg, p["quant"], JVQ.img_to_f_nhwc(jcfg, p, jx,
                                                             dtype=jdt))
        if dt == torch.float32:
            _close(VQ.img_to_f_nhwc(tcfg, tp, x, dtype=dt),
                   JVQ.img_to_f_nhwc(jcfg, p, jx, dtype=jdt))
    share = float((_ids(got) == _ids(want)).mean())
    print(f"{form}: share of ids equal to the JAX form's {share:.4f}")
    assert share >= (1.0 if form == "nhwc_f32" else 0.99), share


def test_reconstructed_img_matches_jax(vae):
    jcfg, tcfg, p, tp, img = vae
    got = VQ.img_to_reconstructed_img(tcfg, tp, torch.from_numpy(img[:2]))
    want = _jit(JVQ.img_to_reconstructed_img)(jcfg, p, jnp.asarray(img[:2]))
    _close(got, want)


def test_lookup_codes_matches_jax(vae):
    jcfg, tcfg, p, tp, _ = vae
    z = np.random.default_rng(2).standard_normal((300, 8)).astype(np.float32)
    want = np.asarray(JQ.lookup_codes(jcfg, p["quant"], jnp.asarray(z)))
    got = Q.lookup_codes(tcfg, tp["quant"], torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), want)
    zcfg = VQVAEConfig(**KW, using_znorm=True)
    jz = JVQVAEConfig(**KW, using_znorm=True)
    np.testing.assert_array_equal(
        Q.lookup_codes(zcfg, tp["quant"], torch.from_numpy(z)).numpy(),
        np.asarray(JQ.lookup_codes(jz, p["quant"], jnp.asarray(z))))


def test_encode_fhats_var_input_and_embed_to_fhat_match_jax(vae, jax_f):
    jcfg, tcfg, p, tp, _ = vae
    f = np.array(jax_f[0][:4])
    jf = jnp.asarray(f)
    for a, b in zip(Q.encode(tcfg, tp["quant"], torch.from_numpy(f),
                             return_fhat=True),
                    JQ.encode(jcfg, p["quant"], jf, return_fhat=True)):
        _close(a, b)
    ids = JQ.encode(jcfg, p["quant"], jf)
    t_ids = [torch.from_numpy(np.asarray(i)) for i in ids]
    x_in = Q.idx_to_var_input(tcfg, tp["quant"], t_ids)
    assert tuple(x_in.shape) == (4, 13, 8)
    _close(x_in, JQ.idx_to_var_input(jcfg, p["quant"], ids))
    maps = [JQ.embed(p["quant"], i).reshape(4, pn, pn, 8).transpose(0, 3, 1, 2)
            for i, pn in zip(ids, (1, 2, 3))]
    t_maps = [torch.from_numpy(np.asarray(m)) for m in maps]
    for last_one in (False, True):
        got = Q.embed_to_fhat(tcfg, tp["quant"], t_maps, last_one=last_one)
        want = JQ.embed_to_fhat(jcfg, p["quant"], maps, last_one=last_one)
        for a, b in zip(got if not last_one else [got],
                        want if not last_one else [want]):
            _close(a, b)
