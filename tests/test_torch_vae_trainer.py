"""The quantizer's training half and the VQVAE trainer against the JAX
package on the same numpy weights (the counterparts of
``tests/test_trainer.py::test_vae_train_step_consumes_ema_usage`` and
``tests/test_observability.py``'s EMA cases): a tiny VQVAE (ch=32, Cvae=8,
V=32 or 64, scales 1-2-3, codebook an ``eini=1.0`` draw) made by the port's
initialiser, f32.

Bounds: ``vq_train_forward``'s f_hat, loss and the gradients of f and of
the quantizer's parameters within 1e-5 of each tensor's size, its hits
equal; the EMA schedule and the usage within 1e-6; three
``vae_train_step``s: losses, the EMA tracker, the usage and every
parameter within 1e-5 of their size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import quantizer as JQ
from sdvar_tpu.train import vae_trainer as JVT
from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train import vae_trainer as VT
from sdvar_tpu_torch.train.trainer import tree_leaves

PNS = (1, 2, 3)


def _kw(vocab=64):
    return dict(vocab_size=vocab, z_channels=8, ch=32, patch_nums=PNS)


def _rel(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, size = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * max(size, 1e-30), (err, size)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def vae():
    params = init_vqvae_params(VQVAEConfig(**_kw()), seed=0, device="cpu",
                               eini=1.0)
    return params, _numpy(params)


def test_vq_train_forward_matches_jax(vae):
    params, np_params = vae
    cfg, jcfg = VQVAEConfig(**_kw()), JVQVAEConfig(**_kw())
    f = np.random.default_rng(1).standard_normal((4, 8, 3, 3)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal(f.shape).astype(np.float32)

    def jfn(qp, x):
        f_hat, hits, loss = JQ.vq_train_forward(jcfg, qp, x)
        return jnp.sum(f_hat * w) + loss, (f_hat, hits, loss)

    (_, (jf, jh, jl)), (jgq, jgf) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(np_params["quant"], jnp.asarray(f))
    qp = {k: v.detach().requires_grad_() for k, v in params["quant"].items()}
    x = torch.from_numpy(f).requires_grad_()
    tf, th, tl = Q.vq_train_forward(cfg, qp, x)
    grads = torch.autograd.grad((tf * torch.from_numpy(w)).sum() + tl,
                                [x] + list(qp.values()))
    _rel(tf, jf)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _rel(grads[0], jgf)
    for (name, _), g in zip(qp.items(), grads[1:]):
        _rel(g, jgq[name])
    # the straight-through estimator: the values of f_hat, the gradient of f
    np.testing.assert_array_equal(th.sum(-1).numpy(), [4 * p * p for p in PNS])


def test_vocab_hit_ema_schedule_matches_jax():
    rng = np.random.default_rng(3)
    ema = rng.uniform(0, 5, (3, 16)).astype(np.float32)
    hits = rng.integers(0, 9, (3, 16)).astype(np.float32)
    for step in (0, 5, 99, 100, 200):
        want = np.asarray(JQ.update_vocab_hit_ema(jnp.asarray(ema),
                                                  jnp.asarray(hits), step))
        got = Q.update_vocab_hit_ema(torch.from_numpy(ema),
                                     torch.from_numpy(hits), step).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the schedule itself: copy, then 0.9 / 0.1, then 0.99 / 0.01
    e = Q.update_vocab_hit_ema(torch.zeros(2, 4), torch.ones(2, 4), 0)
    np.testing.assert_array_equal(e.numpy(), 1.0)
    e = Q.update_vocab_hit_ema(e, torch.zeros(2, 4), 5)
    np.testing.assert_allclose(e.numpy(), 0.9, rtol=1e-7)
    e = Q.update_vocab_hit_ema(e, torch.zeros(2, 4), 200)
    np.testing.assert_allclose(e.numpy(), 0.9 * 0.99, rtol=1e-6)


@pytest.mark.parametrize("world", [1, 2])
def test_vocab_usage_per_scale_matches_jax(world):
    cfg, jcfg = VQVAEConfig(**_kw(32)), JVQVAEConfig(**_kw(32))
    ema = np.random.default_rng(4).uniform(0, 2, (3, 32)).astype(np.float32)
    want = np.asarray(JQ.vocab_usage_per_scale(jcfg, jnp.asarray(ema), 36, world))
    got = Q.vocab_usage_per_scale(cfg, torch.from_numpy(ema), 36, world).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.shape == (3,) and ((got >= 0) & (got <= 100)).all()


def test_vae_train_steps_match_jax(vae):
    params, np_params = vae
    cfg, jcfg = VQVAEConfig(**_kw()), JVQVAEConfig(**_kw())
    img = np.random.default_rng(1).uniform(-1, 1, (2, 3, 48, 48)).astype(np.float32)
    jst = JVT.init_vae_train_state(jcfg, jax.tree.map(jnp.asarray, np_params))
    st = VT.init_vae_train_state(cfg, params)
    cb0 = params["quant"]["codebook"].clone()
    for i in range(3):
        jst, jm = JVT.vae_train_step(jcfg, jst, jnp.asarray(img),
                                     jnp.asarray(1e-3, jnp.float32))
        st, m = VT.vae_train_step(cfg, st, torch.from_numpy(img), 1e-3)
        for k in ("loss", "rec_loss", "vq_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        np.testing.assert_allclose(m["usage_per_scale"].numpy(),
                                   np.asarray(jm["usage_per_scale"]), rtol=1e-6)
        _rel(st.ema_hits_SV, jst.ema_hits_SV)
    assert st.step == int(jst.step) == 3
    jflat = _flat(jax.tree.map(np.asarray, jst.params))
    for path, t in tree_leaves(st.params):
        _rel(t, jflat["/" + path])
    # SGD moved the codebook (the codebook loss reaches it), as in JAX
    assert (st.params["quant"]["codebook"] - cb0).abs().max() > 0
    assert st.ema_hits_SV.sum() > 0


def test_cached_device_tensors_made_in_inference_mode_still_train():
    """The resize matrices and the attention biases are made once per
    device and size; made first under ``inference_mode`` (a decode or a
    pixel decode), they still serve a training forward that saves them for
    its backward (the VQVAE trainer's resizes; the training attention's
    bias). Sizes no other test uses, so the caches start empty."""
    from sdvar_tpu_torch.ops.masks import block_causal_prefix, device_bias
    from sdvar_tpu_torch.ops.resize import area_resize, bicubic_resize

    with torch.inference_mode():
        bicubic_resize(torch.ones(1, 1, 13, 13), (29, 29))
        area_resize(torch.ones(1, 1, 29, 29), (17, 17))
        bias = device_bias(torch.device("cpu"), block_causal_prefix,
                           (1, 2, 6), 41)
    assert not bias.is_inference()
    x = torch.ones(1, 1, 13, 13, requires_grad=True)
    area_resize(bicubic_resize(x, (29, 29)), (17, 17)).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
