"""Port pixel decoder against the JAX package's ``fhat_to_img`` on a tiny
VQVAE (ch=32, z_channels=8) in f32, through the weight bridge."""

import numpy as np
import torch

import jax

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.utils.from_jax import vqvae_params_from_jax

KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))


def _perturb_norms(tree, rng):
    """GroupNorm gains/biases away from ones/zeros, so the affine is tested."""
    if isinstance(tree, dict):
        if set(tree) == {"g", "b"}:
            tree["g"] = tree["g"] + rng.standard_normal(tree["g"].shape).astype(np.float32) * 0.1
            tree["b"] = tree["b"] + rng.standard_normal(tree["b"].shape).astype(np.float32) * 0.1
        for v in tree.values():
            _perturb_norms(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _perturb_norms(v, rng)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def test_fhat_to_img_matches_jax():
    """Weights made by the port's initialiser go to JAX as numpy arrays and
    come back through the bridge; both decoders run them in f32."""
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    p = _numpy_tree(VQ.init_vqvae_params(tcfg, seed=3, device="cpu"))
    _perturb_norms(p, np.random.default_rng(0))
    tp = vqvae_params_from_jax(p, device="cpu")
    f_hat = np.random.default_rng(1).standard_normal((2, 8, 3, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JVQ.fhat_to_img, static_argnums=0)(jcfg, p, f_hat))
    got = VQ.fhat_to_img(tcfg, tp, torch.from_numpy(f_hat)).numpy()
    assert got.shape == (2, 3, 48, 48)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_port_init_matches_jax_tree():
    """The port's initialiser builds the JAX package's tree (same keys and
    shapes, from ``jax.eval_shape`` of its initialiser) with its
    distributions: uniform convs in +/- 1/sqrt(fan_in), GroupNorm ones and
    zeros."""
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    shapes = jax.eval_shape(lambda k: JVQ.init_vqvae_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tp = VQ.init_vqvae_params(tcfg, seed=0, device="cpu")

    def walk(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            assert isinstance(b, list) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert tuple(b.shape) == a.shape, path

    walk(shapes, tp, ())
    conv = tp["decoder"]["mid"]["block_1"]["conv1"]
    lim = 1 / np.sqrt(conv["w"].shape[1] * 9)
    assert conv["w"].abs().max() <= lim and conv["w"].std() > 0.5 * lim
    assert bool((tp["decoder"]["norm_out"]["g"] == 1).all())
    assert not tp["decoder"]["norm_out"]["b"].any()
