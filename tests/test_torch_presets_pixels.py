"""The 512px pixel decoders and the training forward on the 1024 prefix,
against the JAX package on the CPU.

- The five-level VQVAE (ch=32, the default ``ch_mult``) on a 32x32 latent,
  one image: the golden f32 decoder within 1e-4 of JAX's; the
  channels-last bf16 decoder no further from the golden image than JAX's
  bf16 decoder (mean within 10%), mean 0.02 from both, max 0.3 from the
  golden image and 0.4 from JAX's (measured: port 0.0096 / 0.278, JAX
  0.0105 / 0.289 from the golden image, 0.0128 / 0.340 apart: over 0.8M
  values the largest bf16 deviation exceeds the JAX package's 0.2 bound of
  its 48px test, in both packages alike); the all-int8 decoder
  with sites calibrated by the port on this latent as the server's
  ``pixq`` is (alpha 0.75, min_w 256: the two top levels, 256 and 512
  wide) within mean 0.05 of the golden image (measured 0.028), as
  ``test_torch_vqvae.py`` holds it at 48px. JAX's W8A8 decoder runs its
  int8 convs only through Pallas (interpret mode on the CPU, too slow at
  512x512), so the port's sites are held to the golden image here and to
  JAX's sites in ``test_torch_vqvae.py``.
- ``var_train_forward`` with shared AdaLN on the 1024 preset's first
  eleven scales (the block-causal bias of L = 1755, as the JAX package's
  ``tests/test_presets.py`` runs the preset): logits within 1e-5 of
  their size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import var as JM
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu_torch.config import PATCH_NUMS_512, VQVAEConfig
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.utils.from_jax import vqvae_params_from_jax
from torch_presets_common import build_stack, numpy_tree

KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PATCH_NUMS_512)


def test_512px_pixel_decoders_match_jax():
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    p = numpy_tree(VQ.init_vqvae_params(tcfg, seed=3, device="cpu"))
    tp = vqvae_params_from_jax(p, device="cpu")
    f_hat = np.random.default_rng(1).standard_normal((1, 8, 32, 32)
                                                     ).astype(np.float32)
    gold = np.asarray(jax.jit(JVQ.fhat_to_img, static_argnums=0)(jcfg, p, f_hat))
    x = torch.from_numpy(f_hat)
    got = VQ.fhat_to_img(tcfg, tp, x).numpy()
    assert got.shape == gold.shape == (1, 3, 512, 512)
    np.testing.assert_allclose(got, gold, rtol=1e-4, atol=1e-4)

    want = np.asarray(JVQ.fhat_to_img_nhwc(jcfg, p, f_hat))
    bf16 = VQ.fhat_to_img_nhwc(tcfg, tp, x).numpy()
    for ref, top in ((gold, 0.3), (want, 0.4)):
        d = np.abs(bf16 - ref)
        assert d.mean() <= 0.02 and d.max() <= top, (d.mean(), d.max())
    assert (np.abs(bf16 - gold).mean()
            <= 1.1 * np.abs(want - gold).mean())

    sites = VQ.calibrate_decoder_w8a8(tcfg, tp, [x], alpha=0.75, min_w=256)
    widths = [s is not None for s in sites]
    assert 0 < sum(widths) < len(sites)
    int8 = VQ.fhat_to_img_nhwc_w8a8_static(tcfg, tp, x, sites).numpy()
    assert np.isfinite(int8).all() and int8.shape == gold.shape
    assert np.abs(int8 - gold).mean() < 0.05


def test_train_forward_1024_prefix_matches_jax():
    jv, _, tv, _, vp, _, tvp, _ = build_stack(1024, True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, tv.L - tv.first_l, tv.Cvae)).astype(np.float32)
    label = np.array([0, 5], np.int32)
    want = np.asarray(JM.var_train_forward(jv, vp, jnp.asarray(label),
                                           jnp.asarray(x)))
    got = M.var_train_forward(tv, tvp, torch.from_numpy(label),
                              torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, tv.L, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
