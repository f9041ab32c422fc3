"""The port at the 512px and 1024px presets, with shared AdaLN off and on,
against the JAX package on the CPU (greedy, f32), on the tiny stacks of
``torch_presets_common.py``: ``decode_all_scales`` and the images.

The 512 preset runs its ten scales (L = 2240), the 1024 preset its first
eleven (1 .. 27, L = 1755): the whole 14-scale schedule costs the JAX side
about 16 s of compile and run, and the prefix still has more than ten
scales; the port's own 14-scale decode runs on the card
(``chip_smoke.py``).
Ids equal, f_hat within 1e-4, images within 1e-3 (a two-level VQVAE, 2x
upsampling). The same decodes in W8A8 + INT8 KV are in
``test_torch_presets_quant.py``; the 512px pixel decoders and the
training forward on the 1024 prefix in ``test_torch_presets_pixels.py``
(three files, which xdist spreads over three workers). The JAX decode pads
a scale's queries to a multiple of 64 above 128 tokens and the port does
not, so the comparison is of outputs and ids, never of raw cache rows
past ``kv_len``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvar_tpu.config import SamplingConfig as JSamplingConfig
from sdvar_tpu.engine import decode as JD
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu_torch.config import SamplingConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models import vqvae as VQ
from torch_presets_common import CASES, IDS, build_stack
from torch_presets_common import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def stacks():
    made = {}

    def get(reso, shared):
        if (reso, shared) not in made:
            made[reso, shared] = build_stack(reso, shared)
        return made[reso, shared]
    return get


@pytest.mark.parametrize("reso,shared", CASES, ids=IDS)
def test_greedy_decode_matches_jax(stacks, reso, shared):
    jv, jq, tv, tq, vp, qp, tvp, tqp = stacks(reso, shared)
    label = np.array([3, 7])
    f_hat_j, ids_j = JD.decode_all_scales(
        jv, jq, vp, qp["quant"], jnp.asarray(label), jax.random.PRNGKey(0),
        JSamplingConfig(cfg=1.5, top_k=1), jnp.float32, return_ids=True)
    samp = SamplingConfig(cfg=1.5, top_k=1)
    f_hat_t, ids_t = D.decode_all_scales(tv, tq, tvp, tqp["quant"], label, 0,
                                         samp, torch.float32, return_ids=True,
                                         device="cpu")
    assert ids_t.shape == (2, tv.L)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(f_hat_t.numpy(), np.asarray(f_hat_j),
                               rtol=1e-4, atol=1e-4)
    img_j = (np.asarray(jax.jit(JVQ.fhat_to_img, static_argnums=0)(
        jq, qp, f_hat_j)) + 1.0) * 0.5
    img_t = ((VQ.fhat_to_img(tq, tqp, f_hat_t) + 1.0) * 0.5).numpy()
    hw = 2 * tv.patch_nums[-1]
    assert img_t.shape == (2, 3, hw, hw)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-3, atol=1e-3)
