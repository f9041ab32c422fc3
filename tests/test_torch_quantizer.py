"""Port quantizer decode half against the JAX package's: resize matrices,
phi convs and the per-scale state update (f32), and the phi index."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import quantizer as JQ
from sdvar_tpu.ops import resize as JR
from sdvar_tpu_torch.config import PATCH_NUMS_256, PATCH_NUMS_1024, VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.ops import resize as R
from sdvar_tpu_torch.utils.from_jax import _convert

PNS = (1, 2, 3, 4, 6)


@pytest.mark.parametrize("n_in,n_out", [(1, 16), (3, 16), (13, 16), (16, 16),
                                        (16, 1), (16, 5), (16, 13), (32, 9)])
def test_resize_matrices_and_resizes_equal(n_in, n_out):
    np.testing.assert_array_equal(R.bicubic_weight_matrix(n_in, n_out),
                                  JR.bicubic_weight_matrix(n_in, n_out))
    np.testing.assert_array_equal(R.area_weight_matrix(n_in, n_out),
                                  JR.area_weight_matrix(n_in, n_out))
    x = np.random.default_rng(0).standard_normal((2, 3, n_in, n_in)).astype(np.float32)
    for port, ref in ((R.bicubic_resize, JR.bicubic_resize),
                      (R.area_resize, JR.area_resize)):
        np.testing.assert_allclose(
            port(torch.from_numpy(x), (n_out, n_out)).numpy(),
            np.asarray(ref(jnp.asarray(x), (n_out, n_out))),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("share", [0, 1, 4])
@pytest.mark.parametrize("pns", [PATCH_NUMS_256, PATCH_NUMS_1024])
def test_phi_index_equal(share, pns):
    port = VQVAEConfig(share_quant_resi=share, patch_nums=pns)
    ref = JVQVAEConfig(share_quant_resi=share, patch_nums=pns)
    assert port.num_phi == ref.num_phi
    assert [port.phi_index(si) for si in range(len(pns))] == \
        [ref.phi_index(si) for si in range(len(pns))]


@pytest.mark.parametrize("share", [0, 4])
def test_phi_and_state_update_match(share):
    kw = dict(vocab_size=64, z_channels=8, patch_nums=PNS, share_quant_resi=share)
    jcfg, tcfg = JVQVAEConfig(**kw), VQVAEConfig(**kw)
    qp = jax.tree.map(np.asarray,
                      JQ.init_quantizer_params(jcfg, jax.random.PRNGKey(1), eini=1.0))
    qp["phi_b"] = np.random.default_rng(5).standard_normal(
        qp["phi_b"].shape).astype(np.float32) * 0.1
    tp = _convert(qp, torch.device("cpu"))
    rng = np.random.default_rng(2)
    HW = PNS[-1]
    jf = jnp.zeros((2, 8, HW, HW), jnp.float32)
    tf = torch.zeros((2, 8, HW, HW))
    for si, pn in enumerate(PNS):
        ids = rng.integers(0, 64, size=(2, pn * pn))
        jh = JQ.embed(qp, jnp.asarray(ids)).transpose(0, 2, 1).reshape(2, 8, pn, pn)
        th = Q.embed(tp, torch.from_numpy(ids)).transpose(1, 2).reshape(2, 8, pn, pn)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_allclose(
            Q.phi_apply(tcfg, tp, si, th).numpy(),
            np.asarray(JQ.phi_apply(jcfg, qp, si, jh)), rtol=1e-5, atol=1e-5)
        jf, jn = JQ.next_autoregressive_input(jcfg, qp, si, jf, jh)
        tf, tn = Q.next_autoregressive_input(tcfg, tp, si, tf, th)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)
