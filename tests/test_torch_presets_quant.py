"""The W8A8 + INT8-KV decode at the 512px and 1024px presets, with shared
AdaLN off and on, against the JAX package on the CPU: the stacks of
``torch_presets_common.py`` quantized by the JAX package (mode w8a8: under
shared AdaLN the blocks have no ``ada_lin_w`` to quantize), carried over
by the bridge, greedy, f32 activations.

The two packages' f32 sums part in the last bits, and in a quantized
forward such a difference can move an activation or a cached key across
an int8 rounding step. From there the logits differ by about 1e-3 of
their size, and a later greedy argmax whose top two are that close picks
the other id; the trajectories then part. Measured at the 1024 prefix
with per-block AdaLN: logits within 5e-7 for scales 0-4, one such step at
scale 5 (median difference 6e-8, largest 5.8e-4), the first other id at
scale 7 (top two 3.8e-3 apart), 47 of 3510 ids in all; the other three
cases agree in every id, and the whole 14-scale 1024 schedule with shared
AdaLN differs in one id of its last scale (top two 3.6e-7 apart). So the
check is: every id of the first five scales equal (up to 6x6 tokens,
where no such step has reached an argmax at this size), at least 95% of
all ids equal (a broken decode agrees on about 1/64 of them), and where
every id is equal, f_hat within 1e-4. On the H100 the port's own card
path parts from its CPU path the same way (``chip_smoke.py``,
``phase_highres_small_reference``). The later scales' logits are held
numerically by ``test_torch_presets_forward.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvar_tpu.config import SamplingConfig as JSamplingConfig
from sdvar_tpu.engine import decode as JD
from sdvar_tpu.ops import quantization as JQ
from sdvar_tpu_torch.config import SamplingConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache, W8A8Linear
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax
from torch_presets_common import CASES, IDS, build_stack
from torch_presets_common import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("reso,shared", CASES, ids=IDS)
def test_w8a8_int8_kv_greedy_matches_jax(reso, shared):
    jv, jq, tv, tq, vp, qp, _, tqp = build_stack(reso, shared)
    jvq = jax.tree.map(np.asarray, JQ.quantize_var_params(vp, mode="w8a8"))
    tvq = var_params_from_jax(jvq, device="cpu")
    assert isinstance(tvq["blocks"]["fc2_w"], W8A8Linear)
    assert ("ada_lin_w" in tvq["blocks"]) != shared
    label = np.array([3, 7])
    f_hat_j, ids_j = JD.decode_all_scales(
        jv, jq, jvq, qp["quant"], jnp.asarray(label), jax.random.PRNGKey(0),
        JSamplingConfig(cfg=1.5, top_k=1), jnp.float32, return_ids=True,
        kv_mode="int8")
    f_hat_t, ids_t, cache = D.decode_all_scales(
        tv, tq, tvq, tqp["quant"], label, 0, SamplingConfig(cfg=1.5, top_k=1),
        torch.float32, return_ids=True, kv_mode="int8", return_cache=True,
        device="cpu")
    assert isinstance(cache, QuantizedKVCache) and cache.k.shape[2] == tv.L
    got, want = ids_t.numpy(), np.asarray(ids_j)
    assert got.shape == want.shape == (2, tv.L)
    head = tv.begin_ends[4][1]
    np.testing.assert_array_equal(got[:, :head], want[:, :head])
    assert (got == want).mean() >= 0.95, (got != want).sum()
    if (got == want).all():
        np.testing.assert_allclose(f_hat_t.numpy(), np.asarray(f_hat_j),
                                   rtol=1e-4, atol=1e-4)

