"""Port fp8 weights (``mode="fp8"``, ``FP8Linear``) against the JAX
package's: the e4m3 bytes and scales of ``quantize_weight_fp8``, the
``quantize_var_params`` tree (head kept plain by default), ``linear_blc``,
the weight bridge, and a greedy f32 decode with fp8 weights. Inputs are
made with numpy from a seed and handed to both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import SamplingConfig as JSamplingConfig
from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.engine import decode as JD
from sdvar_tpu.models import var as JM
from sdvar_tpu.ops import quantization as JQ
from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.ops import quantization as Q
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax, vqvae_params_from_jax

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
              head_dim=32)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)


def _bytes(q):
    """The raw e4m3 bytes of a JAX (ml_dtypes) or torch fp8 array."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _weight(shape, seed):
    """Normal weights with an all-zero output channel and entries that map
    to exactly +448 and -448 (the largest finite e4m3 values)."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0
    w[..., 7, 1] = 2.0
    w[..., 9, 2] = -2.0
    return w


@pytest.fixture(scope="module")
def var_np():
    p = jax.tree.map(np.asarray, JM.init_var_params(JVARConfig(**VAR_KW),
                                                    jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    p["head"]["w"] = rng.normal(0, 0.05, p["head"]["w"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("shape,dtype", [((64, 128), "float32"),
                                         ((2, 48, 96), "float32"),
                                         ((64, 128), "bfloat16")])
def test_quantize_weight_fp8_bit_equal(shape, dtype):
    """e4m3 bytes (round to nearest even) and f32 scales bit-equal, 2-D and
    depth-stacked, f32 and bf16 weights (a bf16 weight's amax / 448 rounds
    in bf16 on both sides), with a zero channel and values at +-448."""
    w = _weight(shape, 0)
    jq = JQ.quantize_weight_fp8(jnp.asarray(w).astype(dtype))
    tq = Q.quantize_weight_fp8(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tq.q.dtype == torch.float8_e4m3fn and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq.q), _bytes(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert {0x7E, 0xFE} <= set(np.unique(_bytes(tq.q)).tolist())  # +-448
    assert not (_bytes(tq.q)[..., 3] & 0x7F).any()  # the zero channel
    np.testing.assert_array_equal(
        Q.dequantize_weight(tq, torch.float32).numpy(),
        np.asarray(JQ.dequantize_weight(jq, jnp.float32)))


def test_quantize_var_params_fp8_tree(var_np):
    """Every block weight an FP8Linear with JAX's bytes; the head kept
    plain by default, an FP8 head with ``quantize_head=True``."""
    tp = var_params_from_jax(var_np, device="cpu")
    jq = JQ.quantize_var_params(var_np, mode="fp8")
    tq = Q.quantize_var_params(tp, mode="fp8")
    for key in Q.WEIGHT_KEYS:
        leaf, jleaf = tq["blocks"][key], jq["blocks"][key]
        assert type(leaf) is Q.FP8Linear and type(jleaf).__name__ == "FP8Linear"
        np.testing.assert_array_equal(_bytes(leaf.q), _bytes(jleaf.q))
        np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaf.scale))
    assert tq["head"]["w"] is tp["head"]["w"]
    assert not isinstance(jq["head"]["w"], tuple)
    jh = JQ.quantize_var_params(var_np, mode="fp8", quantize_head=True)["head"]["w"]
    th = Q.quantize_var_params(tp, mode="fp8", quantize_head=True)["head"]["w"]
    assert type(th) is Q.FP8Linear
    np.testing.assert_array_equal(_bytes(th.q), _bytes(jh.q))


@pytest.mark.parametrize("mode,head", [("w8", Q.QuantizedLinear),
                                       ("w8a8", Q.QuantizedLinear),
                                       ("fp8", torch.Tensor)])
def test_quantize_head_defaults_per_mode(var_np, mode, head):
    """``quantize_head=None`` means per mode, as in the JAX package: the
    int8 modes quantize the head, fp8 keeps it plain."""
    tq = Q.quantize_var_params(var_params_from_jax(var_np, device="cpu"), mode=mode)
    jq = JQ.quantize_var_params(var_np, mode=mode)
    assert isinstance(tq["head"]["w"], head)
    assert isinstance(jq["head"]["w"], tuple) == (head is not torch.Tensor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_blc_fp8_matches_jax(dtype):
    """Within 1e-3 * max|ref| in f32 and 1e-2 in bf16 (one bf16 rounding of
    the output and of the dequantized weight): both dequantize the e4m3
    weight to ``dtype`` and take an f32-accumulated product."""
    x = np.random.default_rng(4).standard_normal((2, 16, 128)).astype(np.float32)
    w = _weight((128, 256), 5)
    jw = JQ.quantize_weight_fp8(jnp.asarray(w))
    tw = Q.quantize_weight_fp8(torch.from_numpy(w))
    want = np.asarray(JQ.linear_blc(jnp.asarray(x).astype(dtype), jw,
                                    getattr(jnp, dtype))).astype(np.float32)
    got = Q.linear_blc(torch.from_numpy(x).to(getattr(torch, dtype)), tw,
                       getattr(torch, dtype)).float().numpy()
    tol = 1e-3 if dtype == "float32" else 1e-2
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_bridge_carries_fp8(var_np):
    """A JAX fp8 tree crosses with its FP8Linear leaves' bytes and scales
    equal, the plain head as it was."""
    jq = jax.tree.map(np.asarray, JQ.quantize_var_params(var_np, mode="fp8"))
    tq = var_params_from_jax(jq, device="cpu")
    for key in Q.WEIGHT_KEYS:
        leaf, jleaf = tq["blocks"][key], jq["blocks"][key]
        assert type(leaf) is Q.FP8Linear and leaf.q.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_bytes(leaf.q), _bytes(jleaf.q))
        np.testing.assert_array_equal(leaf.scale.numpy(), jleaf.scale)
    np.testing.assert_array_equal(tq["head"]["w"].numpy(), jq["head"]["w"])


def test_greedy_decode_fp8_matches_jax(var_np):
    """Greedy f32 decode with fp8 weights: the ids equal JAX's, f_hat within
    1e-4 (it is a function of the ids)."""
    tv, tq = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    qp = jax.tree.map(lambda t: t.numpy(), VQ.init_vqvae_params(
        tq, seed=5, device="cpu", eini=1.0))
    jq = JQ.quantize_var_params(var_np, mode="fp8")
    label = np.array([3, 7])
    f_hat_j, ids_j = JD.decode_all_scales(
        JVARConfig(**VAR_KW), JVQVAEConfig(**VAE_KW), jq, qp["quant"],
        jnp.asarray(label), jax.random.PRNGKey(0),
        JSamplingConfig(cfg=1.5, top_k=1), jnp.float32, return_ids=True)
    tvp = Q.quantize_var_params(var_params_from_jax(var_np, device="cpu"), mode="fp8")
    tqp = vqvae_params_from_jax(qp, device="cpu")
    f_hat_t, ids_t = D.decode_all_scales(tv, tq, tvp, tqp["quant"], label, 0,
                                         SamplingConfig(cfg=1.5, top_k=1),
                                         torch.float32, return_ids=True,
                                         device="cpu")
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(f_hat_t.numpy(), np.asarray(f_hat_j),
                               rtol=1e-4, atol=1e-4)
    img = D.generate_images(tv, tq, tvp, tqp, label, 0,
                            SamplingConfig(cfg=1.5, top_k=1), torch.float32,
                            device="cpu")
    assert img.shape == (2, 3, 48, 48) and bool(torch.isfinite(img).all())
