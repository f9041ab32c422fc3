"""Port INT8 quantization against the JAX package's: weight and activation
quantization, the W8A8 and weight-only matmuls, the INT8 KV-cache token
quantization, the plain versions of the fused act-quant and INT8-weight
matmul kernels against the Pallas kernels in interpret mode, and the weight
bridge for quantized trees. Inputs are made with numpy from a seed and
handed to both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.models import var as JM
from sdvar_tpu.ops import quantization as JQ
from sdvar_tpu.ops.pallas.matmul_int8 import int8_matmul as j_int8_matmul
from sdvar_tpu.ops.pallas.quantize import act_quantize as j_act_quantize
from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.ops import quantization as Q
from sdvar_tpu_torch.ops.kernels.matmul_int8 import int8_matmul, int8_matmul_blc
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax

CFG_KW = dict(depth=2, num_classes=10, patch_nums=(1, 2, 3), vocab_size=64,
              Cvae=8, attn_l2_norm=True, cond_drop_rate=0.0,
              drop_path_rate=0.0, head_dim=32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("shape,dtype", [((64, 128), "float32"),
                                         ((2, 48, 96), "float32"),
                                         ((64, 128), "bfloat16")])
def test_quantize_weight_bit_equal(shape, dtype):
    """int8 values bit-equal and the same scales, 2-D and depth-stacked,
    f32 and bf16 weights (bf16 amax/127 rounds in bf16 on both sides)."""
    w = _rand(shape, 0, 0.05)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq = JQ.quantize_weight(jw)
    tq = Q.quantize_weight(tw)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(
        Q.dequantize_weight(tq, torch.float32).numpy(),
        np.asarray(JQ.dequantize_weight(jq, jnp.float32)))


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_var_params_leaves(mode):
    """The same leaf class per key as the JAX package (and as
    tests/test_quantization.py asserts there), with the same arrays."""
    jcfg = JVARConfig(**CFG_KW)
    p_np = jax.tree.map(np.asarray, JM.init_var_params(jcfg, jax.random.PRNGKey(0)))
    jq = JQ.quantize_var_params(p_np, mode=mode)
    tq = Q.quantize_var_params(var_params_from_jax(p_np, device="cpu"), mode=mode)
    classes = {"w8": {k: Q.QuantizedLinear for k in Q.WEIGHT_KEYS},
               "w8a8": {"qkv_w": Q.W8A8Linear, "proj_w": Q.W8A8Linear,
                        "fc1_w": Q.W8A8Linear, "fc2_w": Q.W8A8Linear,
                        "ada_lin_w": Q.QuantizedLinear}}[mode]
    for key, cls in classes.items():
        leaf, jleaf = tq["blocks"][key], jq["blocks"][key]
        assert type(leaf) is cls and type(jleaf).__name__ == cls.__name__, key
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jleaf.q))
        np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaf.scale))
    assert type(tq["head"]["w"]) is Q.QuantizedLinear
    np.testing.assert_array_equal(tq["head"]["w"].q.numpy(),
                                  np.asarray(jq["head"]["w"].q))
    assert isinstance(tq["blocks"]["q_bias"], torch.Tensor)
    for key in Q.W8A8_KEYS:  # int8 GEMM operands are stored K-major
        leaf = tq["blocks"][key]
        assert type(leaf) is not Q.W8A8Linear or leaf.q[0].stride(0) == 1
    act = Q.quantize_var_params(var_params_from_jax(p_np, device="cpu"),
                                mode=mode, act_head=True)
    assert type(act["head"]["w"]) is (Q.W8A8Linear if mode == "w8a8"
                                      else Q.QuantizedLinear)
    fp8 = Q.quantize_var_params(var_params_from_jax(p_np, device="cpu"),
                                mode="fp8")
    assert all(type(fp8["blocks"][k]) is Q.FP8Linear for k in Q.WEIGHT_KEYS)
    with pytest.raises(ValueError, match="unknown mode"):
        Q.quantize_var_params(tq, mode="int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_and_tokens_bit_equal(dtype):
    x = _rand((3, 7, 96), 1, 3.0)
    x[0, 0] = 0.0  # an all-zero token takes the scale floor on both sides
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JQ.quantize_activation(jx)
    tq, ts = Q.quantize_activation(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = JQ.quantize_tokens(jx)
    tq, ts = Q.quantize_tokens(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        Q.dequantize_tokens(tq, ts, torch.float32).numpy(),
        np.asarray(JQ.dequantize_tokens(jq, js, jnp.float32)))


def test_w8a8_prequant_matmul_bit_equal():
    """The exact s32 product: bit-equal to JAX's exact int8 dot, at a K
    where an f32 sum of int8-as-bf16 would round (K * 127^2 > 2^24)."""
    x = _rand((2, 9, 1152), 2, 2.0)
    w = _rand((1152, 80), 3, 0.05)
    jqw = JQ.W8A8Linear(*JQ.quantize_weight(jnp.asarray(w)))
    tqw = Q.as_w8a8(*Q.quantize_weight(torch.from_numpy(w)))
    xq, xs = JQ.quantize_activation(jnp.asarray(x))
    want = np.asarray(JQ.w8a8_prequant_matmul(xq, xs, jqw, jnp.float32))
    got = Q.w8a8_prequant_matmul(torch.from_numpy(np.array(xq)),
                                 torch.from_numpy(np.array(xs)), tqw,
                                 torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    row_major = Q.W8A8Linear(tqw.q.contiguous(), tqw.scale)
    with pytest.raises(ValueError, match="K-major"):
        Q.w8a8_prequant_matmul(torch.from_numpy(np.array(xq)),
                               torch.from_numpy(np.array(xs)), row_major,
                               torch.float32)


@pytest.mark.parametrize("kind", ["QuantizedLinear", "W8A8Linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_blc_matches_jax(kind, dtype):
    """Within 1e-3 * max|ref| (the bound of tests/test_quantization.py's
    W8A8 check): weight-only, JAX dequantises the weight before its
    product and the port scales the f32 sum; W8A8, JAX sums int8-as-bf16
    in f32 and the port in exact int32; in bf16 the outputs round once."""
    x = _rand((2, 16, 128), 4)
    w = _rand((128, 256), 5, 0.05)
    jqw = getattr(JQ, kind)(*JQ.quantize_weight(jnp.asarray(w)))
    tqw = {"QuantizedLinear": Q.QuantizedLinear, "W8A8Linear": Q.as_w8a8}[kind](
        *Q.quantize_weight(torch.from_numpy(w)))
    want = np.asarray(JQ.linear_blc(jnp.asarray(x).astype(dtype), jqw,
                                    getattr(jnp, dtype))).astype(np.float32)
    got = _np(Q.linear_blc(torch.from_numpy(x).to(getattr(torch, dtype)), tqw,
                           getattr(torch, dtype)))
    assert got.shape == want.shape
    tol = 1e-3 if dtype == "float32" else 1e-2  # one bf16 rounding: 2^-8
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("shape,gelu", [((4, 64, 512), True),
                                        ((2, 128, 1280), True),
                                        ((8, 32, 768), False)])
def test_act_quantize_plain_matches_pallas(shape, gelu):
    """The plain version against the Pallas kernel in interpret mode, with
    the JAX test's own bounds (tests/test_quantization.py): scales within
    3e-7 relative, |dq| <= 1 on fewer than 1e-3 of the elements (PyTorch's
    and XLA's tanh may differ in the last bit)."""
    x = _rand(shape, 6, 3.0)
    b = _rand(shape[-1:], 7)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = j_act_quantize(jx, jnp.asarray(b) if gelu else None, gelu=gelu,
                            interpret=True)
    tq, ts = act_quantize(tx, torch.from_numpy(b) if gelu else None, gelu=gelu)
    assert tq.dtype == torch.int8 and ts.shape == shape[:-1] + (1,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=3e-7)
    d = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(48, 256, 384), (10, 1920, 128)])
def test_int8_matmul_plain_matches_pallas(x_dtype, M, K, N):
    """The plain version against the Pallas kernel in interpret mode, the
    output in x's dtype on both sides. Both sum exact products in f32 and
    scale the sum; only the order of the sum differs (rtol 1e-5), and a
    bf16 output rounds once (2^-8)."""
    x = _rand((M, K), 8)
    w = _rand((K, N), 9, 0.05)
    jqw = JQ.quantize_weight(jnp.asarray(w))
    want = np.asarray(j_int8_matmul(
        jnp.asarray(x).astype(x_dtype), jqw.q, jqw.scale, interpret=True,
        out_dtype=getattr(jnp, x_dtype))).astype(np.float32)
    tq = torch.from_numpy(np.array(jqw.q))
    ts = torch.from_numpy(np.array(jqw.scale))
    got = int8_matmul(torch.from_numpy(x).to(getattr(torch, x_dtype)), tq, ts)
    assert got.dtype == getattr(torch, x_dtype)
    rtol = 1e-5 if x_dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    blc = int8_matmul_blc(torch.from_numpy(x).view(2, M // 2, K), tq, ts)
    np.testing.assert_array_equal(blc.view(M, N).numpy(),
                                  int8_matmul(torch.from_numpy(x), tq, ts).numpy())


def test_bridge_carries_quantized_tree():
    """A JAX w8a8 tree crosses with its classes kept and its int8 bytes and
    scales equal; so does the JAX package's FP8Linear (its e4m3 bytes); a
    tuple the bridge does not know (a bare tuple) raises."""
    jcfg = JVARConfig(**CFG_KW)
    p = JM.init_var_params(jcfg, jax.random.PRNGKey(1))
    jq = jax.tree.map(np.asarray, JQ.quantize_var_params(p, mode="w8a8"))
    tq = var_params_from_jax(jq, device="cpu")
    for key in Q.WEIGHT_KEYS:
        leaf, jleaf = tq["blocks"][key], jq["blocks"][key]
        assert type(leaf).__name__ == type(jleaf).__name__, key
        assert type(leaf) in Q.QUANTIZED and leaf.q.dtype == torch.int8
        if type(leaf) is Q.W8A8Linear:
            assert leaf.q[0].stride(0) == 1
        np.testing.assert_array_equal(leaf.q.numpy(), jleaf.q)
        np.testing.assert_array_equal(leaf.scale.numpy(), jleaf.scale)
    assert type(tq["head"]["w"]) is Q.QuantizedLinear
    fp8 = jax.tree.map(np.asarray, JQ.quantize_var_params(p, mode="fp8"))
    leaf = var_params_from_jax(fp8, device="cpu")["blocks"]["fc1_w"]
    assert type(leaf) is Q.FP8Linear and leaf.q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(leaf.q.view(torch.uint8).numpy(),
                                  fp8["blocks"]["fc1_w"].q.view(np.uint8))
    bad = dict(jq, head={"w": (jq["head"]["w"].q, jq["head"]["w"].scale),
                         "b": jq["head"]["b"]})
    with pytest.raises(TypeError, match="tuple"):
        var_params_from_jax(bad, device="cpu")


def test_quantized_kv_cache_layout():
    """Batch-major values (depth, B, L_max, C) int8 and the JAX package's
    (depth, B, L_max) f32 scale planes, scales starting at 1."""
    cfg = VARConfig(**CFG_KW)
    c = Q.QuantizedKVCache.create(cfg, 4, device="cpu")
    C = cfg.num_heads * cfg.head_dim
    assert c.k.shape == c.v.shape == (cfg.depth, 4, cfg.L, C)
    assert c.k.dtype == torch.int8 and c.k_s.dtype == torch.float32
    assert c.k_s.shape == (cfg.depth, 4, cfg.L) and bool((c.v_s == 1).all())
    assert c.max_len == cfg.L
    jc = JQ.QuantizedKVCache.create(JVARConfig(**CFG_KW), 4)
    assert jc.k_s.shape == tuple(c.k_s.shape)
