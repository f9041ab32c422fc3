"""The slice as a whole: the port's KV-cached CFG decode and image
generation against the JAX package's (greedy, f32), bf16 weights and the
W8A8 + INT8-KV configuration, and the port's own decode invariants (seed
determinism, stepwise == full, cache reuse, per-request seeds independent
of the batch slot)."""

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
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu.ops import quantization as JQ
from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax, vqvae_params_from_jax

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
              head_dim=32)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
F32 = torch.float32


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def stack():
    """Small random stack: VAR weights from the JAX initialiser (head and
    biases given real values so logits are distinct), VQVAE weights from the
    port's initialiser with a unit-scale codebook; both sides run the same
    numpy arrays."""
    jv, jq = JVARConfig(**VAR_KW), JVQVAEConfig(**VAE_KW)
    tv, tq = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    vp = jax.tree.map(np.asarray, JM.init_var_params(jv, jax.random.PRNGKey(11)))
    rng = np.random.default_rng(11)
    vp["head"]["w"] = rng.normal(0, 0.05, vp["head"]["w"].shape).astype(np.float32)
    vp["head"]["b"] = rng.normal(0, 0.05, vp["head"]["b"].shape).astype(np.float32)
    for name in ("q_bias", "v_bias", "fc1_b"):
        vp["blocks"][name] = rng.normal(0, 0.05, vp["blocks"][name].shape).astype(np.float32)
    qp = _numpy_tree(VQ.init_vqvae_params(tq, seed=5, device="cpu", eini=1.0))
    return (jv, jq, tv, tq, vp, qp, var_params_from_jax(vp, device="cpu"),
            vqvae_params_from_jax(qp, device="cpu"))


def test_greedy_generation_matches_jax(stack):
    jv, jq, tv, tq, vp, qp, tvp, tqp = stack
    label = np.array([3, 7])
    f_hat_j, ids_j = JD.decode_all_scales(
        jv, jq, vp, qp["quant"], jnp.asarray(label), jax.random.PRNGKey(0),
        JSamplingConfig(cfg=1.5, top_k=1), jnp.float32, return_ids=True)
    img_j = (np.asarray(jax.jit(JVQ.fhat_to_img, static_argnums=0)(
        jq, qp, f_hat_j)) + 1.0) * 0.5
    samp = SamplingConfig(cfg=1.5, top_k=1)
    f_hat_t, ids_t = D.decode_all_scales(tv, tq, tvp, tqp["quant"], label, 0,
                                         samp, F32, return_ids=True,
                                         device="cpu")
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(f_hat_t.numpy(), np.asarray(f_hat_j),
                               rtol=1e-4, atol=1e-4)
    img_t = D.generate_images(tv, tq, tvp, tqp, label, 0, samp, F32,
                              device="cpu").numpy()
    assert img_t.shape == (2, 3, 48, 48)
    assert img_t.min() >= 0.0 and img_t.max() <= 1.0
    np.testing.assert_allclose(img_t, img_j, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def w8a8(stack):
    """The stack's VAR weights quantized by the JAX package (mode w8a8),
    numpy for JAX and carried over by the bridge for the port."""
    vp = stack[4]
    jq = jax.tree.map(np.asarray, JQ.quantize_var_params(vp, mode="w8a8"))
    return jq, var_params_from_jax(jq, device="cpu")


def test_w8a8_int8_kv_greedy_matches_jax(stack, w8a8):
    """W8A8 weights + INT8 KV cache, greedy, f32: the ids equal JAX's and
    f_hat agrees to 1e-4. f_hat is a function of the ids, so equal ids are
    the real check; at this size no logit pair is close enough for the
    last-bit differences of the quantized forward (test_torch_var) to flip
    a greedy argmax, so every id must agree."""
    jv, jvq, tv, tvq, _, qp, _, tqp = stack
    jq, tq8 = w8a8
    label = np.array([3, 7])
    f_hat_j, ids_j = JD.decode_all_scales(
        jv, jvq, jq, qp["quant"], jnp.asarray(label), jax.random.PRNGKey(0),
        JSamplingConfig(cfg=1.5, top_k=1), jnp.float32, return_ids=True,
        kv_mode="int8")
    f_hat_t, ids_t, cache = D.decode_all_scales(
        tv, tvq, tq8, tqp["quant"], label, 0, SamplingConfig(cfg=1.5, top_k=1),
        F32, return_ids=True, kv_mode="int8", return_cache=True, device="cpu")
    assert isinstance(cache, QuantizedKVCache) and cache.k.dtype == torch.int8
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(f_hat_t.numpy(), np.asarray(f_hat_j),
                               rtol=1e-4, atol=1e-4)


def test_int8_cache_reuse_gives_same_result(stack, w8a8):
    """A passed QuantizedKVCache, full of another decode's tokens, gives
    the result of a fresh one: every scale reads only rows it wrote."""
    _, _, tv, tvq, _, _, _, tqp = stack
    tq8 = w8a8[1]
    samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9)

    def run(labels, seed, cache=None):
        return D.decode_all_scales(tv, tvq, tq8, tqp["quant"], labels, seed,
                                   samp, F32, return_ids=True, kv_mode="int8",
                                   cache=cache, return_cache=True, device="cpu")

    fresh, fresh_ids, _ = run([4, 6], 1)
    _, _, cache = run([9, 0], 2)
    again, again_ids, same = run([4, 6], 1, cache)
    assert same is cache
    torch.testing.assert_close(again_ids, fresh_ids, rtol=0, atol=0)
    torch.testing.assert_close(again, fresh, rtol=0, atol=0)


def test_deterministic_under_seed(stack):
    _, _, tv, tq, _, _, tvp, tqp = stack
    samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9)

    def run(seed):
        return D.decode_all_scales(tv, tq, tvp, tqp["quant"], [1, 2], seed,
                                   samp, F32, return_ids=True, device="cpu")

    (a, ia), (b, ib), (c, ic) = run(42), run(42), run(43)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ia, ib, rtol=0, atol=0)
    assert not torch.equal(ia, ic)


def test_stepwise_equals_full(stack):
    _, _, tv, tq, _, _, tvp, tqp = stack
    samp = SamplingConfig(cfg=1.0, top_k=4)
    full, full_ids = D.decode_all_scales(tv, tq, tvp, tqp["quant"], [5], 7,
                                         samp, F32, return_ids=True,
                                         device="cpu")
    state, sos, lvl_pos = D.init_decode(tv, tvp, [5], 7, F32, device="cpu")
    ids_all = []
    for si in range(tv.num_scales):
        state, ids = D.scale_step(tv, tq, tvp, tqp["quant"], si, state, sos,
                                  lvl_pos, samp, F32)
        ids_all.append(ids)
    torch.testing.assert_close(torch.cat(ids_all, dim=1), full_ids,
                               rtol=0, atol=0)
    torch.testing.assert_close(state.f_hat, full, rtol=1e-5, atol=1e-5)


def test_cache_reuse_gives_same_result(stack):
    _, _, tv, tq, _, _, tvp, tqp = stack
    samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9)
    fresh = D.decode_all_scales(tv, tq, tvp, tqp["quant"], [4, 6], 1, samp,
                                F32, kv_mode="f32", device="cpu")
    _, cache = D.decode_all_scales(tv, tq, tvp, tqp["quant"], [9, 0], 2, samp,
                                   F32, kv_mode="f32", return_cache=True,
                                   device="cpu")
    again = D.decode_all_scales(tv, tq, tvp, tqp["quant"], [4, 6], 1, samp,
                                F32, kv_mode="f32", cache=cache, device="cpu")
    torch.testing.assert_close(again, fresh, rtol=0, atol=0)


def test_request_independent_of_batch_slot(stack):
    _, _, tv, tq, _, _, tvp, tqp = stack
    samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9)
    _, ids = D.decode_all_scales(tv, tq, tvp, tqp["quant"], [1, 2], [10, 20],
                                 samp, F32, return_ids=True, device="cpu")
    _, ids_sw = D.decode_all_scales(tv, tq, tvp, tqp["quant"], [2, 1], [20, 10],
                                    samp, F32, return_ids=True, device="cpu")
    torch.testing.assert_close(ids_sw, ids[[1, 0]], rtol=0, atol=0)


def test_entry_points_turn_tf32_off_and_restore_it(stack, monkeypatch):
    """The f32 parts of the path run with TF32 off, and the caller's own
    TF32 setting is back once the entry point returns."""
    _, _, tv, tq, _, _, tvp, tqp = stack
    seen = []

    def spy(fn):
        def wrapped(*a, **kw):
            seen.append((fn.__name__, torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(D.M, "get_logits", spy(D.M.get_logits))
    monkeypatch.setattr(VQ, "decoder_forward", spy(VQ.decoder_forward))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    D.generate_images(tv, tq, tvp, tqp, [1, 2], 0, SamplingConfig(top_k=4),
                      F32, device="cpu")
    assert {name for name, _, _ in seen} == {"get_logits", "decoder_forward"}
    assert all(not mm and not cd for _, mm, cd in seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
