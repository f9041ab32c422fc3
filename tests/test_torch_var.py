"""Port VAR transformer against the JAX package's: per-scale KV-cached
forward + logits, and the uncached forward under a block-causal bias, on
the same weights (made by the JAX initialiser, biases made non-zero) in
f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.models import var as JM
from sdvar_tpu.ops.masks import block_causal_bias
from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax

PNS = (1, 2, 3)
CFG_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
              head_dim=32)
B2 = 4  # cond ‖ uncond rows


def _jax_params(cfg):
    p = JM.init_var_params(cfg, jax.random.PRNGKey(0))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(0)
    blocks = p["blocks"]
    for name in ("q_bias", "v_bias", "proj_b", "fc1_b", "fc2_b", "ada_lin_b"):
        blocks[name] = rng.standard_normal(blocks[name].shape).astype(np.float32) * 0.05
    blocks["scale_mul"] = blocks["scale_mul"] + rng.standard_normal(
        blocks["scale_mul"].shape).astype(np.float32) * 0.3
    for name in ("head", "head_nm", "word_embed"):
        p[name]["b"] = rng.standard_normal(p[name]["b"].shape).astype(np.float32) * 0.05
    return p


@pytest.fixture(scope="module")
def stack():
    jcfg, tcfg = JVARConfig(**CFG_KW), VARConfig(**CFG_KW)
    p_np = _jax_params(jcfg)
    return jcfg, tcfg, p_np, var_params_from_jax(p_np, device="cpu")


def test_lvl_pos_and_word_embed_match(stack):
    jcfg, tcfg, p_np, p_t = stack
    np.testing.assert_allclose(M.lvl_pos_embed(tcfg, p_t).numpy(),
                               np.asarray(JM.lvl_pos_embed(jcfg, p_np)),
                               rtol=0, atol=0)
    x = np.random.default_rng(1).standard_normal((2, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        M.word_embed(p_t, torch.from_numpy(x), torch.float32).numpy(),
        np.asarray(JM.word_embed(p_np, jnp.asarray(x), jnp.float32)),
        rtol=1e-6, atol=1e-6)


def test_cached_forward_matches_per_scale(stack):
    jcfg, tcfg, p_np, p_t = stack
    rng = np.random.default_rng(2)
    cond = rng.standard_normal((B2, jcfg.embed_dim)).astype(np.float32)
    jcache = JM.KVCache.create(jcfg, B2, dtype=jnp.float32)
    tcache = M.KVCache.create(tcfg, B2, dtype=torch.float32, device="cpu")
    jmods = JM.precompute_modulations(jcfg, p_np, jnp.asarray(cond))
    tmods = M.precompute_modulations(tcfg, p_t, torch.from_numpy(cond))
    np.testing.assert_allclose(tmods.numpy(), np.asarray(jmods),
                               rtol=1e-5, atol=1e-6)
    for si, (bg, ed) in enumerate(jcfg.begin_ends):
        x = rng.standard_normal((B2, ed - bg, jcfg.embed_dim)).astype(np.float32)
        jh, jcache = JM.apply_transformer(
            jcfg, p_np, jnp.asarray(x), jnp.asarray(cond), cache=jcache,
            cache_begin=bg, kv_len=ed, mods=jmods)
        th = M.apply_transformer(tcfg, p_t, torch.from_numpy(x),
                                 torch.from_numpy(cond), cache=tcache,
                                 cache_begin=bg, kv_len=ed, mods=tmods)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                                   rtol=1e-4, atol=1e-4, err_msg=f"scale {si}")
        jl = JM.get_logits(jcfg, p_np, jh, jnp.asarray(cond))
        tl = M.get_logits(tcfg, p_t, th, torch.from_numpy(cond))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4, err_msg=f"scale {si}")
    # cache rows written so far agree (JAX: token-major, port: batch-major)
    np.testing.assert_allclose(
        tcache.k.numpy(), np.asarray(jcache.k).transpose(0, 2, 1, 3),
        rtol=1e-4, atol=1e-4)


def test_uncached_forward_with_block_causal_bias(stack):
    jcfg, tcfg, p_np, p_t = stack
    rng = np.random.default_rng(3)
    L = jcfg.L
    x = rng.standard_normal((2, L, jcfg.embed_dim)).astype(np.float32)
    cond = rng.standard_normal((2, jcfg.embed_dim)).astype(np.float32)
    bias = np.asarray(block_causal_bias(PNS), np.float32)[:L, :L]
    jh, _ = JM.apply_transformer(jcfg, p_np, jnp.asarray(x), jnp.asarray(cond),
                                 attn_bias=jnp.asarray(bias))
    th = M.apply_transformer(tcfg, p_t, torch.from_numpy(x),
                             torch.from_numpy(cond),
                             attn_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)


def test_bridge_carries_bf16_bits():
    """bfloat16 leaves of a JAX tree (numpy's ml_dtypes bfloat16) arrive as
    torch.bfloat16 tensors with the same bits; f32 leaves stay f32."""
    x = jnp.asarray(np.random.default_rng(4).standard_normal((3, 5)),
                    jnp.bfloat16)
    tree = {name: np.asarray(x) for name in
            ("word_embed", "class_emb", "pos_start", "pos_1LC", "lvl_embed",
             "blocks", "head_nm", "head")}
    tree["head"] = {"w": np.asarray(x), "b": np.zeros(5, np.float32)}
    out = var_params_from_jax(tree, device="cpu")
    assert out["class_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["class_emb"].view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
    assert out["head"]["b"].dtype == torch.float32
    with pytest.raises(KeyError):
        var_params_from_jax({"blocks": {}}, device="cpu")


def test_port_init_matches_jax_tree(stack):
    """The port's initialiser builds the JAX package's tree (same keys and
    shapes, from ``jax.eval_shape`` of its initialiser) with its scales:
    trunc-normal weights of std sqrt(1/(3C)), zero biases, AdaLN gains
    shrunk by init_adaln_gamma."""
    jcfg, tcfg, _, _ = stack
    shapes = jax.eval_shape(lambda k: JM.init_var_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tp = M.init_var_params(tcfg, seed=0, device="cpu")

    def walk(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        else:
            assert tuple(b.shape) == a.shape, path

    walk(shapes, tp, ())
    C = tcfg.embed_dim
    std = tp["blocks"]["qkv_w"].std().item()
    assert abs(std - (1 / C / 3) ** 0.5) < 0.1 * std
    assert not tp["blocks"]["fc1_b"].any()
    ada = tp["blocks"]["ada_lin_w"]
    assert ada[:, :, : 2 * C].abs().max() < 1e-3 * ada[:, :, 2 * C:].abs().max()
