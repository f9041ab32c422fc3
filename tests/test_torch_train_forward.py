"""The port's training forward and the gradient through the attention
against the JAX package's, on a tiny VAR (depth 2, head_dim 32, V=64,
scales 1-2-3) made by the JAX initialiser, f32.

- ``var_train_forward`` without draws, and with JAX's own draws (cond
  drop, drop path and dropout all above 0) rebuilt from its key with the
  same ``fold_in`` / ``bernoulli`` calls and handed to both: logits within
  1e-5 of max|logit|; at ``prog_si`` 1 too; ``remat=True`` gives the
  logits and gradients of ``remat=False``.
- ``AttentionFn``'s dq/dk/dv/dbias against ``jax.grad`` through
  ``pallas_attention`` in interpret mode, within 1e-5 of each tensor's
  size, for the whole-tensor VJP and for forced chunks (one ragged).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.models import var as JM
from sdvar_tpu.ops.pallas import attention as JPA
from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.ops import attention as A
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax

PNS = (1, 2, 3)
KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
          head_dim=32)
DET = dict(KW, cond_drop_rate=0.0, drop_path_rate=0.0)
DRAWS = dict(KW, cond_drop_rate=0.5, drop_path_rate=0.4, drop_rate=0.2)
B = 4


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, size = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * size, (err, size)


@pytest.fixture(scope="module")
def stack():
    """JAX-initialised parameters (biases and AdaLN biases drawn, so every
    block takes part), the port's copy, labels and teacher-forcing input."""
    p = jax.tree.map(np.asarray, JM.init_var_params(JVARConfig(**DET),
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    blocks = p["blocks"]
    for name in ("q_bias", "v_bias", "proj_b", "fc1_b", "fc2_b"):
        blocks[name] = rng.normal(0, 0.05, blocks[name].shape).astype(np.float32)
    blocks["ada_lin_b"] = rng.normal(0, 0.3, blocks["ada_lin_b"].shape
                                     ).astype(np.float32)
    L = JVARConfig(**DET).L
    x = rng.standard_normal((B, L - 1, 8)).astype(np.float32)
    label = np.array([1, 4, 7, 9], np.int32)
    return p, var_params_from_jax(p, device="cpu"), x, label


def _jax_masks(cfg: JVARConfig, key, ed: int):
    """JAX's draws for ``var_train_forward(train_key=key)``, rebuilt with
    its own fold_in / bernoulli calls."""
    C = cfg.embed_dim
    out = {"cond_drop": np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0xC0DE), (B,)) < cfg.cond_drop_rate)}
    dp_key = jax.random.fold_in(key, 0xD80)
    dpr = jnp.linspace(0.0, cfg.dpr, cfg.depth)
    path, drop = [], []
    for li in range(cfg.depth):
        path.append([np.asarray(jax.random.bernoulli(
            jax.random.fold_in(dp_key, 2 * li + j), 1.0 - dpr[li],
            (B, 1, 1)))[:, 0, 0] for j in (0, 1)])
        lk = jax.random.fold_in(dp_key, li)
        drop.append([np.asarray(jax.random.bernoulli(
            jax.random.fold_in(lk, fold), 1.0 - cfg.drop_rate, (B, ed, C)))
            for fold in (0xD0A, 0xD0F)])
    return {"cond_drop": torch.from_numpy(out["cond_drop"]),
            "path_keep": torch.from_numpy(np.array(path)),
            "drop_keep": torch.from_numpy(np.array(drop))}


@pytest.mark.parametrize("prog_si", [-1, 1])
def test_train_forward_without_draws_matches_jax(stack, prog_si):
    p, tp, x, label = stack
    want = JM.var_train_forward(JVARConfig(**DET), p, jnp.asarray(label),
                                jnp.asarray(x), prog_si=prog_si)
    got = M.var_train_forward(VARConfig(**DET), tp, torch.from_numpy(label),
                              torch.from_numpy(x), prog_si=prog_si)
    _close(got.detach(), want)


@pytest.mark.parametrize("prog_si", [-1, 1])
def test_train_forward_with_jax_draws_matches_jax(stack, prog_si):
    p, tp, x, label = stack
    jcfg, cfg = JVARConfig(**DRAWS), VARConfig(**DRAWS)
    key = jax.random.PRNGKey(7)
    ed = cfg.L if prog_si < 0 else cfg.begin_ends[prog_si][1]
    masks = _jax_masks(jcfg, key, ed)
    assert masks["cond_drop"].any() and not masks["path_keep"].all()
    want = JM.var_train_forward(jcfg, p, jnp.asarray(label), jnp.asarray(x),
                                train_key=key, prog_si=prog_si)
    got = M.var_train_forward(cfg, tp, torch.from_numpy(label),
                              torch.from_numpy(x), masks=masks,
                              prog_si=prog_si)
    _close(got.detach(), want)
    # the port's own draws differ from JAX's but keep their rates' shapes
    gen = torch.Generator().manual_seed(0)
    draws = M.draw_train_masks(cfg, B, ed, gen, "cpu")
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        k: tuple(v.shape) for k, v in masks.items()}
    assert bool(draws["path_keep"][0].all())  # layer 0's rate is 0


def test_remat_matches_plain_logits_and_gradients(stack):
    _, tp, x, label = stack
    cfg = VARConfig(**DRAWS)
    masks = M.draw_train_masks(cfg, B, cfg.L, torch.Generator().manual_seed(3),
                               "cpu")
    out = []
    for remat in (False, True):
        leaves = {k: v.detach().requires_grad_() for k, v in tp["blocks"].items()}
        params = dict(tp, blocks=leaves)
        lg = M.var_train_forward(cfg, params, torch.from_numpy(label),
                                 torch.from_numpy(x), masks=masks, remat=remat)
        loss = (lg ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append((lg.detach(), grads))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_count_params_matches_jax(stack):
    p, tp, _, _ = stack
    assert M.count_params(tp) == JM.count_params(p)


# ---------------------------------------------------------------------------
# the gradient through the attention
# ---------------------------------------------------------------------------

def _att_inputs(Lq, Lk, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, Lq, 2, 32), (2, Lk, 2, 32), (2, Lk, 2, 32), (2, Lq, 2, 32)))
    bias = np.where(rng.uniform(size=(Lq, Lk)) < 0.2, -1e9,
                    rng.normal(0, 0.5, (Lq, Lk))).astype(np.float32)
    return q, k, v, bias, g


@pytest.mark.parametrize("chunk", [None, 16, 12])
def test_attention_gradient_matches_jax(chunk):
    """The whole-tensor VJP (chunk None: Lq*Lk is small), then forced
    chunks of 16 and 12 rows over Lq = 40 (12 leaves a ragged last chunk,
    which JAX pads)."""
    q, k, v, bias, g = _att_inputs(40, 56)

    def jloss(q, k, v, b):
        return jnp.sum(JPA.pallas_attention(q, k, v, b, 0.2, interpret=True) * g)

    JPA.set_attention_bwd_chunk(chunk)
    A.set_attention_bwd_chunk(chunk)
    try:
        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(q, k, v, bias)
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
        out = A.attention(*ts[:3], ts[3], 0.2)
        got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    finally:
        JPA.set_attention_bwd_chunk(None)
        A.set_attention_bwd_chunk(None)
    for a, b in zip(got, want):
        _close(a, b)


def test_attention_gradient_chunk_choice_matches_jax():
    for Lq, Lk in ((680, 680), (2240, 2240), (9451, 9451), (10, 200000),
                   (424, 4000), (1500, 1500)):
        assert A.bwd_chunk_for(Lq, Lk) == JPA._bwd_chunk_for(Lq, Lk)


def test_attention_without_grad_skips_the_function():
    """Under no_grad (inference) the dispatch calls the plain version (the
    kernel on the card) directly: no autograd node."""
    q, k, v, bias, _ = (torch.from_numpy(a) for a in _att_inputs(8, 8))
    with torch.no_grad():
        out = A.attention(q.requires_grad_(), k, v, bias, 0.2)
    assert out.grad_fn is None
    out = A.attention(q, k, v, bias, 0.2)
    assert type(out.grad_fn).__name__ == "AttentionFnBackward"
