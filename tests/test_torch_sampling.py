"""Port sampler (plain version, the CPU path) against the JAX package's
Pallas sampler in interpret mode: hash bits, keep masks and ids with
explicit noise, ids on the row-hash path, and the CFG helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdvar_tpu.ops import sampling as JS
from sdvar_tpu.ops.pallas.sampling import _rowhash_bits, fused_sample
from sdvar_tpu_torch.ops import sampling as S
from sdvar_tpu_torch.ops.kernels.sampling import rowhash_bits, sample_plain


def test_rowhash_bits_equal():
    rng = np.random.default_rng(0)
    seeds = rng.integers(-2 ** 31, 2 ** 31, size=16, dtype=np.int64).astype(np.int32)
    seeds[:3] = [0, -1, 2 ** 31 - 1]
    want = np.asarray(_rowhash_bits(jnp.asarray(seeds)[:, None], 16, 512))
    got = rowhash_bits(torch.from_numpy(seeds), 512).numpy()
    np.testing.assert_array_equal(got, want.view(np.uint32).astype(np.int64))


def _ties_row():
    row = np.full((4096,), -5.0, np.float32)
    row[:10] = 3.0          # 10-way tie above
    row[10:20] = 1.0        # tie exactly at the k=15 boundary
    return np.tile(row, (8, 1))


def _extreme_row():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 4096)).astype(np.float32)
    x[:, :4] = [3e38, -3e38, 0.0, -0.0]
    x[:, 4:8] = 1e-38
    return x


@pytest.mark.parametrize("top_k,top_p,kind", [
    (900, 0.96, "normal"), (900, 0.0, "normal"), (128, 0.5, "normal"),
    (4096, 0.96, "normal"), (1, 0.96, "normal"), (0, 0.9, "normal"),
    (15, 0.0, "ties"), (15, 0.5, "ties"), (100, 0.9, "extreme"),
])
def test_masks_and_ids_match_pallas(top_k, top_p, kind):
    rng = np.random.default_rng(1)
    if kind == "ties":
        logits = _ties_row()
    elif kind == "extreme":
        logits = _extreme_row()
    else:
        logits = rng.standard_normal((8, 4096)).astype(np.float32) * 4
    noise = rng.gumbel(size=logits.shape).astype(np.float32)
    want_ids, want_mask = fused_sample(
        jnp.asarray(logits), jnp.int32(7), top_k, top_p,
        noise=jnp.asarray(noise), interpret=True, return_mask=True)
    ids, mask = sample_plain(torch.from_numpy(logits), None, top_k, top_p,
                             noise=torch.from_numpy(noise), return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))


@pytest.mark.parametrize("top_k,top_p", [(64, 0.9), (5, 0.0)])
def test_row_seed_ids_match_pallas(top_k, top_p):
    rng = np.random.default_rng(2)
    M, V = 256, 512
    logits = rng.standard_normal((M, V)).astype(np.float32) * 2
    seeds = rng.integers(-2 ** 31, 2 ** 31, size=M, dtype=np.int64).astype(np.int32)
    want = np.asarray(fused_sample(jnp.asarray(logits), jnp.int32(0), top_k,
                                   top_p, row_seeds=jnp.asarray(seeds),
                                   interpret=True))
    got = sample_plain(torch.from_numpy(logits), torch.from_numpy(seeds),
                       top_k, top_p).numpy()
    # -log(-log(u)) may differ in the last ulp between frameworks
    assert (got == want).mean() >= 0.99


def test_row_seeds_depend_on_request_scale_and_position_only():
    req = S.request_seeds([11, 22, 33], 3, "cpu")
    rows = S.row_seeds(req, 4, 9).reshape(3, 9)
    # the same request in another slot gets the same stream
    swapped = S.row_seeds(req[[2, 0, 1]], 4, 9).reshape(3, 9)
    torch.testing.assert_close(swapped, rows[[2, 0, 1]])
    # scales and positions get distinct streams
    assert len(set(rows.flatten().tolist())) == 27
    assert not torch.equal(S.row_seeds(req, 5, 9), rows.flatten())
    # an int seed is deterministic and differs from another int seed
    torch.testing.assert_close(S.request_seeds(5, 4, "cpu"),
                               S.request_seeds(5, 4, "cpu"))
    assert not torch.equal(S.request_seeds(5, 4, "cpu"),
                           S.request_seeds(6, 4, "cpu"))


@pytest.mark.parametrize("t", [0.0, 0.75, "vector"])
def test_cfg_helpers_match_jax(t):
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, 5, 16)).astype(np.float32)
    uncond = rng.standard_normal((2, 5, 16)).astype(np.float32)
    pair_j = JS.cfg_pair(jnp.asarray(cond), jnp.asarray(uncond))
    pair_t = S.cfg_pair(torch.from_numpy(cond), torch.from_numpy(uncond))
    np.testing.assert_array_equal(pair_t.numpy(), np.asarray(pair_j))
    for a, b in zip(S.cfg_halves(pair_t), JS.cfg_halves(pair_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(S.cfg_double(torch.from_numpy(cond)).numpy(),
                                  np.asarray(JS.cfg_double(jnp.asarray(cond))))
    if t == "vector":
        tv = np.linspace(0.1, 1.5, 5).astype(np.float32)
        tj, tt = jnp.asarray(tv), torch.from_numpy(tv)
    else:
        tj = tt = t
    np.testing.assert_allclose(S.cfg_mix(pair_t, tt).numpy(),
                               np.asarray(JS.cfg_mix(pair_j, tj)),
                               rtol=0, atol=0)


def test_greedy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 64)).astype(np.float32)
    logits[0, 0, [3, 9]] = 10.0  # a tie: both take the first index
    np.testing.assert_array_equal(S.greedy(torch.from_numpy(logits)).numpy(),
                                  np.asarray(JS.greedy(jnp.asarray(logits))))


def test_fold_seeds_is_a_pure_per_request_function():
    """fold_seeds(seed, data): each request's sub-stream depends on its
    own seed and ``data`` only (not on its slot), stays in [0, 2^32), and
    the draft, target and retry streams differ from each other and from
    the request's own."""
    req = S.request_seeds([7, 123456789, 2 ** 32 - 1], 3, "cpu")
    a = S.fold_seeds(req, 1)
    assert torch.equal(a, S.fold_seeds(req, 1))
    assert torch.equal(S.fold_seeds(req.flip(0), 1), a.flip(0))
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    streams = [req, a, S.fold_seeds(req, 2), S.fold_seeds(a, 1001)]
    for i in range(len(streams)):
        for j in range(i):
            assert not (streams[i] == streams[j]).any()
