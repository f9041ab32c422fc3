"""The sampler kernel's design on the CPU: an emulation of its select
(``csrc/sampler.cu``: linear bins, an exact ranking of the chosen bin, the
radix digit passes of a crowded bin; integer weights) against the 32-step
bisection of the plain version, its nucleus rule (exact fixed-point
masses) against ``sample_plain``'s masks, and the launch geometry of
``sampler_plan``."""

import math

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.ops.kernels.sampling import (
    CANDIDATES,
    LINEAR_BINS,
    MASS_BITS,
    RADIX_DIGITS,
    _bisect,
    gumbel_from_bits,
    rowhash_bits,
    sample_kernel,
    sample_plain,
    sampler_plan,
)


def keys_of(x: np.ndarray) -> np.ndarray:
    """f32 -> the kernel's uint32 key (ordered image, sign bit flipped),
    as int64."""
    i = x.astype(np.float32).view(np.int32).astype(np.int64)
    u = np.where(i >= 0, i, i ^ 0x7FFFFFFF)
    return (u & 0xFFFFFFFF) ^ 0x80000000


LBINS = LINEAR_BINS[0] * LINEAR_BINS[1]  # coarse x fine: 2048 linear bins
CAND = CANDIDATES


def from_key(k):
    u = np.int64(k) ^ 0x80000000
    u = u - (1 << 32) if u >= 1 << 31 else u
    i = u if u >= 0 else u ^ 0x7FFFFFFF
    return np.array([i], np.int64).astype(np.int32).view(np.float32)[0]


def hist_pick(bins, weights, nb, target):
    """A histogram pass: the largest bin whose weight from the top reaches
    the target, and the weight above it."""
    hist = np.zeros(nb, np.int64)
    np.add.at(hist, bins, weights)
    suffix = np.cumsum(hist[::-1])[::-1]  # weight of bins >= b
    b = int(np.nonzero(suffix >= target)[0].max())
    return b, (int(suffix[b + 1]) if b + 1 < nb else 0)


def radix_passes(keys, weights, target):
    """The fallback: MSB-first digits of RADIX_DIGITS bits over the keys."""
    prefix = pmask = 0
    shift = 32
    for bits in RADIX_DIGITS:
        shift -= bits
        nb = 1 << bits
        m = (keys & pmask) == prefix
        d, above = hist_pick((keys[m] >> shift) & (nb - 1), weights[m], nb, target)
        target -= above
        prefix |= d << shift
        pmask |= (nb - 1) << shift
    assert shift == 0
    return prefix


def select_key(keys, x, part, weights, target=None, top_p=None, radix=False):
    """The kernel's select on one row: the largest key whose weight from
    the top (over the participants) reaches the target; with ``top_p`` the
    target is ceil(top_p * total) in f64. Linear bins of x in f32 over the
    participants' range, then the chosen bin ranked exactly (at most CAND
    elements) or by the digit passes; ``radix``: the digit passes over the
    whole row."""
    keys, x, weights = keys[part], x[part], weights[part]
    if top_p is not None:
        target = int(math.ceil(float(np.float32(top_p)) * float(weights.sum())))
    if radix:
        return radix_passes(keys, weights, target)
    lo = from_key(keys.min())
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        rng = np.float32(from_key(keys.max()) - lo)
        scale = np.float32(LBINS) / rng if 0 < rng < np.float32(3.4e38) else np.float32(0)
        if not scale < np.float32(3.4e38):
            scale = np.float32(0)
        bins = (np.zeros(len(x), np.int64) if scale == 0 else
                np.minimum((np.float32(x - lo) * scale).astype(np.int64), LBINS - 1))
    b, above = hist_pick(bins, weights, LBINS, target)
    target -= above
    ck, cw = keys[bins == b], weights[bins == b]
    if ck.min() == ck.max():
        return int(ck[0])
    if len(ck) <= CAND:
        for k in ck:
            over, same = cw[ck > k].sum(), cw[ck == k].sum()
            if over < target <= over + same:
                return int(k)
        raise AssertionError("no key crosses the target")
    return radix_passes(ck, cw, target)


def emulate(x: np.ndarray, top_k: int, top_p: float, g: np.ndarray):
    """The kernel's function on (M, V) rows: keep mask and ids."""
    M, V = x.shape
    keys = keys_of(x)
    keep = np.ones((M, V), bool)
    ids = np.zeros(M, np.int32)
    every = np.ones(V, bool)
    for r in range(M):
        kth = 0
        if 0 < top_k < V:
            kth = select_key(keys[r], x[r], every, np.ones(V, np.int64), target=top_k)
        thr = kth
        if 0.0 < top_p < 1.0:
            xm = from_key(keys[r].max())
            with np.errstate(over="ignore"):  # -3e38 - 3e38 = -inf: e = 0
                e = np.exp((x[r] - xm).astype(np.float32)).astype(np.float32)
            w = np.rint(e.astype(np.float64) * 2.0 ** MASS_BITS).astype(np.int64)
            thr = max(kth, select_key(keys[r], x[r], keys[r] >= kth, w, top_p=top_p))
        keep[r] = keys[r] >= thr
        score = np.where(keep[r], (x[r] + g[r]).astype(np.float32), np.float32(-1e30))
        ids[r] = int(np.argmax(score))
    return keep, ids


def _ties_rows():
    row = np.full((4096,), -5.0, np.float32)
    row[:10] = 3.0
    row[10:20] = 1.0
    return np.stack([row, np.full(4096, 0.25, np.float32),
                     np.full(4096, -0.0, np.float32)])


def _extreme_rows():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    x[:, :4] = [3e38, -3e38, 0.0, -0.0]
    x[:, 4:8] = 1e-38
    x[1, 8:600] = 0.0
    x[1, 600:1200] = -0.0
    x[2] = -3e38
    x[2, 17] = -1e-38
    return x


def _rows(kind):
    if kind == "ties":
        return _ties_rows()
    if kind == "extreme":
        return _extreme_rows()
    rng = np.random.default_rng(3)
    return (rng.standard_normal((6, 4096)) * 4).astype(np.float32)


@pytest.mark.parametrize("radix", [False, True])
@pytest.mark.parametrize("kind", ["normal", "ties", "extreme"])
@pytest.mark.parametrize("top_k", [1, 15, 900, 4095, 4096])
def test_select_equals_bisection(kind, top_k, radix):
    """The select (linear bins and an exact ranking, or the digit passes
    alone) finds the 32-step bisection's threshold exactly: ties, +-0.0,
    +-3e38, 1e-38, all-equal rows, k = 1, V - 1 and V."""
    x = _rows(kind)
    M, V = x.shape
    u = torch.from_numpy(x).view(torch.int32)
    u = torch.where(u >= 0, u, u ^ 0x7FFFFFFF)
    lo = _bisect(lambda t: (u >= t).sum(-1) >= top_k, M, "cpu")
    want = (lo.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    keys = keys_of(x)
    for r in range(M):
        got = select_key(keys[r], x[r], np.ones(V, bool), np.ones(V, np.int64),
                         target=top_k, radix=radix)
        assert got == int(want[r]), (kind, top_k, r)
        assert (keys[r] >= got).sum() >= top_k
        assert (keys[r] > got).sum() < top_k


@pytest.mark.parametrize("kind", ["normal", "ties", "extreme"])
@pytest.mark.parametrize("top_k", [1, 15, 900, 4095])
def test_emulated_topk_bit_equal_to_plain(kind, top_k):
    """With top_p = 0 the kernel's rule gives the plain version's masks and
    ids bit for bit (explicit noise and the row hash)."""
    x = _rows(kind)
    M, V = x.shape
    rng = np.random.default_rng(top_k)
    seeds = rng.integers(-2 ** 31, 2 ** 31, M, dtype=np.int64).astype(np.int32)
    g = gumbel_from_bits(rowhash_bits(torch.from_numpy(seeds), V)).numpy()
    keep, ids = emulate(x, top_k, 0.0, g)
    ids_p, mask_p = sample_plain(torch.from_numpy(x), torch.from_numpy(seeds),
                                 top_k, 0.0, return_mask=True)
    np.testing.assert_array_equal(keep, mask_p.numpy().astype(bool))
    np.testing.assert_array_equal(ids, ids_p.numpy())


@pytest.mark.parametrize("top_k,top_p", [(900, 0.96), (0, 0.9), (128, 0.5),
                                         (4096, 0.96)])
def test_emulated_nucleus_against_plain(top_k, top_p):
    """The nucleus over exact fixed-point masses against the plain
    version's f32 bisection: masks and ids equal on at least 0.999 of the
    rows (here all of them), and on the tie and extreme rows."""
    rng = np.random.default_rng(top_k + 7)
    x = np.concatenate([(rng.standard_normal((60, 1024)) * 4).astype(np.float32),
                        _ties_rows()[:, :1024], _extreme_rows()[:, :1024]])
    noise = rng.gumbel(size=x.shape).astype(np.float32)
    keep, ids = emulate(x, top_k, top_p, noise)
    ids_p, mask_p = sample_plain(torch.from_numpy(x), None, top_k, top_p,
                                 noise=torch.from_numpy(noise), return_mask=True)
    rows = (keep == mask_p.numpy().astype(bool)).all(-1) & (ids == ids_p.numpy())
    assert rows.mean() >= 0.999, np.nonzero(~rows)


def test_nucleus_masses_fit():
    """A row of 8192 masses of at most 2^MASS_BITS sums to at most 2^63:
    the kernel's unsigned 64-bit sums cannot overflow, and a warp's 32
    masses summed in 21-bit pieces stay below 2^32 a piece."""
    assert 8192 * 2 ** MASS_BITS <= 2 ** 63
    assert 32 * (2 ** 21 - 1) < 2 ** 32 and 32 * (2 ** (MASS_BITS - 42) + 1) < 2 ** 32
    assert sum(RADIX_DIGITS) == 32 and len(set(RADIX_DIGITS)) == 1
    assert LINEAR_BINS == (32, 64)  # five ballot bits, then 64 fine bins


PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)


@pytest.mark.parametrize("rows_per_token", [16, 32, 64])
def test_plan_at_the_ten_scales(rows_per_token):
    """One block a row at every scale's M; V = 4096 (the decode's vocab,
    and the 1x2 mesh's rows gathered over "model") takes 256 threads of
    four 16-byte chunks, and its shared memory (the row, the kept columns,
    the fallback's histogram, the candidates and the coarse bins' per-warp
    weights) fits the default 48 KB: five blocks an SM."""
    for pn in PNS:
        M = rows_per_token * pn * pn
        p = sampler_plan(M, 4096)
        assert (p["grid"], p["threads"]) == (M, 256)
        assert p["smem_bytes"] == (2 * 4 * 4096 + (256 + 256) * 8 + 128 * 12
                                   + 256 // 32 * 256)
        assert 5 * p["smem_bytes"] <= 228 * 1024 and p["smem_bytes"] <= 48 * 1024


@pytest.mark.parametrize("V", [4, 64, 100, 1000, 2048, 4096, 6000, 8192])
def test_plan_covers_the_row(V):
    p = sampler_plan(8, V)
    t = p["threads"]
    assert t & (t - 1) == 0 and 32 <= t <= 256
    assert t * 32 >= V and (t == 32 or t * 2 < V)
    assert (1 << RADIX_DIGITS[0]) % t == 0 and p["smem_bytes"] <= 232448


@pytest.mark.parametrize("V", [4098, 8196, 2, 0])
def test_plan_refuses_rows_it_does_not_take(V):
    with pytest.raises(ValueError, match="multiple of 4"):
        sampler_plan(4, V)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        sample_kernel(torch.zeros(4, 64), torch.zeros(4, dtype=torch.int32))
