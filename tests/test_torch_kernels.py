"""The port's kernels against their plain versions on the card (marked
``gpu``; they skip where there is no card).

Run them on a machine with an NVIDIA card (``--noconftest``: the tests'
conftest imports JAX, which the port does not need there):
    python -m pytest tests/test_torch_kernels.py -q -m gpu -o addopts="" --noconftest
"""

import math

import pytest
import torch

from sdvar_tpu_torch.ops.kernels.attention import (
    attention_cache_kernel,
    attention_cache_plain,
    attention_cache_write_kernel,
    attention_cache_write_plain,
    attention_kernel,
    attention_plain,
)
from sdvar_tpu_torch.ops.kernels.conv_s8 import (
    conv3x3_s8_kernel,
    conv3x3_s8_plain,
    conv_plan,
)
from sdvar_tpu_torch.ops.kernels.matmul_int8 import int8_matmul_kernel, int8_matmul_plain
from sdvar_tpu_torch.ops.kernels.quantize import (
    act_quantize_kernel,
    act_quantize_plain,
    act_scale_kernel,
    act_scale_plain,
)
from sdvar_tpu_torch.ops.kernels.sampling import sample_kernel, sample_plain
from sdvar_tpu_torch.ops.kernels.w8a8_fused import w8a8_fused_kernel, w8a8_fused_plain
from sdvar_tpu_torch.ops.quantization import k_major, quantize_tokens

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(monkeypatch):
    """The card, with full-f32 matmuls for the plain versions' yardstick;
    the caller's TF32 setting comes back after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("Lq,Lk", [(1, 1), (64, 155), (169, 424)])
def test_attention_kernel_matches_plain(cuda, dtype, hd, Lq, Lk):
    g = torch.Generator(device=cuda).manual_seed(Lq * 1000 + Lk + hd)
    B, H = 4, 3
    q = torch.randn(B, Lq, H, hd, device=cuda, generator=g).to(dtype)
    cache = torch.randn(2, B, Lk + 7, H * hd, device=cuda, generator=g).to(dtype)
    k = cache[0, :, :Lk].view(B, Lk, H, hd)  # strided cache-slice views
    v = cache[1, :, :Lk].view(B, Lk, H, hd)
    got = attention_kernel(q, k, v, None, 1.0).float()
    want = attention_plain(q, k, v, None, 1.0).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_attention_kernel_bias_and_masked_row(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, hd, Lq, Lk = 2, 2, 64, 70, 90
    q, k, v = (torch.randn(B, L, H, hd, device=cuda, generator=g)
               for L in (Lq, Lk, Lk))
    bias = torch.randn(Lq, Lk, device=cuda, generator=g)
    bias[:, ::3] = float("-inf")
    bias[-1] = float("-inf")
    got = attention_kernel(q, k, v, bias, 0.125)
    torch.testing.assert_close(got, attention_plain(q, k, v, bias, 0.125),
                               rtol=1e-4, atol=1e-4)
    assert not got[:, -1].any()


@pytest.mark.parametrize("M", [16, 100, 512, 4096])
@pytest.mark.parametrize("top_k,top_p", [(900, 0.96), (900, 0.0), (1, 0.0),
                                         (0, 0.9)])
def test_sampler_kernel_matches_plain(cuda, top_k, top_p, M):
    """M from the decode's first scale (16 rows) to its last (4096)."""
    g = torch.Generator(device=cuda).manual_seed(top_k)
    V = 4096
    logits = torch.randn(M, V, device=cuda, generator=g) * 4
    noise = -torch.log(-torch.log(torch.rand(M, V, device=cuda, generator=g)))
    ids, mask = sample_kernel(logits, None, top_k, top_p, noise=noise,
                              return_mask=True)
    ids_p, mask_p = sample_plain(logits, None, top_k, top_p, noise=noise,
                                 return_mask=True)
    rows = (mask == mask_p).all(-1) & (ids == ids_p)
    assert rows.float().mean() >= (1.0 if top_p == 0.0 else 0.999)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (M,), device=cuda,
                          generator=g, dtype=torch.int32)
    agree = sample_kernel(logits, seeds, top_k, top_p) == sample_plain(
        logits, seeds, top_k, top_p)
    assert agree.float().mean() >= 0.999


def _odd_rows(dev):
    """Tie and extreme rows: a 10-way tie above and a tie at the k=15 edge,
    all-equal rows (0.25, -0.0), +-3e38 with +-0.0 and 1e-38, a row of
    -3e38 with one -1e-38, runs of +0.0 and -0.0 beside +-3e38."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(8, 4096, device=dev, generator=g)
    x[0] = -5.0
    x[0, :10], x[0, 10:20] = 3.0, 1.0
    x[1], x[2] = 0.25, -0.0
    x[3, :4] = torch.tensor([3e38, -3e38, 0.0, -0.0])
    x[3, 4:8] = 1e-38
    x[4] = -3e38
    x[4, 17] = -1e-38
    x[5, :2] = torch.tensor([3e38, -3e38])
    x[5, 8:600], x[5, 600:1200] = 0.0, -0.0
    return x


@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("top_k,top_p", [(1, 0.0), (15, 0.0), (900, 0.0),
                                         (4095, 0.0), (15, 0.5), (0, 0.9),
                                         (100, 0.9)])
def test_sampler_kernel_on_tie_and_extreme_rows(cuda, top_k, top_p, M):
    """The odd rows (with normal rows around them at M=256): masks and ids
    bit-equal to the plain version with top_p = 0, and on these rows with
    top_p set too (their masses are exact in f32)."""
    g = torch.Generator(device=cuda).manual_seed(M)
    logits = torch.randn(M, 4096, device=cuda, generator=g) * 4
    logits[:8] = _odd_rows(cuda)
    noise = -torch.log(-torch.log(torch.rand(M, 4096, device=cuda, generator=g)))
    ids, mask = sample_kernel(logits, None, top_k, top_p, noise=noise,
                              return_mask=True)
    ids_p, mask_p = sample_plain(logits, None, top_k, top_p, noise=noise,
                                 return_mask=True)
    assert torch.equal(mask[:8], mask_p[:8]) and torch.equal(ids[:8], ids_p[:8])
    rows = (mask == mask_p).all(-1) & (ids == ids_p)
    assert rows.float().mean() >= (1.0 if top_p == 0.0 else 0.999)


@pytest.mark.parametrize("M", [2, 18, 300])
@pytest.mark.parametrize("V", [64, 128, 1000, 2048, 8192])
@pytest.mark.parametrize("top_k,top_p", [(1, 0.0), (15, 0.0), (15, 0.5),
                                         (0, 0.9)])
def test_sampler_kernel_at_other_widths(cuda, V, M, top_k, top_p):
    """Rows narrower and wider than the decode's (32 to 256 threads, one to
    eight chunks a thread; the small stack's V=64 greedy rows). With top_p
    set, the 0.999-of-rows gate is taken over at least 1000 rows, and the
    launch on the first M rows alone gives the bits of those rows."""
    g = torch.Generator(device=cuda).manual_seed(V + M)
    n = M if top_p == 0.0 else max(M, 1000)
    logits = torch.randn(n, V, device=cuda, generator=g) * 4
    noise = -torch.log(-torch.log(torch.rand(n, V, device=cuda, generator=g)))
    ids, mask = sample_kernel(logits, None, top_k, top_p, noise=noise,
                              return_mask=True)
    ids_p, mask_p = sample_plain(logits, None, top_k, top_p, noise=noise,
                                 return_mask=True)
    rows = (mask == mask_p).all(-1) & (ids == ids_p)
    if top_p == 0.0:
        assert rows.all()
    else:  # integer masses against f32 sums: a rare row may differ
        assert rows.float().mean() >= 0.999
        ids_m, mask_m = sample_kernel(logits[:M], None, top_k, top_p,
                                      noise=noise[:M], return_mask=True)
        assert torch.equal(ids_m, ids[:M]) and torch.equal(mask_m, mask[:M])


def test_sampler_kernel_replays_in_a_cuda_graph(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    logits = torch.randn(4096, 4096, device=cuda, generator=g) * 4
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096,), device=cuda,
                          generator=g, dtype=torch.int32)
    for M in (16, 4096):
        eager = sample_kernel(logits[:M], seeds[:M], 900, 0.96)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = sample_kernel(logits[:M], seeds[:M], 900, 0.96)
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_sampler_kernel_refuses_what_it_does_not_take(cuda):
    seeds = torch.zeros(4, dtype=torch.int32, device=cuda)
    for V in (4098, 8196):
        with pytest.raises(ValueError, match="multiple of 4"):
            sample_kernel(torch.zeros(4, V, device=cuda), seeds, 15, 0.5)
    with pytest.raises(ValueError, match="float32"):
        sample_kernel(torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16), seeds)
    with pytest.raises(ValueError, match="row_seeds"):
        sample_kernel(torch.zeros(4, 64, device=cuda), seeds[:3])


def _log_uniform(shape, lo, hi, dev, g):
    u = torch.rand(shape, device=dev, generator=g)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("Lq,Lk", [(1, 1), (64, 155), (169, 424)])
def test_attention_int8_kv_matches_plain(cuda, dtype, hd, Lq, Lk):
    """INT8-KV branch against the plain version's fused order, k/v and
    scales as strided slices of an int8 cache and its (depth, B, L_max)
    scale planes, scales log-uniform in [1e-3, 1e2]. bf16: p * vs is cast
    to bf16 on both sides, and 2e-2 of the output's size covers the sum
    order and one bf16 rounding of o; f32: 1e-4 of the size."""
    g = torch.Generator(device=cuda).manual_seed(Lq * 1000 + Lk + hd)
    B, H, Lmax = 4, 3, Lk + 7
    q = (torch.randn(B, Lq, H, hd, device=cuda, generator=g) * 0.01).to(dtype)
    cache = torch.randint(-127, 128, (2, 1, B, Lmax, H * hd), device=cuda,
                          generator=g, dtype=torch.int8)
    scales = _log_uniform((2, 1, B, Lmax), 1e-3, 1e2, cuda, g)
    k = cache[0, 0, :, :Lk].view(B, Lk, H, hd)
    v = cache[1, 0, :, :Lk].view(B, Lk, H, hd)
    kv_scales = (scales[0, 0, :, :Lk], scales[1, 0, :, :Lk])
    got = attention_kernel(q, k, v, None, 0.125, kv_scales=kv_scales).float()
    want = attention_plain(q, k, v, None, 0.125, kv_scales=kv_scales).float()
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_attention_int8_kv_bias_and_masked_row(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, H, hd, Lq, Lk = 2, 2, 64, 70, 90
    q = torch.randn(B, Lq, H, hd, device=cuda, generator=g) * 0.01
    k, v = (torch.randint(-127, 128, (Lk, B, H, hd), device=cuda, generator=g,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (_log_uniform((Lk, B), 1e-3, 1e2, cuda, g) for _ in range(2))
    bias = torch.randn(Lq, Lk, device=cuda, generator=g)
    bias[:, ::3] = float("-inf")
    bias[-1] = float("-inf")
    got = attention_kernel(q, k, v, bias, 0.125, kv_token_major=True,
                           kv_scales=(ks, vs))
    want = attention_plain(q, k, v, bias, 0.125, kv_token_major=True,
                           kv_scales=(ks, vs))
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert not got[:, -1].any() and torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,gelu", [(64, 7680, True), (37, 1920, False),
                                      (5, 100, True)])
def test_act_quantize_kernel_matches_plain(cuda, dtype, M, K, gelu):
    """Scales within 1e-6 relative, |dq| <= 1 on fewer than 1e-3 of the
    elements (libdevice tanh against PyTorch's: the last bits of h)."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = (torch.randn(M, K, device=cuda, generator=g) * 3).to(dtype)
    # the bias in x's dtype: bf16 as the main path's fc1_b, widened in-kernel
    b = torch.randn(K, device=cuda, generator=g).to(dtype) if gelu else None
    q, s = act_quantize_kernel(x, b, gelu)
    qp, sp = act_quantize_plain(x, b, gelu)
    torch.testing.assert_close(s, sp, rtol=1e-6, atol=0)
    d = (q.int() - qp.int()).abs()
    assert d.max().item() <= 1 and (d != 0).float().mean().item() < 1e-3


@pytest.mark.parametrize("M,K,gelu", [(64, 3840, True), (37, 960, False)])
def test_act_quantize_split_row_modes_match_plain(cuda, M, K, gelu):
    """The two modes of a row split over ranks: the scales alone, and the
    int8 values under a given scale (twice each row's own, as the max over
    ranks may be). Without GELU both are the plain version's bits; with it
    the scales within 1e-6 relative and |dq| <= 1 on fewer than 1e-3 of the
    elements, as above."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = (torch.randn(M, K, device=cuda, generator=g) * 3).to(torch.bfloat16)
    b = torch.randn(K, device=cuda, generator=g).to(x.dtype) if gelu else None
    s, sp = act_scale_kernel(x, b, gelu), act_scale_plain(x, b, gelu)
    given = sp * 2.0
    q, s_out = act_quantize_kernel(x, b, gelu, scale=given)
    qp, _ = act_quantize_plain(x, b, gelu, scale=given)
    assert torch.equal(s_out, given)
    d = (q.int() - qp.int()).abs()
    if gelu:
        torch.testing.assert_close(s, sp, rtol=1e-6, atol=0)
        assert d.max().item() <= 1 and (d != 0).float().mean().item() < 1e-3
    else:
        assert torch.equal(s, sp) and d.max().item() == 0


@pytest.mark.parametrize("pn", [1, 2, 3, 4, 5, 6, 8, 10, 13, 16])
def test_act_quantize_kernel_bits_at_the_decode_scales(cuda, pn):
    """At each scale's M (2B = 32 rows x pn^2) the qkv/proj/fc1 input (K=1920,
    no GELU) and the 1x2 rank's proj input (K=960, both split-row modes)
    give the plain version's bits; the fc2 input (K=7680, bf16 bias + GELU)
    keeps the tolerance above."""
    g = torch.Generator(device=cuda).manual_seed(pn)
    M = 32 * pn * pn
    for K in (1920, 960):
        x = (torch.randn(M, K, device=cuda, generator=g) * 3).to(torch.bfloat16)
        q, s = act_quantize_kernel(x, None, False)
        qp, sp = act_quantize_plain(x, None, False)
        assert torch.equal(q, qp) and torch.equal(s, sp)
        assert torch.equal(act_scale_kernel(x, None, False), sp)
        q2, _ = act_quantize_kernel(x, None, False, scale=sp * 1.5)
        assert torch.equal(q2, act_quantize_plain(x, None, False, scale=sp * 1.5)[0])
    x = (torch.randn(M, 7680, device=cuda, generator=g) * 3).to(torch.bfloat16)
    b = torch.randn(7680, device=cuda, generator=g).to(torch.bfloat16)
    q, s = act_quantize_kernel(x, b, True)
    qp, sp = act_quantize_plain(x, b, True)
    torch.testing.assert_close(s, sp, rtol=1e-6, atol=0)
    d = (q.int() - qp.int()).abs()
    assert d.max().item() <= 1 and (d != 0).float().mean().item() < 1e-3


def test_act_quantize_kernel_on_ties(cuda):
    """Rows built on exact half-steps of their scale: every element but the
    row's amax a rounding tie of h / s (s a power of two, so (k + 0.5) s
    and 127 s are exact in bf16 and s = amax / 127 exactly), where the
    reciprocal product must give way to the IEEE quotient."""
    g = torch.Generator(device=cuda).manual_seed(9)
    e = torch.randint(0, 12, (800, 1), device=cuda, generator=g).float()
    s = torch.exp2(-e)
    k = torch.randint(-127, 127, (800, 1920), device=cuda, generator=g).float() + 0.5
    k[:, 0] = 127.0  # the row's amax
    x = (k * s).to(torch.bfloat16)
    assert torch.equal(x.float(), k * s)
    q, sq = act_quantize_kernel(x, None, False)
    qp, sqp = act_quantize_plain(x, None, False)
    assert torch.equal(q, qp) and torch.equal(sq, sqp)


def test_act_quantize_kernel_replays_in_a_cuda_graph(cuda):
    """One launch captured in a CUDA graph and replayed on new inputs gives
    the eager launch's bits: the kernel allocates nothing and does not
    synchronise."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = (torch.randn(800, 7680, device=cuda, generator=g) * 3).to(torch.bfloat16)
    b = torch.randn(7680, device=cuda, generator=g).to(torch.bfloat16)
    act_quantize_kernel(x, b, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = act_quantize_kernel(x, b, True)
    x.copy_((torch.randn(800, 7680, device=cuda, generator=g) * 3).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    qe, se = act_quantize_kernel(x, b, True)
    assert torch.equal(q, qe) and torch.equal(s, se)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(2, 64, 192), (200, 1920, 272),
                                   (130, 256, 4096)]
                         + [(M, 7680, N) for M in (32, 288, 800, 5408)
                            for N in (2048, 2880, 5760)])
def test_int8_matmul_kernel_matches_plain(cuda, x_dtype, M, K, N):
    """Ragged M and N edges, the output in x's dtype, held against the plain
    version's f32 sum on the same (exactly widened) x; the decode's M (scales
    1, 3, 5 and 8, ragged at 288, 800 and 5408) at fc2's K. Both sum exact
    products in f32 and scale the sum; the order differs (1e-5 of the
    output's size in f32) and a bf16 output rounds once (up to 2^-8 of the
    largest output's binade, so 2^-7 of the size with the sum's order)."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, device=cuda, generator=g).to(x_dtype)
    q = torch.randint(-127, 128, (K, N), device=cuda, generator=g,
                      dtype=torch.int8)
    s = torch.rand(N, device=cuda, generator=g) * 1e-2
    got = int8_matmul_kernel(x, q, s)
    assert got.dtype == x_dtype
    want = int8_matmul_plain(x.float(), q, s)
    tol = 1e-5 if x_dtype == torch.float32 else 2 ** -7
    assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_replays_in_a_cuda_graph(cuda, x_dtype):
    """One launch captured in a CUDA graph (after an eager one, which sets
    the kernel's shared-memory limit) and replayed on new inputs gives the
    eager launch's bits: the kernel allocates nothing and does not
    synchronise."""
    g = torch.Generator(device=cuda).manual_seed(5)
    M, K, N = 800, 1920, 4096
    x = torch.randn(M, K, device=cuda, generator=g).to(x_dtype)
    q = torch.randint(-127, 128, (K, N), device=cuda, generator=g,
                      dtype=torch.int8)
    s = torch.rand(N, device=cuda, generator=g) * 1e-2
    int8_matmul_kernel(x, q, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_matmul_kernel(x, q, s)
    x.copy_(torch.randn(M, K, device=cuda, generator=g).to(x_dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, int8_matmul_kernel(x, q, s))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,O", [(2, 16, 32, 8, 12), (1, 8, 64, 4, 4),
                                       (2, 24, 32, 12, 8), (1, 16, 32, 160, 3),
                                       (1, 16, 40, 160, 160), (1, 9, 33, 48, 320)])
def test_conv3x3_s8_kernel_matches_plain(cuda, out_dtype, B, H, W, C, O):
    """Bit-equal: exact s32 sums, then the same two IEEE roundings
    (x * scale, + bias) and the same cast. Ragged O (3, 12 against 8-wide
    tiles; 320 against 160), C not a multiple of 32 (4, 8, 12, 48) and
    any H and W."""
    g = torch.Generator(device=cuda).manual_seed(B * H + W + C + O)
    x8 = torch.randint(-127, 128, (B, H, W, C), device=cuda, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device=cuda, generator=g) * 2e-3
    bias = torch.randn(O, device=cuda, generator=g)
    got = conv3x3_s8_kernel(x8, wk, scale, bias, out_dtype)
    want = conv3x3_s8_plain(x8, wk, scale, bias, out_dtype)
    assert got.dtype == out_dtype and got.shape == (B, H, W, O)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [32, 160, 320])
@pytest.mark.parametrize("O", [160, 320, 640, 200])
def test_conv3x3_s8_wide_path_matches_plain(cuda, out_dtype, C, O):
    """The TMA + wgmma path at ragged W (37 against 64-pixel boxes), H=8,
    the decoder's channel counts and a ragged O (200 against 160-channel
    tiles), its tail chunks (32 and 64 channels of a tap) included:
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(C + O)
    B, H, W = 2, 8, 37
    x8 = torch.randint(-127, 128, (B, H, W, C), device=cuda, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device=cuda, generator=g) * 2e-3
    bias = torch.randn(O, device=cuda, generator=g)
    assert conv_plan(B, H, W, C, O)["path"] == "tma"
    got = conv3x3_s8_kernel(x8, wk, scale, bias, out_dtype)
    assert torch.equal(got, conv3x3_s8_plain(x8, wk, scale, bias, out_dtype))


def test_conv3x3_s8_kernel_replays_in_a_cuda_graph(cuda):
    """One wide-path launch captured in a CUDA graph (after an eager one,
    which sets the kernel's shared-memory limit) and replayed on new x gives
    the eager launch's bits."""
    g = torch.Generator(device=cuda).manual_seed(8)
    B, H, W, C, O = 4, 64, 64, 160, 160
    x8 = torch.randint(-127, 128, (B, H, W, C), device=cuda, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device=cuda, generator=g) * 2e-3
    bias = torch.randn(O, device=cuda, generator=g)
    conv3x3_s8_kernel(x8, wk, scale, bias)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv3x3_s8_kernel(x8, wk, scale, bias)
    x8.copy_(torch.randint(-127, 128, x8.shape, device=cuda, generator=g,
                           dtype=torch.int8))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, conv3x3_s8_kernel(x8, wk, scale, bias))


def test_conv3x3_s8_kernel_refuses_what_it_does_not_take(cuda):
    x8 = torch.zeros(1, 8, 32, 8, device=cuda, dtype=torch.int8)
    wk = torch.zeros(4, 3, 3, 8, device=cuda, dtype=torch.int8)
    s, b = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_s8_kernel(x8.permute(0, 2, 1, 3), wk, s, b)  # (B, W, H, C) view
    with pytest.raises(ValueError, match="multiple of 4"):
        conv3x3_s8_kernel(x8[..., :6].contiguous(), wk[..., :6].contiguous(), s, b)
    with pytest.raises(ValueError, match="float32"):
        conv3x3_s8_kernel(x8, wk, s.double(), b)


def test_w8a8_pixel_decode_launches_once_per_site(cuda):
    """One all-int8 pixel decode of the small stack (48px, every site at the
    top level) launches the conv kernel once per quantized site."""
    from sdvar_tpu_torch.config import VQVAEConfig
    from sdvar_tpu_torch.models import vqvae as VQ

    cfg = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))
    p = VQ.init_vqvae_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    f_hat = torch.randn(2, 8, 3, 3, device=cuda, generator=g)
    sites = VQ.calibrate_decoder_w8a8(cfg, p, [f_hat], alpha=0.75)
    conv3x3_s8_kernel.launches = 0
    img = VQ.fhat_to_img_nhwc_w8a8_static(cfg, p, f_hat, sites)
    torch.cuda.synchronize()
    assert conv3x3_s8_kernel.launches == sum(s is not None for s in sites) == 8
    assert img.shape == (2, 3, 48, 48) and torch.isfinite(img).all()


# (q dtype, cache dtype): every cache the decode makes, under its model
CACHE_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
               (torch.bfloat16, torch.float32), (torch.bfloat16, torch.int8),
               (torch.float32, torch.int8)]


def _cache(dev, g, dtype, depth, B, Lmax, C):
    """A stacked (depth, B, Lmax, C) K and V cache full of other tokens,
    with (depth, B, Lmax) scale planes log-uniform in [1e-3, 1e2] for int8."""
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (depth, B, Lmax, C), device=dev,
                              generator=g, dtype=torch.int8) for _ in range(2))
        return k, v, tuple(_log_uniform((depth, B, Lmax), 1e-3, 1e2, dev, g)
                           for _ in range(2))
    k, v = (torch.randn(depth, B, Lmax, C, device=dev, generator=g).to(dtype)
            for _ in range(2))
    return k, v, None


def _bias(dev, g, Lq, Lk):
    bias = torch.randn(Lq, Lk, device=dev, generator=g)
    bias[:, ::3] = float("-inf")
    bias[-1] = float("-inf")
    return bias


def _tol(q_dtype, want):
    return (1e-4 if q_dtype == torch.float32 else 2e-2) * max(
        want.abs().max().item(), 1.0)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("bg,Lq", [(0, 1), (5, 9), (60, 70), (63, 130),
                                   (424, 256)])
@pytest.mark.parametrize("q_dtype,c_dtype", CACHE_PAIRS)
def test_attention_cache_write_kernel(cuda, q_dtype, c_dtype, bg, Lq, with_bias):
    """The fused write + attend against its plain version: the cache
    (values and scale planes, every layer and row) bit-equal afterwards,
    the output within the attention kernel's tolerance of the plain one and
    bit-equal to the unfused pair (copy into the cache, then
    ``attention_kernel`` on the layer's slice, cast as ``models.var``
    casts it). Ragged cache_begin, 64-key tiles and 64-query tiles that
    straddle it (5 + 9, 60 + 70, 63 + 130), and the decode's scale 9."""
    g = torch.Generator(device=cuda).manual_seed(bg * 1000 + Lq)
    depth, B, H, hd, li = 3, 3, 2, 64, 1
    Lmax, kv_len, C = bg + Lq + 5, bg + Lq, H * hd
    q = torch.randn(B, Lq, H, hd, device=cuda, generator=g)
    q = (q * (0.01 if c_dtype == torch.int8 else 1.0)).to(q_dtype)
    ck, cv, cs = _cache(cuda, g, c_dtype, depth, B, Lmax, C)
    knew, vnew = (torch.randn(B, Lq, H, hd, device=cuda, generator=g).to(q_dtype)
                  for _ in range(2))
    ns = None
    if c_dtype == torch.int8:
        (knew, ks), (vnew, vs) = (quantize_tokens(t.reshape(B, Lq, C))
                                  for t in (knew, vnew))
        knew, vnew, ns = knew.view(B, Lq, H, hd), vnew.view(B, Lq, H, hd), (ks, vs)
    bias = _bias(cuda, g, Lq, kv_len) if with_bias else None
    clone = lambda c: None if c is None else tuple(t.clone() for t in c)
    (ck_p, cv_p), cs_p, (ck_u, cv_u), cs_u = clone((ck, cv)), clone(cs), clone((ck, cv)), clone(cs)
    attention_cache_write_kernel.launches = attention_cache_write_kernel.launches_int8 = 0
    got = attention_cache_write_kernel(q, knew, vnew, ck, cv, li, bg, kv_len,
                                       bias, 0.125, ns, cs)
    torch.cuda.synchronize()
    counts = (attention_cache_write_kernel.launches,
              attention_cache_write_kernel.launches_int8)
    assert counts == ((0, 1) if c_dtype == torch.int8 else (1, 0))
    want = attention_cache_write_plain(q, knew, vnew, ck_p, cv_p, li, bg,
                                       kv_len, bias, 0.125, ns, cs_p)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    if cs is not None:
        assert all(torch.equal(a, b) for a, b in zip(cs, cs_p))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(q_dtype, want.float()), err
    # the unfused pair
    ck_u[li, :, bg:kv_len] = knew.reshape(B, Lq, C)
    cv_u[li, :, bg:kv_len] = vnew.reshape(B, Lq, C)
    kv_scales = None
    if cs_u is not None:
        for plane, new in zip(cs_u, ns):
            plane[li, :, bg:kv_len] = new
        kv_scales = (cs_u[0][li, :, :kv_len], cs_u[1][li, :, :kv_len])
    k = ck_u[li, :, :kv_len].view(B, kv_len, H, hd)
    v = cv_u[li, :, :kv_len].view(B, kv_len, H, hd)
    if kv_scales is None and k.dtype != q_dtype:
        k, v = k.to(q_dtype), v.to(q_dtype)
    assert torch.equal(got, attention_kernel(q, k, v, bias, 0.125,
                                             kv_scales=kv_scales))
    if with_bias:
        assert not got[:, -1].any() and torch.isfinite(got).all()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("Lq,kv_len", [(1, 1), (9, 14), (130, 255), (256, 680)])
@pytest.mark.parametrize("q_dtype,c_dtype", CACHE_PAIRS)
def test_attention_cache_kernel(cuda, q_dtype, c_dtype, Lq, kv_len, with_bias):
    """Attention over layer li of the stacked cache, read in place: within
    tolerance of the plain version and bit-equal to ``attention_kernel`` on
    the layer's slice; the cache is left as it was."""
    g = torch.Generator(device=cuda).manual_seed(Lq * 1000 + kv_len)
    depth, B, H, hd, li = 3, 2, 3, 64, 2
    Lmax, C = kv_len + 9, H * hd
    q = torch.randn(B, Lq, H, hd, device=cuda, generator=g)
    q = (q * (0.01 if c_dtype == torch.int8 else 1.0)).to(q_dtype)
    ck, cv, cs = _cache(cuda, g, c_dtype, depth, B, Lmax, C)
    before = (ck.clone(), cv.clone())
    bias = _bias(cuda, g, Lq, kv_len) if with_bias else None
    attention_cache_kernel.launches = 0
    got = attention_cache_kernel(q, ck, cv, li, kv_len, bias, 0.125, cs)
    torch.cuda.synchronize()
    assert attention_cache_kernel.launches == 1
    want = attention_cache_plain(q, ck, cv, li, kv_len, bias, 0.125, cs)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(q_dtype, want.float()), err
    assert torch.equal(ck, before[0]) and torch.equal(cv, before[1])
    k = ck[li, :, :kv_len].view(B, kv_len, H, hd)
    v = cv[li, :, :kv_len].view(B, kv_len, H, hd)
    kv_scales = None if cs is None else (cs[0][li, :, :kv_len], cs[1][li, :, :kv_len])
    if kv_scales is None and k.dtype != q_dtype:
        k, v = k.to(q_dtype), v.to(q_dtype)
    assert torch.equal(got, attention_kernel(q, k, v, bias, 0.125,
                                             kv_scales=kv_scales))


def test_cache_kernels_refuse_what_they_do_not_take(cuda):
    B, Lq, H, hd = 2, 4, 2, 64
    q = torch.zeros(B, Lq, H, hd, device=cuda)
    ck = torch.zeros(2, B, 16, H * hd, device=cuda)
    new = torch.zeros(B, Lq, H, hd, device=cuda)
    with pytest.raises(ValueError, match="cache_begin"):
        attention_cache_write_kernel(q, new, new, ck, ck.clone(), 0, 3, 8,
                                     None, 1.0)
    with pytest.raises(ValueError, match="not taken"):
        attention_cache_kernel(q, ck.bfloat16(), ck.bfloat16(), 0, 8, None, 1.0)
    with pytest.raises(ValueError, match="scale planes"):
        attention_cache_kernel(q, ck.to(torch.int8), ck.to(torch.int8), 0, 8,
                               None, 1.0)
    with pytest.raises(ValueError, match="layer"):
        attention_cache_kernel(q, ck, ck.clone(), 2, 8, None, 1.0)


# The ring loop's edges (bf16 q): key counts around one tile and around
# the 3-stage ring (191-193), the decode's 680 and a cache over 1000 keys;
# query counts that leave ragged 64-row warpgroups (1, 100, 169) and the
# decode's 256; K/V in bf16 (token-major, q a strided view of a fused qkv
# tensor), int8 with scales (batch-major cache slices) and an f32 cache
# under bf16 q (through the cache entry, which rounds it to bf16).
RING_LK = [1, 5, 64, 65, 191, 192, 193, 680, 1100]
RING_KINDS = ["bf16", "int8", "f32_cache"]


def _ring_case(dev, g, kind, B, Lq, Lk, H, hd):
    """Run the kernel and its plain version on one case; returns both."""
    C = H * hd
    qkv = torch.randn(B, Lq, 3, H, hd, device=dev, generator=g)
    if kind == "int8":
        qkv = qkv * 0.01
    q = qkv.to(torch.bfloat16)[:, :, 0]  # q_sl = 3C: a view, not a copy
    if kind == "bf16":
        cache = torch.randn(2, Lk + 7, B, C, device=dev, generator=g)
        k, v = (cache[i, :Lk].to(torch.bfloat16).view(Lk, B, H, hd) for i in range(2))
        return (attention_kernel(q, k, v, None, 0.125, kv_token_major=True),
                attention_plain(q, k, v, None, 0.125, kv_token_major=True))
    depth = 2
    ck, cv, cs = _cache(dev, g, torch.int8 if kind == "int8" else torch.float32,
                        depth, B, Lk + 7, C)
    if kind == "int8":
        k, v = (c[1, :, :Lk].view(B, Lk, H, hd) for c in (ck, cv))
        sc = (cs[0][1, :, :Lk], cs[1][1, :, :Lk])
        return (attention_kernel(q, k, v, None, 0.125, kv_scales=sc),
                attention_plain(q, k, v, None, 0.125, kv_scales=sc))
    return (attention_cache_kernel(q, ck, cv, 1, Lk, None, 0.125),
            attention_cache_plain(q, ck, cv, 1, Lk, None, 0.125))


@pytest.mark.parametrize("Lk", RING_LK)
@pytest.mark.parametrize("Lq", [1, 100, 169, 256])
@pytest.mark.parametrize("kind", RING_KINDS)
def test_attention_ring_edges(cuda, kind, Lq, Lk):
    g = torch.Generator(device=cuda).manual_seed(Lq * 10007 + Lk)
    got, want = _ring_case(cuda, g, kind, 2, Lq, Lk, 3, 64)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(torch.bfloat16, want.float()), err


@pytest.mark.parametrize("Lq,Lk", [(100, 65), (256, 680)])
@pytest.mark.parametrize("kind", RING_KINDS)
@pytest.mark.parametrize("hd", [32, 128])
def test_attention_ring_head_dims(cuda, hd, kind, Lq, Lk):
    g = torch.Generator(device=cuda).manual_seed(hd * 1000 + Lq + Lk)
    got, want = _ring_case(cuda, g, kind, 2, Lq, Lk, 2, hd)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(torch.bfloat16, want.float()), err


@pytest.mark.parametrize("bg,Lq", [(255, 425), (130, 39), (200, 1)])
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_attention_ring_write_straddles_split(cuda, c_dtype, bg, Lq):
    """The fused write with cache_begin not a multiple of the 64-key tile,
    so one ring tile holds cache rows and new rows; the verify window's
    (255 + 425) with a bias and a fully masked row. Cache rows and scales
    bit-equal to the plain write; output within tolerance of the plain
    version and bit-equal to the unfused pair."""
    g = torch.Generator(device=cuda).manual_seed(bg + Lq)
    depth, B, H, hd, li = 2, 2, 3, 64, 0
    kv_len, C = bg + Lq, H * hd
    q = torch.randn(B, Lq, H, hd, device=cuda, generator=g)
    q = (q * (0.01 if c_dtype == torch.int8 else 1.0)).to(torch.bfloat16)
    ck, cv, cs = _cache(cuda, g, c_dtype, depth, B, kv_len + 3, C)
    knew, vnew = (torch.randn(B, Lq, H, hd, device=cuda, generator=g)
                  .to(torch.bfloat16) for _ in range(2))
    ns = None
    if c_dtype == torch.int8:
        (knew, ks), (vnew, vs) = (quantize_tokens(t.reshape(B, Lq, C))
                                  for t in (knew, vnew))
        knew, vnew, ns = knew.view(B, Lq, H, hd), vnew.view(B, Lq, H, hd), (ks, vs)
    bias = _bias(cuda, g, Lq, kv_len)
    clone = lambda c: None if c is None else tuple(t.clone() for t in c)
    (ck_p, cv_p), cs_p = clone((ck, cv)), clone(cs)
    got = attention_cache_write_kernel(q, knew, vnew, ck, cv, li, bg, kv_len,
                                       bias, 0.125, ns, cs)
    torch.cuda.synchronize()
    want = attention_cache_write_plain(q, knew, vnew, ck_p, cv_p, li, bg,
                                       kv_len, bias, 0.125, ns, cs_p)
    assert torch.equal(ck, ck_p) and torch.equal(cv, cv_p)
    if cs is not None:
        assert all(torch.equal(a, b) for a, b in zip(cs, cs_p))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(torch.bfloat16, want.float()), err
    assert not got[:, -1].any() and torch.isfinite(got).all()
    k, v = (c[li, :, :kv_len].view(B, kv_len, H, hd) for c in (ck, cv))
    sc = None if cs is None else (cs[0][li, :, :kv_len], cs[1][li, :, :kv_len])
    if sc is None and k.dtype != torch.bfloat16:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    assert torch.equal(got, attention_kernel(q, k, v, bias, 0.125, kv_scales=sc))


@pytest.mark.parametrize("s8", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 64, 64), (100, 1920, 200),
                                   (200, 7680, 136), (64, 96, 520),
                                   (800, 1920, 7680), (300, 1920, 4096)])
def test_w8a8_fused_kernel_matches_plain(cuda, s8, x_dtype, M, K, N):
    """Ragged M and N against the 256 x 160 tiles (M = 800: the decode's
    scale 4 at B=32; N = 4096: the head), one and many K steps, an all-zero
    row: the s8 form gives the plain version's bits; the bf16 form's f32
    sum is exact below 2^24 (these sums stay below it), so it does too."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = (torch.randn(M, K, device=cuda, generator=g) * 3).to(x_dtype)
    x[M // 2] = 0
    q = k_major(torch.randint(-127, 128, (K, N), device=cuda, generator=g,
                              dtype=torch.int8))
    s = torch.rand(N, device=cuda, generator=g) * 1e-2
    n0 = w8a8_fused_kernel.launches
    got = w8a8_fused_kernel(x, q, s, s8)
    torch.cuda.synchronize()
    assert w8a8_fused_kernel.launches == n0 + 1
    want = w8a8_fused_plain(x, q, s, s8)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_w8a8_fused_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(16, 64, device=cuda)
    q = torch.zeros(64, 64, dtype=torch.int8, device=cuda)
    s = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="K-major"):
        w8a8_fused_kernel(x, q, s)
    with pytest.raises(ValueError, match="contiguous rows"):
        w8a8_fused_kernel(x[:, 1:49], k_major(q[:48]), s, False)
    with pytest.raises(ValueError, match="CUDA"):
        w8a8_fused_kernel(x.cpu(), k_major(q), s)


@pytest.mark.parametrize("s8", [True, False])
def test_w8a8_fused_kernel_replays_in_a_cuda_graph(cuda, s8):
    """The scratch's flags are zeroed on the stream before each launch, so
    a replayed graph gives the eager bits."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = (torch.randn(800, 1920, device=cuda, generator=g) * 3).to(torch.bfloat16)
    q = k_major(torch.randint(-127, 128, (1920, 7680), device=cuda, generator=g,
                              dtype=torch.int8))
    s = torch.rand(7680, device=cuda, generator=g) * 1e-2
    eager = w8a8_fused_kernel(x, q, s, s8)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = w8a8_fused_kernel(x, q, s, s8)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
