"""The port's kernels against their plain versions on the card (marked
``gpu``; they skip where there is no card).

Run them on a machine with an NVIDIA card (``--noconftest``: the tests'
conftest imports JAX, which the port does not need there):
    python -m pytest tests/test_torch_kernels.py -q -m gpu -o addopts="" --noconftest
"""

import pytest
import torch

from sdvar_tpu_torch.ops.kernels.attention import attention_kernel, attention_plain
from sdvar_tpu_torch.ops.kernels.sampling import sample_kernel, sample_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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


@pytest.mark.parametrize("top_k,top_p", [(900, 0.96), (900, 0.0), (1, 0.0),
                                         (0, 0.9)])
def test_sampler_kernel_matches_plain(cuda, top_k, top_p):
    g = torch.Generator(device=cuda).manual_seed(top_k)
    M, V = 512, 4096
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
