"""Kernel rows 1-6 against their plain versions at the high-resolution
decodes' shapes, on the card (marked ``gpu``; they skip where there is no
card): VAR-d36 512px (2B=8, 36 heads, Lq up to 1024 over Lk=2240, rows
of 2304 and 9216) and the 1024px preset at the d16 width (2B=4, 16 heads,
Lq=4096 over Lk=9451; the sampler's 8192 rows), and the 512px pixel
decoder's top level. Tolerances as at 256px (``test_torch_kernels.py``),
but row 1's: its outputs have a spread of about 1/sqrt(0.78 Lk) here
(0.012 at Lk=9451), so the kernel is held within one bf16 step at the
largest output, 2^-7 of it (both outputs are bf16), and the plain version
without the last ring tile of keys must fall outside that limit.

    python -m pytest tests/test_torch_highres_kernels.py -q -m gpu -o addopts="" --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from sdvar_tpu_torch.ops.kernels.attention import (
    KEY_TILE,
    attention_kernel,
    attention_plain,
)
from sdvar_tpu_torch.ops.kernels.conv_s8 import conv3x3_s8_kernel, conv3x3_s8_plain
from sdvar_tpu_torch.ops.kernels.matmul_int8 import int8_matmul_kernel, int8_matmul_plain
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize_kernel, act_quantize_plain
from sdvar_tpu_torch.ops.kernels.sampling import sample_kernel, sample_plain
from sdvar_tpu_torch.ops.quantization import quantize_weight

pytestmark = pytest.mark.gpu

# (2B, Lq, Lk, H): the last scales of the 512px and 1024px decodes
ATT = [(8, 576, 1216, 36), (8, 1024, 2240, 36), (4, 2304, 5355, 16),
       (4, 4096, 9451, 16)]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("Bq,Lq,Lk,H", ATT)
def test_attention_at_highres_shapes(cuda, Bq, Lq, Lk, H):
    g = torch.Generator(device=cuda).manual_seed(Lq)
    cache = torch.randn(2, Bq, Lk, H * 64, device=cuda, generator=g)
    cache[0] = F.normalize(cache[0].view(Bq, Lk, H, 64), dim=-1).view(Bq, Lk, -1)
    cache = cache.to(torch.bfloat16)
    k, v = (cache[i].view(Bq, Lk, H, 64) for i in (0, 1))
    q = (F.normalize(torch.randn(Bq, Lq, H, 64, device=cuda, generator=g),
                     dim=-1) * 4).to(torch.bfloat16)
    got = attention_kernel(q, k, v, None, 1.0).float()
    want = attention_plain(q, k, v, None, 1.0).float()
    lim = 2 ** -7 * want.abs().max()
    assert (got - want).abs().max() <= lim
    full = Lk - (Lk % KEY_TILE or KEY_TILE)
    drop = attention_plain(q, k[:, :full], v[:, :full], None, 1.0).float()
    assert (drop - want).abs().max() > lim


@pytest.mark.parametrize("Bq,Lq,Lk,H", ATT)
def test_attention_int8_kv_at_highres_shapes(cuda, Bq, Lq, Lk, H):
    g = torch.Generator(device=cuda).manual_seed(Lq + 1)
    vals = torch.randint(-127, 128, (2, Bq, Lk, H * 64), device=cuda,
                         generator=g, dtype=torch.int8)
    scales = torch.exp(torch.rand(2, Bq, Lk, device=cuda, generator=g) * 11 - 7)
    k, v = (vals[i].view(Bq, Lk, H, 64) for i in (0, 1))
    q = (torch.randn(Bq, Lq, H, 64, device=cuda, generator=g)
         * 1e-3).to(torch.bfloat16)
    sc = (scales[0], scales[1])
    got = attention_kernel(q, k, v, None, 1.0, kv_scales=sc).float()
    want = attention_plain(q, k, v, None, 1.0, kv_scales=sc).float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("M", [4096, 8192])
def test_sampler_at_highres_rows(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    logits = torch.randn(M, 4096, device=cuda, generator=g) * 4
    noise = -torch.log(-torch.log(torch.rand(
        M, 4096, device=cuda, generator=g).clamp_(1e-7, 1 - 1e-7)))
    for top_k, top_p, need in ((900, 0.96, 0.999), (900, 0.0, 1.0)):
        ids, mask = sample_kernel(logits, None, top_k, top_p, noise=noise,
                                  return_mask=True)
        ids_p, mask_p = sample_plain(logits, None, top_k, top_p, noise=noise,
                                     return_mask=True)
        equal = (mask == mask_p).all(-1) & (ids == ids_p)
        assert equal.float().mean().item() >= need


@pytest.mark.parametrize("K,gelu,dtype", [(2304, False, torch.bfloat16),
                                          (9216, True, torch.bfloat16),
                                          (2304, False, torch.float32),
                                          (9216, True, torch.float32)])
def test_act_quantize_at_d36_widths(cuda, K, gelu, dtype):
    """d36's rows at the 512 decode's last scale; the f32 fc2 input (9216)
    is held by 1024 threads of three loads each."""
    g = torch.Generator(device=cuda).manual_seed(K)
    x = (torch.randn(8192, K, device=cuda, generator=g) * 3).to(dtype)
    bias = torch.randn(K, device=cuda, generator=g).to(dtype) if gelu else None
    q, s = act_quantize_kernel(x, bias, gelu)
    qp, sp = act_quantize_plain(x, bias, gelu)
    assert ((s - sp).abs() / sp).max() <= 1e-6
    d = (q.int() - qp.int()).abs()
    assert d.max() <= 1 and (d != 0).float().mean() < 1e-3
    if not gelu:
        assert torch.equal(q, qp) and torch.equal(s, sp)


def test_int8_head_at_d36(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(8192, 2304, device=cuda, generator=g)
    qw = quantize_weight(torch.randn(2304, 4096, device=cuda, generator=g) * 0.02)
    got = int8_matmul_kernel(x, qw.q, qw.scale)
    want = int8_matmul_plain(x, qw.q, qw.scale)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("shape", [(4, 512, 512, 160, 160), (4, 256, 256, 160, 160)])
def test_conv3x3_s8_at_512px(cuda, shape):
    B, H, W, C, O = shape
    g = torch.Generator(device=cuda).manual_seed(H)
    x8 = torch.randint(-127, 128, (B, H, W, C), device=cuda, generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device=cuda, generator=g) * 2e-3
    bias = torch.randn(O, device=cuda, generator=g)
    assert torch.equal(conv3x3_s8_kernel(x8, wk, scale, bias),
                       conv3x3_s8_plain(x8, wk, scale, bias))
