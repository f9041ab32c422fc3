"""The card's quantization bits against the CPU's (marked ``gpu``; they
skip where there is no card): the scales and int8 (or e4m3) values of
``quantize_weight``, ``quantize_weight_fp8``, ``quantize_tokens`` and the
dynamic scales of ``ops.conv_s8.conv2d_nhwc_w8a8``, on bf16 and f32 data
where rounding ties are common (elements at exactly amax / 2). Each
divides by a tensor on its operand's device, so the card takes the IEEE
quotient as the CPU does; a division by a host number would be a product
with the reciprocal there and move some of them a step.

    python -m pytest tests/test_torch_quant_bits.py -q -m gpu -o addopts="" --noconftest
"""

import pytest
import torch

from sdvar_tpu_torch.ops import conv_s8
from sdvar_tpu_torch.ops.quantization import (
    quantize_tokens,
    quantize_weight,
    quantize_weight_fp8,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def tie_data(shape, dtype, axis: int, seed: int = 0) -> torch.Tensor:
    """Random data whose every slice along ``axis`` holds its amax (a
    power of two times 1.5) and a run of elements at exactly amax / 2."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 0.5
    x = x.clamp(-1.4, 1.4).movedim(axis, -1)
    x[..., 0] = 1.5
    x[..., 1:9] = 0.75
    x[..., 9:13] = -0.75
    return x.movedim(-1, axis).to(dtype).contiguous()


def _same(a, b):
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fn", [quantize_weight, quantize_weight_fp8])
def test_weight_scales_and_values_card_equal_cpu(cuda, dtype, fn):
    w = tie_data((2, 192, 64), dtype, axis=-2)
    c, g = fn(w), fn(w.to(cuda))
    assert _same(c.scale, g.scale) and _same(c.q, g.q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_token_scales_and_values_card_equal_cpu(cuda, dtype):
    x = tie_data((32, 40, 1920), dtype, axis=-1)
    (cq, cs), (gq, gs) = quantize_tokens(x), quantize_tokens(x.to(cuda))
    assert _same(cs, gs) and _same(cq, gq)


def test_conv_dynamic_scales_card_equal_cpu(cuda, monkeypatch):
    """The int8 operands and the combined scale that ``conv2d_nhwc_w8a8``
    hands to the int8 convolution, captured on both devices."""
    seen = []  # the CPU's operands, then the card's
    real = conv_s8.conv3x3_s8

    def capture(xq, wq, scale, bias, out_dtype):
        seen.append((xq, wq, scale))
        return real(xq, wq, scale, bias, out_dtype)

    monkeypatch.setattr(conv_s8, "conv3x3_s8", capture)
    p = {"w": tie_data((24, 16, 3, 3), torch.float32, axis=1, seed=1),
         "b": torch.zeros(24)}
    x = tie_data((2, 8, 8, 16), torch.bfloat16, axis=-1, seed=2)
    conv_s8.conv2d_nhwc_w8a8(p, x)
    conv_s8.conv2d_nhwc_w8a8({k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    for a, b in zip(*seen):
        assert _same(a, b)
