"""The work counts against values worked out by hand at the tiny
configuration."""

import math

from benchmark.harness import work
from benchmark.tests import tiny

VAR = tiny.MODEL["var"]  # depth 2, C 64, hidden 256, V 64, Cvae 8, pns 1,2,4,8


def test_transformer_row():
    C, hid, V, Cv, d = 64, 256, 64, 8, 2
    per_tok = 2 * (3 * C * C + C * C + 2 * C * hid)
    scales = [(1, 1), (4, 5), (16, 21), (64, 85)]
    f = d * 2 * C * 6 * C + 2 * C * 2 * C
    for l, ed in scales:
        f += d * (l * per_tok + 4 * l * ed * C) + 2 * l * C * V
    f += 2 * (85 - 1) * Cv * C
    assert work.transformer_flops_per_row(VAR, decode=True) == f


def test_decoder_and_encoder():
    q = tiny.MODEL["vqvae"]  # ch 32, mult (1, 2), one res block, z 8
    conv = lambda h, a, b, k: 2 * h * h * a * b * k * k  # noqa: E731
    res = lambda h, a, b: conv(h, a, b, 3) + conv(h, b, b, 3) + (  # noqa: E731
        conv(h, a, b, 1) if a != b else 0)
    attn = lambda h, c: conv(h, c, 3 * c, 1) + conv(h, c, c, 1) \
        + 4 * (h * h) ** 2 * c  # noqa: E731
    dec = conv(8, 8, 8, 3) + conv(8, 8, 64, 3) + 2 * res(8, 64, 64) \
        + attn(8, 64)
    dec += 2 * res(8, 64, 64) + 2 * attn(8, 64) + conv(16, 64, 64, 3)
    dec += res(16, 64, 32) + res(16, 32, 32) + conv(16, 32, 3, 3)
    assert work.decoder_flops(q, 8) == dec
    enc = conv(16, 3, 32, 3) + res(16, 32, 32) + conv(8, 32, 32, 3)
    enc += res(8, 32, 64) + attn(8, 64) + 2 * res(8, 64, 64) + attn(8, 64)
    enc += conv(8, 64, 8, 3) + conv(8, 8, 8, 3)
    assert work.encoder_flops(q, 16) == enc


def test_attention_roofline_bounds():
    fl, nb = work.attention_call(rows=64, lq=256, lk=680, C=1920)
    assert fl == 4 * 64 * 256 * 680 * 1920
    assert nb == 64 * (2 * 256 * 1920 * 2 + 2 * 680 * 1920 * 2)
    assert work.least_seconds(fl, nb) == max(fl / 989e12, nb / 3.35e12)
    least = work.decode_attention_least(VAR, batch=4)
    assert len(least) == 4 * 2 and least[0] == least[1]
    assert all(a <= b for a, b in zip(least[::2], least[2::2]))


def test_mfu_percent():
    assert math.isclose(work.mfu_percent(989e12, 1.0), 100.0)
