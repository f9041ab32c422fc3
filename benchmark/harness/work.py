"""The work a configuration needs, counted from its shapes (never from
what the port launches): the FLOPs of one generated image and of one
training step, and each attention call's operations and bytes for its
roofline. A multiply-add counts 2 FLOPs.

Generation (``gen_flops_per_image``): both CFG rows of every scale; per
layer the qkv, proj, fc1 and fc2 GEMMs over the scale's tokens and the
attention's Q K^T and P V against the scale's cached length; the AdaLN
projection once a generation; the word embedding, the head's AdaLN and
the head; then the pixel decoder (post-quant conv, every convolution,
the non-local attention's two products). Training (``train_flops_per_step``):
the transformer's forward over all L tokens with the block-causal
attention's pairs, times 3 for forward and backward (recomputation is
not counted), plus the frozen VQVAE encoder and the quantizer's encode
(codebook distances and phi convolutions) and the teacher-forcing input's
phi convolutions."""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.harness.cells import PEAK_BF16, PEAK_HBM


def _scales(var: Dict) -> List[Tuple[int, int]]:
    """(tokens, cached length after the scale) per scale."""
    out, ed = [], 0
    for pn in var["patch_nums"]:
        ed += pn * pn
        out.append((pn * pn, ed))
    return out


def _layer_gemm_per_token(var: Dict) -> int:
    C, hid = var["embed_dim"], var["mlp_hidden"]
    return 2 * (C * 3 * C + C * C + C * hid + hid * C)


def transformer_flops_per_row(var: Dict, decode: bool) -> int:
    """One sequence's forward: every scale's tokens; with ``decode`` each
    scale attends its cached length [0, ed), which is also the training
    forward's block-causal pattern."""
    C, V, Cv, depth = (var["embed_dim"], var["vocab_size"], var["Cvae"],
                       var["depth"])
    f = depth * 2 * C * 6 * C + 2 * C * 2 * C          # AdaLN + head AdaLN
    first = var["patch_nums"][0] ** 2
    for l, ed in _scales(var):
        f += depth * (l * _layer_gemm_per_token(var) + 2 * 2 * l * ed * C)
        f += 2 * l * C * V
    f += 2 * (sum(l for l, _ in _scales(var)) - first) * Cv * C
    return f


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def _res(h: int, cin: int, cout: int) -> int:
    f = _conv(h, h, cin, cout, 3) + _conv(h, h, cout, cout, 3)
    if cin != cout:
        f += _conv(h, h, cin, cout, 1)
    return f


def _attn(h: int, c: int) -> int:
    n = h * h
    return _conv(h, h, c, 3 * c, 1) + _conv(h, h, c, c, 1) + 2 * 2 * n * n * c


def decoder_flops(q: Dict, hw: int) -> int:
    """The pixel decoder from f_hat (Cvae, hw, hw) to the image."""
    ch, mult, nrb, zc = q["ch"], q["ch_mult"], q["num_res_blocks"], q["z_channels"]
    nres = len(mult)
    cmid = ch * mult[-1]
    f = _conv(hw, hw, zc, zc, q["quant_conv_ks"]) + _conv(hw, hw, zc, cmid, 3)
    f += 2 * _res(hw, cmid, cmid) + (_attn(hw, cmid) if q["using_mid_sa"] else 0)
    c, h = cmid, hw
    for i in reversed(range(nres)):
        cout = ch * mult[i]
        for _ in range(nrb + 1):
            f += _res(h, c, cout)
            c = cout
            if i == nres - 1 and q["using_sa"]:
                f += _attn(h, c)
        if i != 0:
            h *= 2
            f += _conv(h, h, c, c, 3)
    return f + _conv(h, h, ch * mult[0], 3, 3)


def encoder_flops(q: Dict, reso: int) -> int:
    """The VQVAE encoder and quant_conv on one (3, reso, reso) image."""
    ch, mult, nrb, zc = q["ch"], q["ch_mult"], q["num_res_blocks"], q["z_channels"]
    nres = len(mult)
    in_mult = (1,) + tuple(mult)
    h = reso
    f = _conv(h, h, 3, ch, 3)
    for i in range(nres):
        c, cout = ch * in_mult[i], ch * mult[i]
        for _ in range(nrb):
            f += _res(h, c, cout)
            c = cout
            if i == nres - 1 and q["using_sa"]:
                f += _attn(h, c)
        if i != nres - 1:
            h //= 2
            f += _conv(h, h, c, c, 3)
    cmid = ch * mult[-1]
    f += 2 * _res(h, cmid, cmid) + _attn(h, cmid)
    f += _conv(h, h, cmid, zc, 3) + _conv(h, h, zc, zc, q["quant_conv_ks"])
    return f


def quantizer_encode_flops(var: Dict, q: Dict) -> int:
    """One image's residual encode (codebook distances, phi per scale) and
    its teacher-forcing input (phi per scale but the last)."""
    Cv, V = q["z_channels"], q["vocab_size"]
    hw = var["patch_nums"][-1]
    phi = _conv(hw, hw, Cv, Cv, 3)
    S = len(var["patch_nums"])
    return sum(2 * pn * pn * Cv * V for pn in var["patch_nums"]) \
        + S * phi + (S - 1) * phi


def gen_flops_per_image(model: Dict) -> int:
    var = model["var"]
    return 2 * transformer_flops_per_row(var, decode=True) \
        + decoder_flops(model["vqvae"], var["patch_nums"][-1])


def train_flops_per_step(model: Dict, batch: int, reso: int = 256) -> int:
    var, q = model["var"], model["vqvae"]
    return batch * (3 * transformer_flops_per_row(var, decode=False)
                    + encoder_flops(q, reso) + quantizer_encode_flops(var, q))


def mfu_percent(flops: float, seconds: float) -> float:
    """Share of the card's bf16 dense peak, in %."""
    return 100.0 * flops / seconds / PEAK_BF16


def attention_call(rows: int, lq: int, lk: int, C: int, q_bytes: int = 2,
                   kv_bytes: float = 2.0, kv_scale_bytes: int = 0
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call over all heads: Q K^T and P V;
    q read once, K and V (and their per-token scales) read once, the
    output written once in q's dtype."""
    flops = 2 * 2 * rows * lq * lk * C
    nbytes = rows * (2 * lq * C * q_bytes + 2 * lk * C * kv_bytes
                     + 2 * lk * kv_scale_bytes)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak: float = PEAK_BF16,
                  bw: float = PEAK_HBM) -> float:
    return max(flops / peak, nbytes / bw)


def decode_attention_least(var: Dict, batch: int, kv: str = "bf16"
                           ) -> List[float]:
    """The least time of each attention call of one decode in launch order
    (scale-major, layer-minor): 2 * batch rows under CFG."""
    C, depth = var["embed_dim"], var["depth"]
    kv_bytes, scale_bytes = (1.0, 4) if kv == "int8" else (2.0, 0)
    out = []
    for l, ed in _scales(var):
        fl, nb = attention_call(2 * batch, l, ed, C, 2, kv_bytes, scale_bytes)
        out += [least_seconds(fl, nb)] * depth
    return out
