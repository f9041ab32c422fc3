"""VQVAE pixel decoder (the decoder half of ``sdvar_tpu/models/vqvae.py``):
GroupNorm(32) + swish ResNet blocks, single-head non-local attention at the
lowest resolution and in the mid block, nearest x2 upsampling + conv.

NCHW with OIHW kernels, f32 throughout: the golden pixel path.
``fhat_to_img`` turns TF32 off while it runs (``utils.device.full_f32``),
so the convolutions run in full f32 as the JAX package's
``Precision.HIGHEST`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.utils.device import full_f32, resolve_device

Params = Dict


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def group_norm(p: Params, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with f32 statistics (mean, then the mean squared
    deviation), cast back to x's dtype before the affine."""
    B, C, H, W = x.shape
    xg = x.reshape(B, groups, C // groups, H, W).float()
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mu).square().mean(dim=(2, 3, 4), keepdim=True)
    x = ((xg - mu) * torch.rsqrt(var + eps)).to(x.dtype).reshape(B, C, H, W)
    return x * p["g"][None, :, None, None] + p["b"][None, :, None, None]


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def resnet_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], swish(group_norm(p["norm1"], x)))
    h = conv2d(p["conv2"], swish(group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x, padding=0)
    return x + h


def attn_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Non-local single-head self-attention over the H*W positions."""
    B, C, H, W = x.shape
    qkv = conv2d(p["qkv"], group_norm(p["norm"], x), padding=0)
    q, k, v = qkv.chunk(3, dim=1)
    q = q.reshape(B, C, H * W).transpose(1, 2)
    w = torch.softmax(
        torch.einsum("bnc,bcm->bnm", q, k.reshape(B, C, H * W)) * C ** -0.5,
        dim=2)
    h = torch.einsum("bcm,bnm->bcn", v.reshape(B, C, H * W), w)
    return x + conv2d(p["proj_out"], h.reshape(B, C, H, W), padding=0)


def upsample2x(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 then conv."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv2d(p, x)


def decoder_forward(cfg: VQVAEConfig, p: Params, z: torch.Tensor
                    ) -> torch.Tensor:
    """(B, Cvae, h, w) -> (B, 3, 16h, 16w)."""
    nres = len(cfg.ch_mult)
    h = conv2d(p["conv_in"], z)
    h = resnet_block(p["mid"]["block_1"], h)
    if cfg.using_mid_sa:
        h = attn_block(p["mid"]["attn_1"], h)
    h = resnet_block(p["mid"]["block_2"], h)
    for i in reversed(range(nres)):
        level = p["up"][i]
        for j in range(cfg.num_res_blocks + 1):
            h = resnet_block(level["block"][j], h)
            if level["attn"]:
                h = attn_block(level["attn"][j], h)
        if i != 0:
            h = upsample2x(level["upsample"], h)
    return conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))


@full_f32()
def fhat_to_img(cfg: VQVAEConfig, p: Params, f_hat: torch.Tensor
                ) -> torch.Tensor:
    """f_hat (B, Cvae, HW, HW) -> image in [-1, 1], f32 NCHW."""
    z = conv2d(p["post_quant_conv"], f_hat.float())
    return decoder_forward(cfg, p["decoder"], z).clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# init: the JAX initialisers' distributions (convs and biases uniform in
# +/- 1/sqrt(fan_in), GroupNorm ones/zeros). The encoder half is built only
# so that the tree matches the JAX package's.
# ---------------------------------------------------------------------------

def init_vqvae_params(cfg: VQVAEConfig, seed: int = 0, device="cuda",
                      eini: float = -1.0) -> Params:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    ch, zc = cfg.ch, cfg.z_channels
    nres = len(cfg.ch_mult)

    def uniform(shape, lim):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * lim

    def conv(cin, cout, ks):
        lim = 1.0 / math.sqrt(cin * ks * ks)
        return {"w": uniform((cout, cin, ks, ks), lim),
                "b": uniform((cout,), lim)}

    def gn(c):
        return {"g": torch.ones(c, device=dev), "b": torch.zeros(c, device=dev)}

    def res(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(cin, cout, 3),
             "norm2": gn(cout), "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["nin_shortcut"] = conv(cin, cout, 1)
        return p

    def attn(c):
        return {"norm": gn(c), "qkv": conv(c, 3 * c, 1),
                "proj_out": conv(c, c, 1)}

    in_mult = (1,) + tuple(cfg.ch_mult)
    enc_down = []
    for i in range(nres):
        cin, cout = ch * in_mult[i], ch * cfg.ch_mult[i]
        blocks, attns = [], []
        c = cin
        for _ in range(cfg.num_res_blocks):
            blocks.append(res(c, cout))
            c = cout
            if i == nres - 1 and cfg.using_sa:
                attns.append(attn(c))
        lvl = {"block": blocks, "attn": attns}
        if i != nres - 1:
            lvl["downsample"] = conv(c, c, 3)
        enc_down.append(lvl)
    cmid = ch * cfg.ch_mult[-1]
    encoder = {
        "conv_in": conv(3, ch, 3),
        "down": enc_down,
        "mid": {"block_1": res(cmid, cmid), "attn_1": attn(cmid),
                "block_2": res(cmid, cmid)},
        "norm_out": gn(cmid),
        "conv_out": conv(cmid, zc, 3),
    }

    dec_up: List[Optional[Params]] = [None] * nres
    c = cmid
    for i in reversed(range(nres)):
        cout = ch * cfg.ch_mult[i]
        blocks, attns = [], []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(res(c, cout))
            c = cout
            if i == nres - 1 and cfg.using_sa:
                attns.append(attn(c))
        lvl = {"block": blocks, "attn": attns}
        if i != 0:
            lvl["upsample"] = conv(c, c, 3)
        dec_up[i] = lvl
    decoder = {
        "conv_in": conv(zc, cmid, 3),
        "mid": {"block_1": res(cmid, cmid), "attn_1": attn(cmid),
                "block_2": res(cmid, cmid)},
        "up": dec_up,
        "norm_out": gn(ch * cfg.ch_mult[0]),
        "conv_out": conv(ch * cfg.ch_mult[0], 3, 3),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": conv(zc, zc, cfg.quant_conv_ks),
        "post_quant_conv": conv(zc, zc, cfg.quant_conv_ks),
        "quant": Q.init_quantizer_params(cfg, g, dev, eini=eini),
    }
