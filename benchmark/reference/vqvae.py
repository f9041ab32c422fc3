"""VAR's VQVAE (FoundationVision/VAR ``models/basic_vae.py``), plain and
float32 NCHW: GroupNorm(32, eps 1e-6) + swish ResNet blocks, single-head
non-local attention at the lowest resolution and in the mid block,
downsampling by a 3x3 stride-2 conv after padding right and bottom by 1,
upsampling by nearest x2 then a 3x3 conv. Weights in the port's layout
(the benchmark made them so): OIHW convs under "w"/"b", GroupNorm under
"g"/"b"."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.precision import EXACT, Precision


def _conv(p, x, stride=1, padding=1, prec: Precision = EXACT):
    return F.conv2d(prec.lower(x), prec.lower(p["w"].float()),
                    p["b"].float(), stride=stride, padding=padding)


def _gn(p, x):
    return F.group_norm(x, 32, p["g"].float(), p["b"].float(), eps=1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


def _res(p, x, prec=EXACT):
    h = _conv(p["conv1"], _swish(_gn(p["norm1"], x)), prec=prec)
    h = _conv(p["conv2"], _swish(_gn(p["norm2"], h)), prec=prec)
    if "nin_shortcut" in p:
        x = _conv(p["nin_shortcut"], x, padding=0, prec=prec)
    return x + h


def _attn(p, x, prec=EXACT):
    B, C, H, W = x.shape
    q, k, v = _conv(p["qkv"], _gn(p["norm"], x), padding=0,
                    prec=prec).chunk(3, dim=1)
    q = q.reshape(B, C, H * W).transpose(1, 2)                     # (B, N, C)
    w = torch.softmax(q @ k.reshape(B, C, H * W) * C ** -0.5, dim=-1)
    h = v.reshape(B, C, H * W) @ w.transpose(1, 2)                 # (B, C, N)
    return x + _conv(p["proj_out"], h.reshape(B, C, H, W), padding=0,
                     prec=prec)


def decode(q: Dict, p: Dict, f_hat: torch.Tensor,
           prec: Precision = EXACT) -> torch.Tensor:
    """f_hat (n, Cvae, h, w) -> image (n, 3, 16h, 16w) in [0, 1];
    ``prec``: the convolutions' operands (the control's lower precision)."""
    d = p["decoder"]
    nres = len(q["ch_mult"])
    h = _conv(d["conv_in"], _conv(p["post_quant_conv"], f_hat.float(),
                                  prec=prec), prec=prec)
    h = _res(d["mid"]["block_1"], h, prec)
    h = _attn(d["mid"]["attn_1"], h, prec)
    h = _res(d["mid"]["block_2"], h, prec)
    for i in reversed(range(nres)):
        level = d["up"][i]
        for j in range(q["num_res_blocks"] + 1):
            h = _res(level["block"][j], h, prec)
            if level["attn"]:
                h = _attn(level["attn"][j], h, prec)
        if i != 0:
            h = _conv(level["upsample"], F.interpolate(h, scale_factor=2.0,
                                                       mode="nearest"),
                      prec=prec)
    img = _conv(d["conv_out"], _swish(_gn(d["norm_out"], h)), prec=prec)
    return (img.clamp(-1.0, 1.0) + 1.0) * 0.5


def encode(q: Dict, p: Dict, img: torch.Tensor) -> torch.Tensor:
    """Image (n, 3, H, W) in [-1, 1] -> latent (n, Cvae, H/16, W/16)."""
    e = p["encoder"]
    nres = len(q["ch_mult"])
    h = _conv(e["conv_in"], img.float())
    for i, level in enumerate(e["down"]):
        for j in range(q["num_res_blocks"]):
            h = _res(level["block"][j], h)
            if level["attn"]:
                h = _attn(level["attn"][j], h)
        if i != nres - 1:
            h = _conv(level["downsample"], F.pad(h, (0, 1, 0, 1)), stride=2,
                      padding=0)
    h = _res(e["mid"]["block_1"], h)
    h = _attn(e["mid"]["attn_1"], h)
    h = _res(e["mid"]["block_2"], h)
    h = _conv(e["conv_out"], _swish(_gn(e["norm_out"], h)))
    return _conv(p["quant_conv"], h)
