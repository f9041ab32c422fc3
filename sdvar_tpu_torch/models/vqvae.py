"""VQVAE pixel decoder (the decoder half of ``sdvar_tpu/models/vqvae.py``):
GroupNorm(32) + swish ResNet blocks, single-head non-local attention at the
lowest resolution and in the mid block, nearest x2 upsampling + conv.

Two layouts of the same program on the same OIHW weights:

- NCHW, f32 throughout: the golden pixel path. ``fhat_to_img`` turns TF32
  off while it runs (``utils.device.full_f32``), so the convolutions run in
  full f32 as the JAX package's ``Precision.HIGHEST`` does.
  ``fhat_to_img_bf16`` runs it in bf16.
- Channels-last, the serving pixel path: ``fhat_to_img_nhwc`` (bf16, or f32
  with TF32 off), and the W8A8 decoders whose eligible 3x3 convs run
  through the int8 kernel (``ops/conv_s8.py``). Activations keep their
  NCHW logical shape in ``torch.channels_last`` memory, which cuDNN's convs
  read and write as they are and which is a contiguous (B, H, W, C) view
  for the int8 kernel, so no layout copy is made around a site.

Which convs are W8A8 sites is decided by a site plan passed down the
decoder (``Calibrate``, ``StaticSites``, or ``ops.conv_s8.conv2d_nhwc_w8a8``
itself; ``None`` runs every conv in the activation dtype). The plan visits
the eligible convs in decoder call order, the contract between a
calibration and its sites.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.ops import conv_s8 as CS8
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


def _cast(tree, dtype):
    """The tree with its floating leaves in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


@torch.inference_mode()
def fhat_to_img_bf16(cfg: VQVAEConfig, p: Params, f_hat: torch.Tensor
                     ) -> torch.Tensor:
    """The NCHW decoder with bf16 weights and activations (GroupNorm
    statistics stay f32) -> image in [-1, 1], f32 NCHW."""
    pc = _cast({"post_quant_conv": p["post_quant_conv"],
                "decoder": p["decoder"]}, torch.bfloat16)
    z = conv2d(pc["post_quant_conv"], f_hat.to(torch.bfloat16))
    img = decoder_forward(cfg, pc["decoder"], z)
    return img.float().clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# channels-last decoder and its W8A8 site plans
# ---------------------------------------------------------------------------

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) in channels_last memory -> its (B, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) contiguous -> its (B, C, H, W) channels_last view."""
    return y.permute(0, 3, 1, 2)


class Calibrate:
    """Site plan that records, at each eligible conv, the per-input-channel
    |x| maximum (f32) with the conv's weights and the activation's
    (B, H, W, C) shape, and runs the conv unquantized."""

    def __init__(self):
        self.records = []

    def __call__(self, p: Params, x: torch.Tensor) -> Optional[torch.Tensor]:
        amax = x.float().abs().amax(dim=(0, 1, 2))
        self.records.append((amax, p["w"], p["b"], tuple(x.shape)))
        return None


class StaticSites:
    """Site plan that hands out calibrated sites in call order; a ``None``
    site runs the conv unquantized. ``finish`` checks that every site was
    used."""

    def __init__(self, sites: Sequence[Optional[CS8.ConvSite]]):
        self.sites = tuple(sites)
        self.used = 0

    def __call__(self, p: Params, x: torch.Tensor) -> Optional[torch.Tensor]:
        if self.used >= len(self.sites):
            raise ValueError(f"the decoder has more eligible convs than the "
                             f"{len(self.sites)} sites given")
        site = self.sites[self.used]
        self.used += 1
        return None if site is None else CS8.conv3x3_s8_static(site, x)

    def finish(self) -> None:
        if self.used != len(self.sites):
            raise ValueError(f"{len(self.sites)} sites given for a decoder "
                             f"with {self.used} eligible convs")


# A request's pixels must not depend on its slot in the batch. On an H100,
# cuDNN 9.2 runs the bf16 640-channel 3x3 convs at 16x16 and 32x32 as
# implicit GEMMs that split K by tile index, so some images come out with
# other bits in another slot. 3x3 convs this narrow therefore run one image
# per call; ``tools/probe_slot_invariance.py`` measures both the slot
# dependence (with this set to 0) and what the split costs.
PER_IMAGE_MAX_W = 32


def conv2d_nhwc(p: Params, x: torch.Tensor, stride: int = 1,
                padding: int = 1, plan=None) -> torch.Tensor:
    """Convolution of channels_last x with the f32 OIHW weights of ``p``,
    cast to x's dtype as they are read; an eligible 3x3 stride-1 "same"
    conv goes to ``plan`` first (see the site plans above). 3x3 convs at
    widths up to ``PER_IMAGE_MAX_W`` run one image per call."""
    if (plan is not None and stride == 1 and padding == 1
            and p["w"].shape[2:] == (3, 3) and CS8.eligible(_nhwc(x).shape)):
        y = plan(p, _nhwc(x))
        if y is not None:
            return _nchw(y)
    w = p["w"].to(dtype=x.dtype, memory_format=torch.channels_last)
    b = p["b"].to(x.dtype)
    if p["w"].shape[2] == 3 and x.shape[0] > 1 and x.shape[3] <= PER_IMAGE_MAX_W:
        return torch.cat([F.conv2d(xi, w, b, stride=stride, padding=padding)
                          for xi in x.split(1)]
                         ).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def group_norm_nhwc(p: Params, x: torch.Tensor, groups: int = 32,
                    eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with f32 statistics from per-channel sums and sums of
    squares (variance = E[x^2] - mean^2, the JAX package's channels-last
    form), normalised in f32, cast to x's dtype before the affine."""
    B, C, H, W = x.shape
    xf = x.float()
    cpg = C // groups
    s1 = xf.sum(dim=(2, 3)).reshape(B, groups, cpg).sum(-1)
    s2 = (xf * xf).sum(dim=(2, 3)).reshape(B, groups, cpg).sum(-1)
    cnt = H * W * cpg
    mu = s1 / cnt
    var = s2 / cnt - mu * mu
    mu_c = mu.repeat_interleave(cpg, dim=1)[:, :, None, None]
    rstd_c = torch.rsqrt(var + eps).repeat_interleave(cpg, dim=1)[:, :, None, None]
    xn = ((xf - mu_c) * rstd_c).to(x.dtype)
    g, b = p["g"].to(x.dtype), p["b"].to(x.dtype)
    return xn * g[None, :, None, None] + b[None, :, None, None]


def resnet_block_nhwc(p: Params, x: torch.Tensor, plan=None) -> torch.Tensor:
    h = conv2d_nhwc(p["conv1"], swish(group_norm_nhwc(p["norm1"], x)), plan=plan)
    h = conv2d_nhwc(p["conv2"], swish(group_norm_nhwc(p["norm2"], h)), plan=plan)
    if "nin_shortcut" in p:
        x = conv2d_nhwc(p["nin_shortcut"], x, padding=0, plan=plan)
    return x + h


def attn_block_nhwc(p: Params, x: torch.Tensor, plan=None) -> torch.Tensor:
    """Non-local single-head self-attention over the H*W positions, the
    tokens read as rows of the channels-last activation."""
    B, C, H, W = x.shape
    qkv = conv2d_nhwc(p["qkv"], group_norm_nhwc(p["norm"], x), padding=0,
                      plan=plan)
    q, k, v = _nhwc(qkv).reshape(B, H * W, 3 * C).chunk(3, dim=2)
    w = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k) * C ** -0.5, dim=2)
    h = torch.einsum("bnm,bmc->bnc", w, v).reshape(B, H, W, C)
    return x + conv2d_nhwc(p["proj_out"], _nchw(h), padding=0, plan=plan)


def upsample2x_nhwc(p: Params, x: torch.Tensor, plan=None) -> torch.Tensor:
    """Nearest x2 (channels_last in and out) then conv."""
    return conv2d_nhwc(p, F.interpolate(x, scale_factor=2, mode="nearest"),
                       plan=plan)


def decoder_forward_nhwc(cfg: VQVAEConfig, p: Params, z: torch.Tensor,
                         plan=None) -> torch.Tensor:
    """(B, Cvae, h, w) -> (B, 3, 16h, 16w), channels_last; the program of
    ``decoder_forward``."""
    nres = len(cfg.ch_mult)
    h = conv2d_nhwc(p["conv_in"], z, plan=plan)
    h = resnet_block_nhwc(p["mid"]["block_1"], h, plan)
    if cfg.using_mid_sa:
        h = attn_block_nhwc(p["mid"]["attn_1"], h, plan)
    h = resnet_block_nhwc(p["mid"]["block_2"], h, plan)
    for i in reversed(range(nres)):
        level = p["up"][i]
        for j in range(cfg.num_res_blocks + 1):
            h = resnet_block_nhwc(level["block"][j], h, plan)
            if level["attn"]:
                h = attn_block_nhwc(level["attn"][j], h, plan)
        if i != 0:
            h = upsample2x_nhwc(level["upsample"], h, plan)
    return conv2d_nhwc(p["conv_out"], swish(group_norm_nhwc(p["norm_out"], h)),
                       plan=plan)


def _decode_nhwc(cfg: VQVAEConfig, p: Params, f_hat: torch.Tensor, dtype,
                 plan=None) -> torch.Tensor:
    """f_hat (B, Cvae, HW, HW) -> decoder output in ``dtype``,
    channels_last."""
    z = f_hat.to(dtype=dtype, memory_format=torch.channels_last)
    z = conv2d_nhwc(p["post_quant_conv"], z, plan=plan)
    return decoder_forward_nhwc(cfg, p["decoder"], z, plan)


def _to_image(y: torch.Tensor) -> torch.Tensor:
    """Decoder output -> f32 contiguous NCHW image in [-1, 1]."""
    return y.float().clamp(-1.0, 1.0).contiguous()


@torch.inference_mode()
def fhat_to_img_nhwc(cfg: VQVAEConfig, p: Params, f_hat: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Channels-last pixel decode, bf16 (the serving decoder) or f32 with
    TF32 off (the JAX package's "highest"); f_hat (B, Cvae, HW, HW) ->
    image in [-1, 1], f32 NCHW."""
    if dtype == torch.float32:
        with full_f32():
            return _to_image(_decode_nhwc(cfg, p, f_hat, dtype))
    if dtype != torch.bfloat16:
        raise ValueError(f"fhat_to_img_nhwc: dtype {dtype} (bfloat16 or float32)")
    return _to_image(_decode_nhwc(cfg, p, f_hat, dtype))


@torch.inference_mode()
def fhat_to_img_nhwc_w8a8(cfg: VQVAEConfig, p: Params, f_hat: torch.Tensor
                          ) -> torch.Tensor:
    """bf16 channels-last decode with every eligible 3x3 conv in W8A8
    (per-Cout weight scales, per-tensor dynamic activation scale)."""
    return _to_image(_decode_nhwc(cfg, p, f_hat, torch.bfloat16,
                                  CS8.conv2d_nhwc_w8a8))


@torch.inference_mode()
def calibrate_decoder_w8a8(cfg: VQVAEConfig, p: Params, f_hats,
                           headroom: float = 1.0, alpha: float = 0.65,
                           min_w: int = 0):
    """Static per-channel W8A8 calibration of the channels-last decoder: run
    the bf16 decoder over the calibration ``f_hats`` (one batch or a list),
    take each eligible conv's per-input-channel activation maximum over
    all of them, fold those channel scales into the weights and quantize
    per output channel (``ops.conv_s8.quantize_site``). Sites whose
    activation width is below ``min_w`` stay unquantized (``None``).
    Returns one entry per eligible conv, in decoder call order, on the
    parameters' device."""
    if not isinstance(f_hats, (list, tuple)):
        f_hats = [f_hats]
    runs = []
    for fh in f_hats:
        plan = Calibrate()
        _decode_nhwc(cfg, p, fh, torch.bfloat16, plan)
        runs.append(plan.records)
    if len({len(r) for r in runs}) != 1:
        raise ValueError("calibration batches visited different numbers of sites")
    dev = p["decoder"]["conv_out"]["w"].device
    sites = []
    for recs in zip(*runs):
        amax = np.max(np.stack([a.cpu().numpy() for a, _, _, _ in recs]), axis=0)
        _, w, b, shape = recs[0]
        sites.append(None if shape[2] < min_w else CS8.site_from_arrays(
            CS8.quantize_site(w, b, amax, headroom=headroom, alpha=alpha), dev))
    return tuple(sites)


@torch.inference_mode()
def fhat_to_img_nhwc_w8a8_static(cfg: VQVAEConfig, p: Params,
                                 f_hat: torch.Tensor, sites) -> torch.Tensor:
    """bf16 channels-last decode with the calibrated ``sites`` of
    ``calibrate_decoder_w8a8`` (or the JAX package's, through
    ``utils.from_jax.pixel_sites_from_jax``)."""
    plan = StaticSites(sites)
    img = _to_image(_decode_nhwc(cfg, p, f_hat, torch.bfloat16, plan))
    plan.finish()
    return img


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
