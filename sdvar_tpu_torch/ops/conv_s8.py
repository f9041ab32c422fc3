"""W8A8 3x3 convolutions of the NHWC pixel decoder (the host side of
``sdvar_tpu/ops/pallas/conv_s8.py``).

- ``eligible``: which convs the JAX package lowers to its int8 kernel. The
  CUDA kernel takes any H and W; the predicate stays because it decides
  which decoder convs are sites, and the site order is the contract between
  a calibration and its sites (the JAX package's sites land on the same
  layers here).
- ``conv3x3_s8``: the int8 convolution with HWIO weights, as the JAX
  package calls it.
- ``quantize_site`` (numpy, bit for bit the JAX package's) and
  ``ConvSite``: a calibrated site's pre-quantized weights, with static
  per-input-channel activation scales folded into them.
- ``conv3x3_s8_static``: apply a site; ``conv2d_nhwc_w8a8``: the dynamic
  per-tensor entry (its activation scale depends on the whole batch; the
  server never uses it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sdvar_tpu_torch.ops.kernels.conv_s8 import conv3x3_s8_ohwi

SITE_KEYS = ("wq", "scale", "bias", "act_inv")


def eligible(shape, stride: int = 1) -> bool:
    """3x3 stride-1 "same" convs of (B, H, W, C) activations that are
    W8A8 sites."""
    B, H, W, C = shape
    return (stride == 1 and H % 8 == 0 and H >= 8 and W % 4 == 0
            and C % 4 == 0 and W >= 32)


def conv3x3_s8(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """NHWC 3x3 stride-1 pad-1 convolution of int8 x (B, H, W, C) with int8
    HWIO weights w8 (3, 3, C, O): exact s32 sums times ``scale`` (O,) plus
    ``bias`` (O,), f32, cast to ``out_dtype``; (B, H, W, O)."""
    if w8.shape[:2] != (3, 3):
        raise ValueError(f"conv3x3_s8: weights {tuple(w8.shape)} are not 3x3 HWIO")
    return conv3x3_s8_ohwi(x8, w8.permute(3, 0, 1, 2).contiguous(),
                           scale.float(), bias.float(), out_dtype)


@dataclass(frozen=True)
class ConvSite:
    """One calibrated conv site: ``wk`` int8 (O, 3, 3, C), the kernel's
    layout of ``quantize_site``'s HWIO ``wq``, with the activation scales
    folded in; ``scale`` (O,) f32 per-output dequant, ``bias`` (O,) f32,
    ``act_inv`` (C,) f32 (activation -> int8 multiplier)."""

    wk: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    act_inv: torch.Tensor


def site_from_arrays(arrays, device) -> ConvSite:
    """A ``ConvSite`` on ``device`` from numpy ``wq``/``scale``/``bias``/
    ``act_inv`` (the form ``quantize_site`` returns)."""
    t = {k: torch.from_numpy(np.array(arrays[k])).to(device) for k in SITE_KEYS}
    return ConvSite(wk=t.pop("wq").permute(3, 0, 1, 2).contiguous(), **t)


def quantize_site(w, b, act_amax, headroom: float = 1.0,
                  alpha: float = 0.65) -> dict:
    """Pre-quantize one conv site with static per-input-channel activation
    scales folded into the weights: y_o = sum_c (x_c / s_c) * (w_oc * s_c).

    w: (O, C, 3, 3) OIHW; act_amax: (C,) calibrated |x| maxima. ``alpha``
    interpolates the channel scale between per-tensor (0) and per-channel
    (1). The same numpy arithmetic as the JAX package, so the bits agree.
    Returns numpy arrays ``wq`` (int8 HWIO), ``scale``, ``bias``,
    ``act_inv``."""
    amax = np.maximum(_np(act_amax), 1e-12)
    eff = amax ** alpha * float(amax.max()) ** (1.0 - alpha)
    act_s = np.maximum(eff / 127.0 * headroom, 1e-12)
    wh = np.transpose(_np(w), (2, 3, 1, 0))  # HWIO
    wfold = wh * act_s[None, None, :, None]
    ws = np.maximum(np.max(np.abs(wfold), axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = np.clip(np.round(wfold / ws[None, None, None, :]), -127, 127)
    return {"wq": wq.astype(np.int8), "scale": ws,
            "bias": _np(b), "act_inv": 1.0 / act_s}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def quantize_static(site: ConvSite, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> int8 on the site's per-channel grid:
    ``clip(round(x * act_inv), -127, 127)`` in f32, ties to even."""
    return torch.clamp(torch.round(x.float() * site.act_inv), -127, 127
                       ).to(torch.int8)


def conv3x3_s8_static(site: ConvSite, x: torch.Tensor) -> torch.Tensor:
    """Apply a calibrated site to x (B, H, W, C): static per-channel
    activation quantization (values beyond the calibrated amax saturate),
    then the exact int8 convolution; (B, H, W, O) in x's dtype."""
    return conv3x3_s8_ohwi(quantize_static(site, x), site.wk, site.scale,
                           site.bias, x.dtype)


def conv2d_nhwc_w8a8(p, x: torch.Tensor) -> torch.Tensor:
    """W8A8 stand-in for an eligible 3x3 conv of x (B, H, W, C): per-Cout
    weight scales, one dynamic activation scale for the whole tensor, the
    exact int8 convolution; (B, H, W, O) in x's dtype."""
    wh = p["w"].permute(2, 3, 1, 0).float()  # OIHW -> HWIO
    wa = wh.abs().amax(dim=(0, 1, 2))
    # divisions by a device tensor: the IEEE quotient on either device
    ws = torch.clamp(wa / wa.new_full((), 127.0), min=1e-12)
    wq = torch.round(wh / ws).to(torch.int8)
    xf = x.float()
    xa = xf.abs().max()
    xs = torch.clamp(xa / xa.new_full((), 127.0), min=1e-12)
    xq = torch.round(xf / xs).to(torch.int8)
    return conv3x3_s8(xq, wq, ws * xs, p["b"], out_dtype=x.dtype)
