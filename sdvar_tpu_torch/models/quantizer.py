"""Multi-scale residual vector quantizer, decode half (the counterpart of
``sdvar_tpu/models/quantizer.py``): the codebook gather, the phi convs and
the per-scale state update of the generation loop. f32 throughout; the
resizes are dense f32 einsums (ops/resize.py).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.ops.resize import area_resize, bicubic_resize

Params = Dict[str, torch.Tensor]


def trunc_normal(shape, g: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverse-CDF sampling."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
    return (torch.erfinv(2 * u - 1) * math.sqrt(2)).clamp_(-2.0, 2.0)


def init_quantizer_params(cfg: VQVAEConfig, g: torch.Generator, device,
                          eini: float = -1.0) -> Params:
    """Codebook (V, Cvae) and stacked phi convs (K, Cvae, Cvae, 3, 3) OIHW
    with biases (K, Cvae). ``eini > 0``: codebook ~ truncated normal * eini;
    otherwise uniform in +/- |eini| / V."""
    V, C, K = cfg.vocab_size, cfg.Cvae, cfg.num_phi
    if eini > 0:
        codebook = trunc_normal((V, C), g, device) * eini
    else:
        lim = abs(eini) / V
        codebook = (torch.rand((V, C), generator=g, device=device) * 2 - 1) * lim
    phi_w = (torch.rand((K, C, C, 3, 3), generator=g, device=device) * 2 - 1
             ) / math.sqrt(C * 9)
    return {
        "codebook": codebook,
        "phi_w": phi_w,
        "phi_b": torch.zeros((K, C), device=device),
    }


def phi_apply(cfg: VQVAEConfig, params: Params, si: int,
              h_BChw: torch.Tensor) -> torch.Tensor:
    """phi(h) = (1-r)*h + r*conv3x3(h), with the phi conv chosen per scale."""
    r = abs(cfg.quant_resi)
    if r < 1e-6:
        return h_BChw
    k = cfg.phi_index(si)
    y = F.conv2d(h_BChw.float(), params["phi_w"][k], params["phi_b"][k],
                 padding=1)
    return h_BChw * (1.0 - r) + y * r


def embed(params: Params, idx: torch.Tensor) -> torch.Tensor:
    """Codebook gather: (...,) int -> (..., Cvae)."""
    return params["codebook"][idx.long()]


def next_autoregressive_input(
    cfg: VQVAEConfig, params: Params, si: int,
    f_hat: torch.Tensor, h_BChw: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale state update: h_BChw (B, C, pn, pn) is the embedding of the
    freshly sampled scale. Returns (new f_hat, next scale's input map)."""
    pns = cfg.patch_nums
    HW, SN = pns[-1], len(pns)
    if si != SN - 1:
        f_hat = f_hat + phi_apply(cfg, params, si,
                                  bicubic_resize(h_BChw, (HW, HW)))
        nxt = pns[si + 1]
        return f_hat, area_resize(f_hat, (nxt, nxt))
    f_hat = f_hat + phi_apply(cfg, params, si, h_BChw)
    return f_hat, f_hat
