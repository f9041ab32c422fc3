"""Multi-scale residual vector quantizer (the counterpart of
``sdvar_tpu/models/quantizer.py``): the codebook gather, the phi convs and
the per-scale state update of the generation loop; the residual-pyramid
``encode`` (nearest codebook entry per scale), ``idx_to_var_input`` (the
training forward's teacher-forcing input) and ``embed_to_fhat``; and the
training half of VQVAE training: ``vq_train_forward`` (straight-through
f_hat, per-scale codebook hits, the commitment and codebook losses),
``update_vocab_hit_ema`` and ``vocab_usage_per_scale``. f32 throughout;
the resizes are dense f32 einsums (ops/resize.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

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


def lookup_codes(cfg: VQVAEConfig, params: Params, z_NC: torch.Tensor
                 ) -> torch.Tensor:
    """Nearest codebook index of each row (N, C) -> (N,) int32: argmin of
    ||z||^2 + ||e||^2 - 2 z.e, or with ``using_znorm`` argmax of the
    cosine similarity; ties go to the first index."""
    E = params["codebook"].float()
    z = z_NC.float()
    if cfg.using_znorm:
        zn = z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        En = E / E.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return (zn @ En.t()).argmax(dim=-1).to(torch.int32)
    d = (z * z).sum(-1, keepdim=True) + (E * E).sum(-1)[None] - 2.0 * (z @ E.t())
    return d.argmin(dim=-1).to(torch.int32)


def _upsample_refine(cfg: VQVAEConfig, params: Params, si: int,
                     h_BChw: torch.Tensor, hw: int) -> torch.Tensor:
    """A scale's embedding map bicubic-upsampled to the full grid, then
    phi."""
    if h_BChw.shape[-1] != hw:
        h_BChw = bicubic_resize(h_BChw, (hw, hw))
    return phi_apply(cfg, params, si, h_BChw)


def encode(cfg: VQVAEConfig, params: Params, f_BChw: torch.Tensor,
           patch_nums: Optional[Sequence[int]] = None,
           return_fhat: bool = False) -> List[torch.Tensor]:
    """Residual-pyramid encode of f (B, C, H, W): per scale the residual is
    area-resized to (pn, pn), looked up in the codebook, and its embedding
    upsampled, refined by phi, added to f_hat and taken off the residual.
    Returns the per-scale ids (B, pn*pn) int32, or the running f_hat of
    each scale with ``return_fhat``."""
    pns = tuple(patch_nums or cfg.patch_nums)
    B, C, H, W = f_BChw.shape
    if not pns[-1] == H == W:
        raise ValueError(f"encode: patch_nums {pns} end at {pns[-1]}, "
                         f"f is {H}x{W}")
    f_rest = f_BChw.float()
    f_hat = torch.zeros_like(f_rest)
    out = []
    for si, pn in enumerate(pns):
        z = f_rest if si == len(pns) - 1 else area_resize(f_rest, (pn, pn))
        idx_N = lookup_codes(cfg, params, z.permute(0, 2, 3, 1).reshape(-1, C))
        h = embed(params, idx_N).reshape(B, pn, pn, C).permute(0, 3, 1, 2)
        h = _upsample_refine(cfg, params, si, h, H)
        f_hat = f_hat + h
        f_rest = f_rest - h
        out.append(f_hat if return_fhat else idx_N.reshape(B, pn * pn))
    return out


def idx_to_var_input(cfg: VQVAEConfig, params: Params,
                     gt_idx_Bl: List[torch.Tensor]) -> torch.Tensor:
    """Teacher-forcing input of the training forward: for each scale but
    the last, f_hat rebuilt from the ground-truth ids and area-resized to
    the next scale; concatenated -> (B, L - first_l, Cvae) f32."""
    pns = cfg.patch_nums
    B = gt_idx_Bl[0].shape[0]
    C, HW = cfg.Cvae, pns[-1]
    f_hat = torch.zeros((B, C, HW, HW), device=gt_idx_Bl[0].device)
    pieces = []
    for si in range(len(pns) - 1):
        pn = pns[si]
        h = embed(params, gt_idx_Bl[si]).reshape(B, pn, pn, C).permute(0, 3, 1, 2)
        h = bicubic_resize(h, (HW, HW)) if pn != HW else h
        f_hat = f_hat + phi_apply(cfg, params, si, h)
        nxt = pns[si + 1]
        nmap = area_resize(f_hat, (nxt, nxt))
        pieces.append(nmap.reshape(B, C, nxt * nxt).transpose(1, 2))
    return torch.cat(pieces, dim=1)


def embed_to_fhat(cfg: VQVAEConfig, params: Params,
                  ms_h_BChw: List[torch.Tensor], last_one: bool = False):
    """Accumulate per-scale embedding maps (B, C, pn, pn) into f_hat: the
    running f_hat of each scale, or only the last with ``last_one``."""
    HW = cfg.patch_nums[-1]
    B = ms_h_BChw[0].shape[0]
    f_hat = torch.zeros((B, cfg.Cvae, HW, HW), device=ms_h_BChw[0].device)
    outs = []
    for si, h in enumerate(ms_h_BChw):
        f_hat = f_hat + _upsample_refine(cfg, params, si, h.float(), HW)
        if not last_one:
            outs.append(f_hat)
    return f_hat if last_one else outs


# ---------------------------------------------------------------------------
# the training half: VQVAE training's quantize pass and codebook statistics
# ---------------------------------------------------------------------------

def vq_train_forward(cfg: VQVAEConfig, params: Params, f_BChw: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantize pass of VQVAE training. Returns (f_hat with the
    straight-through estimator ``f + (f_hat - f).detach()``: the values of
    f_hat, the gradient of f; the per-scale codebook hits (SN, V) f32, the
    ``bincount`` of each scale's ids; the mean over scales of the
    beta-weighted commitment term ``beta * mse(f_hat.detach(), f)`` plus
    the codebook term ``mse(f_hat, f.detach())``). The hits are this
    rank's: a trainer on a mesh sums them over "data"."""
    B, C, H, W = f_BChw.shape
    f = f_BChw.float()
    f_ng = f.detach()
    f_rest = f_ng
    f_hat = torch.zeros_like(f_ng)
    SN, V = len(cfg.patch_nums), cfg.vocab_size
    loss = 0.0
    hits = []
    for si, pn in enumerate(cfg.patch_nums):
        z = f_rest if si == SN - 1 else area_resize(f_rest, (pn, pn))
        idx_N = lookup_codes(cfg, params, z.permute(0, 2, 3, 1).reshape(-1, C))
        hits.append(torch.bincount(idx_N.long(), minlength=V).float())
        h = embed(params, idx_N).reshape(B, pn, pn, C).permute(0, 3, 1, 2)
        h = _upsample_refine(cfg, params, si, h, H)
        f_hat = f_hat + h
        f_rest = f_rest - h
        loss = loss + cfg.beta * ((f_hat.detach() - f) ** 2).mean() \
            + ((f_hat - f_ng) ** 2).mean()
    loss = loss / SN
    f_hat_st = f + (f_hat - f_ng).detach()
    return f_hat_st, torch.stack(hits), loss


def update_vocab_hit_ema(ema_SV: torch.Tensor, hit_SV: torch.Tensor,
                         record_hit: int) -> torch.Tensor:
    """The EMA codebook-hit tracker: step 0 copies the hits, steps below 100
    blend 0.9 / 0.1, later steps 0.99 / 0.01. ``hit_SV`` must already be
    summed over the data ranks."""
    if record_hit == 0:
        return hit_SV.clone()
    if record_hit < 100:
        return ema_SV * 0.9 + hit_SV * 0.1
    return ema_SV * 0.99 + hit_SV * 0.01


def vocab_usage_per_scale(cfg: VQVAEConfig, ema_SV: torch.Tensor,
                          batch_tokens: int, world_size: int = 1
                          ) -> torch.Tensor:
    """Per-scale % of codebook entries in use: an entry counts where its
    EMA hit count reaches ``world_size * batch_tokens / V * 0.08``
    (``batch_tokens``: B*H*W of the last feature map of one rank). Returns
    (SN,) f32."""
    margin = world_size * batch_tokens / cfg.vocab_size * 0.08
    return (ema_SV >= margin).float().mean(dim=-1) * 100.0
