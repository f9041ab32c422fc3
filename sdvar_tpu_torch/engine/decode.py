"""KV-cached CFG decode: labels -> 10 scales -> f_hat -> images (the
counterpart of ``sdvar_tpu/engine/decode.py``).

Per scale: one transformer forward over the scale's tokens against the KV
cache (classifier-free guidance by batch doubling, strength
t = cfg * si / (S-1)), top-k/top-p sampling through the fused sampler with
per-request seeds, and the residual-VQ state update. PyTorch runs eagerly,
so the scale loop is a Python loop; the cache is written in place.
`scale_step` and `decode_all_scales` run with TF32 off
(``utils.device.full_f32``): the head, the resizes and the phi convs are
f32 as in the JAX package.

The JAX version pads each scale's queries to a multiple of 64 (an XLA
matmul workaround) and writes the pad rows into the next scale's cache
slots; this port does not, so raw cache rows past ``kv_len`` differ from
JAX's while everything that is read agrees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import KVCache
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache
from sdvar_tpu_torch.ops.sampling import (
    cfg_double,
    cfg_mix,
    cfg_pair,
    request_seeds,
    row_seeds,
    sample_with_top_k_top_p,
)
from sdvar_tpu_torch.utils.device import full_f32, resolve_device

Seeds = Union[int, Sequence[int], torch.Tensor]
Cache = Union[KVCache, QuantizedKVCache]


@dataclasses.dataclass
class DecodeState:
    """Carries the decode across scales."""

    f_hat: torch.Tensor      # (B, Cvae, HW, HW) f32
    next_map: torch.Tensor   # (B, Cvae, pn', pn') input for the next scale
    cache: Cache
    seeds: torch.Tensor      # (B,) request seeds


def init_decode(
    var_cfg: VARConfig, params, label_B, seed: Seeds = 0,
    dtype=torch.bfloat16, kv_mode: str = "bf16",
    cache: Optional[Cache] = None, device="cuda",
) -> Tuple[DecodeState, torch.Tensor, torch.Tensor]:
    """Empty state, sos (2B, C) f32 and lvl_pos (L, C) f32 for a batch.

    The uncond rows use class id ``num_classes``. ``kv_mode``: "bf16",
    "f32" or "int8" (``QuantizedKVCache``: per-token-scaled INT8).
    ``cache``: a preallocated KVCache or QuantizedKVCache to reuse (every
    scale reads only rows written earlier in the same decode).
    """
    dev = resolve_device(device)
    if params["class_emb"].device != dev:
        raise ValueError(f"parameters lie on {params['class_emb'].device}, "
                         f"decode asked for {dev}")
    if kv_mode not in ("bf16", "f32", "int8"):
        raise ValueError(f"unknown kv_mode {kv_mode!r} (bf16 | f32 | int8)")
    label_B = torch.as_tensor(label_B, dtype=torch.long, device=dev)
    B = label_B.shape[0]
    label_2B = cfg_pair(label_B, torch.full_like(label_B, var_cfg.num_classes))
    lvl_pos = M.lvl_pos_embed(var_cfg, params).float()
    sos = params["class_emb"][label_2B].float()
    HW = var_cfg.patch_nums[-1]
    if cache is None and kv_mode == "int8":
        cache = QuantizedKVCache.create(var_cfg, 2 * B, device=dev)
    elif cache is None:
        cache = KVCache.create(
            var_cfg, 2 * B, device=dev,
            dtype=torch.float32 if kv_mode == "f32" else torch.bfloat16)
    state = DecodeState(
        f_hat=torch.zeros((B, var_cfg.Cvae, HW, HW), device=dev),
        next_map=torch.zeros((B, var_cfg.Cvae, 1, 1), device=dev),
        cache=cache,
        seeds=request_seeds(seed, B, dev),
    )
    return state, sos, lvl_pos


@full_f32()
def scale_step(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, params, quant_params,
    si: int, state: DecodeState, sos: torch.Tensor, lvl_pos: torch.Tensor,
    samp: SamplingConfig, dtype=torch.bfloat16,
    mods: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
) -> Tuple[DecodeState, torch.Tensor]:
    """One scale of KV-cached CFG decode -> (state', ids (B, pn^2) int32).
    ``attn_bias``: an optional (pn^2, kv_len) additive bias for this step
    (None attends the whole cache, the baseline)."""
    if samp.more_smooth:
        raise NotImplementedError("more_smooth sampling is not ported")
    pn = var_cfg.patch_nums[si]
    bg, ed = var_cfg.begin_ends[si]
    B = sos.shape[0] // 2

    if si == 0:
        x = (sos[:, None, :] + params["pos_start"][None]
             + lvl_pos[None, : var_cfg.first_l]).to(dtype)
    else:
        # (B, C, pn, pn) -> (B, pn^2, C): tokens in row-major spatial order
        nm = state.next_map.reshape(B, var_cfg.Cvae, pn * pn).transpose(1, 2)
        x = M.word_embed(params, nm, torch.float32) + lvl_pos[None, bg:ed]
        x = cfg_double(x).to(dtype)

    h = M.apply_transformer(var_cfg, params, x, sos, attn_bias=attn_bias,
                            cache=state.cache, cache_begin=bg, kv_len=ed,
                            mods=mods)
    logits = M.get_logits(var_cfg, params, h, sos)  # (2B, pn^2, V) f32

    t = samp.cfg * si / var_cfg.num_stages_minus_1
    mixed = cfg_mix(logits, t)
    ids = sample_with_top_k_top_p(mixed, row_seeds(state.seeds, si, pn * pn),
                                  samp.top_k, samp.top_p)

    h_BlC = Q.embed(quant_params, ids)                        # (B, pn^2, Cvae)
    h_BChw = h_BlC.transpose(1, 2).reshape(B, var_cfg.Cvae, pn, pn)
    f_hat, next_map = Q.next_autoregressive_input(
        vae_cfg, quant_params, si, state.f_hat, h_BChw)
    return dataclasses.replace(state, f_hat=f_hat, next_map=next_map), ids


@torch.inference_mode()
@full_f32()
def decode_all_scales(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, params, quant_params,
    label_B, seed: Seeds = 0,
    samp: SamplingConfig = SamplingConfig(), dtype=torch.bfloat16,
    return_ids: bool = False, kv_mode: str = "bf16",
    cache: Optional[Cache] = None, return_cache: bool = False,
    device="cuda",
):
    """All scales -> f_hat (B, Cvae, HW, HW), optionally with the sampled
    ids (B, L) and the KV cache (pass it back as ``cache`` to reuse it)."""
    state, sos, lvl_pos = init_decode(var_cfg, params, label_B, seed, dtype,
                                      kv_mode=kv_mode, cache=cache,
                                      device=device)
    mods = M.precompute_modulations(var_cfg, params, sos)
    ids_all = []
    for si in range(var_cfg.num_scales):
        state, ids = scale_step(var_cfg, vae_cfg, params, quant_params, si,
                                state, sos, lvl_pos, samp, dtype, mods=mods)
        ids_all.append(ids)
    out = (state.f_hat,)
    if return_ids:
        out += (torch.cat(ids_all, dim=1),)
    if return_cache:
        out += (state.cache,)
    return out if len(out) > 1 else out[0]


@torch.inference_mode()
def generate_images(
    var_cfg: VARConfig, vae_cfg: VQVAEConfig, var_params, vae_params,
    label_B, seed: Seeds = 0,
    samp: SamplingConfig = SamplingConfig(), dtype=torch.bfloat16,
    kv_mode: str = "bf16", device="cuda",
) -> torch.Tensor:
    """Labels -> images (B, 3, H, W) in [0, 1], f32.

    ``seed``: an int for the whole batch, or one seed per request; with
    one seed per request, a request's image depends only on its label and
    seed, not on its batch slot. ``kv_mode`` as in ``init_decode``."""
    f_hat = decode_all_scales(var_cfg, vae_cfg, var_params,
                              vae_params["quant"], label_B, seed, samp, dtype,
                              kv_mode=kv_mode, device=device)
    img = VQ.fhat_to_img(vae_cfg, vae_params, f_hat)
    return (img + 1.0) * 0.5
