"""VAR decoder-only transformer over the flattened scale sequence, inference
only (the counterpart of ``sdvar_tpu/models/var.py``).

Parameters are a nested dict of tensors with the JAX package's layout:
per-layer tensors stacked on a leading ``depth`` axis, linear weights as
(in, out), or as INT8 leaves (``ops.quantization.QuantizedLinear`` /
``W8A8Linear``) after ``quantize_var_params``. The block stack is a Python
loop over layers. Casts follow the JAX package: LayerNorm statistics in
f32, AdaLN modulations in f32 cast to the activation dtype, the head
(AdaLN-before-head + classifier) in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.ops.attention import (
    attention,
    attention_cache_write,
    use_cache_kernel,
)
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize
from sdvar_tpu_torch.ops.quantization import (
    QuantizedKVCache,
    W8A8Linear,
    layer_slice,
    linear_blc,
    quantize_tokens,
    resolve_weight,
    w8a8_prequant_matmul,
)
from sdvar_tpu_torch.utils.device import resolve_device

Params = Dict


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache, batch-major (depth, B, L_max, H*hd).

    The JAX package stores the token axis ahead of batch because XLA's
    layout assignment preferred it; here the kernel reads any strides, and
    batch-major makes one layer's slice [0, kv_len) a plain strided view.
    Each scale writes its new keys/values IN PLACE at [layer, :, begin:end)
    (the JAX version returns an updated functional copy); rows past
    ``kv_len`` are never read, so a cache can be reused across decodes.
    """

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: VARConfig, batch: int, dtype=torch.bfloat16,
               device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.depth, batch, cfg.L, cfg.num_heads * cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# Initialization: the JAX initialisers' distributions (reference
# init_weights with its defaults, std sqrt(1/C/3) for the trunc-normal
# weights), drawn on the device from a seeded generator.
# ---------------------------------------------------------------------------

INIT_ADALN = 0.5
INIT_ADALN_GAMMA = 1e-5
INIT_HEAD = 0.02


def init_var_params(cfg: VARConfig, seed: int = 0, device="cuda",
                    dtype=torch.float32) -> Params:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    C, D, V = cfg.embed_dim, cfg.cond_dim, cfg.vocab_size
    H, depth, hidden = cfg.num_heads, cfg.depth, cfg.mlp_hidden
    std = math.sqrt(1 / C / 3)

    def tn(shape):
        # clipped normal: the +/-2 bounds of trunc_normal_ sit >40 sigma out
        x = torch.randn(shape, generator=g, device=dev)
        return x.mul_(std).clamp_(-2.0, 2.0).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    blocks = {
        "qkv_w": tn((depth, C, 3 * C)),
        "q_bias": zeros(depth, C),
        "v_bias": zeros(depth, C),
        "proj_w": tn((depth, C, C)) / math.sqrt(2 * depth),
        "proj_b": zeros(depth, C),
        "fc1_w": tn((depth, C, hidden)),
        "fc1_b": zeros(depth, hidden),
        "fc2_w": tn((depth, hidden, C)) / math.sqrt(2 * depth),
        "fc2_b": zeros(depth, C),
    }
    if cfg.attn_l2_norm:
        blocks["scale_mul"] = torch.full((depth, H), math.log(4.0),
                                         dtype=dtype, device=dev)
    if cfg.shared_aln:
        gss = torch.randn((depth, 1, 6, C), generator=g, device=dev) / math.sqrt(C)
        gss[:, :, 2:] *= INIT_ADALN
        gss[:, :, :2] *= INIT_ADALN_GAMMA
        blocks["ada_gss"] = gss.to(dtype)
    else:
        w = tn((depth, D, 6 * C))
        w[:, :, 2 * C:] *= INIT_ADALN
        w[:, :, : 2 * C] *= INIT_ADALN_GAMMA
        blocks["ada_lin_w"] = w
        blocks["ada_lin_b"] = zeros(depth, 6 * C)

    params = {
        "word_embed": {"w": tn((cfg.Cvae, C)), "b": zeros(C)},
        "class_emb": tn((cfg.num_classes + 1, C)),
        "pos_start": tn((cfg.first_l, C)),
        "pos_1LC": tn((cfg.L, C)),
        "lvl_embed": tn((cfg.num_scales, C)),
        "blocks": blocks,
        "head_nm": {"w": tn((D, 2 * C)) * INIT_ADALN, "b": zeros(2 * C)},
        "head": {"w": tn((C, V)) * INIT_HEAD, "b": zeros(V)},
    }
    if cfg.shared_aln:
        params["shared_ada_lin"] = {"w": tn((D, 6 * C)), "b": zeros(6 * C)}
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine, statistics in f32, cast back."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _l2norm_heads(x: torch.Tensor, rmul: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Per-head L2 normalisation of (B, L, H, hd) in f32:
    x * rsqrt(max(||x||^2, 1e-24)) (== x / max(||x||, 1e-12)), with an
    optional per-head (H,) factor folded into the reciprocal."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).sum(dim=-1).clamp(min=1e-24))
    if rmul is not None:
        r = r * rmul
    return (x32 * r[..., None]).to(x.dtype)


def cond_six(cfg: VARConfig, params: Params, cond_BD: torch.Tensor
             ) -> torch.Tensor:
    """Shared part of the AdaLN conditioning, f32: silu(cond) (B, D), or,
    with shared AdaLN, the (B, 1, 6, C) shared projection."""
    c = F.silu(cond_BD.float())
    if cfg.shared_aln:
        sal = params["shared_ada_lin"]
        g = c @ sal["w"].float() + sal["b"]
        return g.reshape(-1, 1, 6, cfg.embed_dim)
    return c


def precompute_modulations(cfg: VARConfig, params: Params,
                           cond_BD: torch.Tensor) -> torch.Tensor:
    """All-layer AdaLN modulations (depth, B, 6, C) f32, computed once per
    generation (they depend on the class conditioning only)."""
    C = cfg.embed_dim
    cond_pre = cond_six(cfg, params, cond_BD)
    blocks = params["blocks"]
    if cfg.shared_aln:
        return cond_pre[None, :, 0] + blocks["ada_gss"][:, :1].float()
    w_all = blocks["ada_lin_w"]  # a dequantised layer at a time when INT8
    return torch.stack([
        (cond_pre @ resolve_weight(layer_slice(w_all, li), torch.float32)
         + b).reshape(-1, 6, C)
        for li, b in enumerate(blocks["ada_lin_b"])
    ])


def _attention(cfg: VARConfig, layer: Dict, x: torch.Tensor,
               attn_bias: Optional[torch.Tensor],
               cache: Union[KVCache, QuantizedKVCache, None],
               li: int, cache_begin: int, kv_len: int) -> torch.Tensor:
    """Self-attention for one block. With a cache, this layer's new keys
    and values are written in place at [li, :, cache_begin:...) and the
    attention reads keys [0, kv_len) straight from the cache; an INT8 cache
    takes the new tokens quantized, with their per-token scales beside
    them, and the attention kernel dequantises as it reads. With the
    cache-kernel switch on (``ops.attention.set_cache_kernel``), one fused
    call does the write and the attention, for every cache the decode
    makes (bf16; f32 under an f32 or bf16 model; int8); any other pairing
    of cache and model dtype raises."""
    B, L, C = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    qkv_bias = torch.cat([layer["q_bias"], torch.zeros_like(layer["q_bias"]),
                          layer["v_bias"]]).to(x.dtype)
    qkv = linear_blc(x, layer["qkv_w"], x.dtype) + qkv_bias
    q, k, v = qkv.view(B, L, 3, H, hd).unbind(2)  # (B, L, H, hd) views

    if cfg.attn_l2_norm:
        scale = 1.0
        smul = torch.exp(layer["scale_mul"].float().clamp(max=math.log(100.0)))
        q = _l2norm_heads(q, smul)
        k = _l2norm_heads(k)
    else:
        scale = 0.25 / math.sqrt(hd)

    if cache is not None and use_cache_kernel():
        # one call writes this layer's new rows into the cache and attends
        # over [0, kv_len): an int8 cache takes them quantized, with their
        # per-token scales, a float cache in the compute dtype
        new_scales = cache_scales = None
        if isinstance(cache, QuantizedKVCache):
            (k, ks), (v, vs) = (quantize_tokens(t.reshape(B, L, C))
                                for t in (k, v))
            k, v = k.view(B, L, H, hd), v.view(B, L, H, hd)
            new_scales, cache_scales = (ks, vs), (cache.k_s, cache.v_s)
        out = attention_cache_write(q, k, v, cache.k, cache.v, li,
                                    cache_begin, kv_len, attn_bias, scale,
                                    new_scales, cache_scales)
    else:
        kv_scales = None
        if cache is not None:
            end = cache_begin + L
            if isinstance(cache, QuantizedKVCache):
                for vals, scales, new in ((cache.k, cache.k_s, k),
                                          (cache.v, cache.v_s, v)):
                    nq, ns = quantize_tokens(new.reshape(B, L, C))
                    vals[li, :, cache_begin:end] = nq
                    scales[li, :, cache_begin:end] = ns
                kv_scales = (cache.k_s[li, :, :kv_len],
                             cache.v_s[li, :, :kv_len])
            else:
                cache.k[li, :, cache_begin:end] = k.reshape(B, L, C)
                cache.v[li, :, cache_begin:end] = v.reshape(B, L, C)
            k = cache.k[li, :, :kv_len].view(B, kv_len, H, hd)
            v = cache.v[li, :, :kv_len].view(B, kv_len, H, hd)
            if kv_scales is None and k.dtype != x.dtype:  # f32 cache, bf16 model
                k, v = k.to(x.dtype), v.to(x.dtype)
        out = attention(q, k, v, attn_bias, scale, kv_scales=kv_scales)
    out = out.reshape(B, L, C)
    return linear_blc(out, layer["proj_w"], x.dtype) + layer["proj_b"].to(x.dtype)


def _ffn(layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """MLP with tanh-GELU. A W8A8 fc2 takes the fused route: fc1, then
    bias + GELU (f32) + per-token int8 quantization in one pass, then the
    exact s8 x s8 -> s32 product."""
    fc2 = layer["fc2_w"]
    if isinstance(fc2, W8A8Linear):
        h = linear_blc(x, layer["fc1_w"], x.dtype)  # bias goes into the pass
        hq, hs = act_quantize(h, layer["fc1_b"], gelu=True)
        return w8a8_prequant_matmul(hq, hs, fc2, x.dtype) \
            + layer["fc2_b"].to(x.dtype)
    h = linear_blc(x, layer["fc1_w"], x.dtype) + layer["fc1_b"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return linear_blc(h, fc2, x.dtype) + layer["fc2_b"].to(x.dtype)


def apply_transformer(
    cfg: VARConfig, params: Params, x: torch.Tensor, cond_BD: torch.Tensor,
    attn_bias: Optional[torch.Tensor] = None,
    cache: Union[KVCache, QuantizedKVCache, None] = None,
    cache_begin: int = 0, kv_len: int = 0,
    mods: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the block stack (no dropout, no drop-path: inference only).

    x: (B, L, C) in the compute dtype; cond_BD: (B, D) class embedding;
    attn_bias: optional (Lq, Lk) additive bias; cache: optional KVCache or
    QuantizedKVCache updated in place (new tokens at ``cache_begin``,
    attention over keys [0, kv_len)); mods: optional precomputed
    (depth, B, 6, C) modulations."""
    if mods is None:
        mods = precompute_modulations(cfg, params, cond_BD)
    blocks = params["blocks"]
    h = x
    for li in range(cfg.depth):
        layer = {name: layer_slice(t, li) for name, t in blocks.items()}
        g1, g2, s1, s2, sh1, sh2 = (mods[li][:, None, i].to(h.dtype)
                                    for i in range(6))
        a_in = _ln(h, cfg.norm_eps) * (1.0 + s1) + sh1
        h = h + _attention(cfg, layer, a_in, attn_bias, cache, li,
                           cache_begin, kv_len) * g1
        f_in = _ln(h, cfg.norm_eps) * (1.0 + s2) + sh2
        h = h + _ffn(layer, f_in) * g2
    return h


def get_logits(cfg: VARConfig, params: Params, h: torch.Tensor,
               cond_BD: torch.Tensor) -> torch.Tensor:
    """AdaLN-before-head + classifier, f32 throughout."""
    C = cfg.embed_dim
    hn = params["head_nm"]
    ss = F.silu(cond_BD.float()) @ hn["w"].float() + hn["b"]
    ss = ss.reshape(-1, 1, 2, C)
    scale, shift = ss[:, :, 0, :], ss[:, :, 1, :]
    h32 = _ln(h.float(), cfg.norm_eps) * (scale + 1.0) + shift
    return linear_blc(h32, params["head"]["w"], torch.float32) \
        + params["head"]["b"]


def word_embed(params: Params, x_BLCv: torch.Tensor, dtype) -> torch.Tensor:
    we = params["word_embed"]
    return (x_BLCv.float() @ we["w"].float() + we["b"]).to(dtype)


def lvl_pos_embed(cfg: VARConfig, params: Params) -> torch.Tensor:
    """Level embedding broadcast over each scale's tokens + absolute
    position, (L, C) in the parameter dtype."""
    lvl_1L = np.concatenate(
        [np.full(pn * pn, i) for i, pn in enumerate(cfg.patch_nums)])
    idx = torch.as_tensor(lvl_1L, device=params["lvl_embed"].device)
    return params["lvl_embed"][idx] + params["pos_1LC"]
