"""VAR decoder-only transformer over the flattened scale sequence (the
counterpart of ``sdvar_tpu/models/var.py``): the KV-cached inference
forward and the teacher-forcing training forward ``var_train_forward``.

Parameters are a nested dict of tensors with the JAX package's layout:
per-layer tensors stacked on a leading ``depth`` axis, linear weights as
(in, out), or as INT8 leaves (``ops.quantization.QuantizedLinear`` /
``W8A8Linear``) after ``quantize_var_params``. The block stack is a Python
loop over layers. Casts follow the JAX package: LayerNorm statistics in
f32, AdaLN modulations in f32 cast to the activation dtype, the head
(AdaLN-before-head + classifier) in f32.

Training: ``apply_transformer`` takes the stochastic-depth and proj/FFN
dropout keep masks of ``draw_train_masks`` (the JAX package's rates:
``linspace(0, dpr, depth)``, (B, 1, 1) keep masks divided by
``max(1 - rate, 1e-6)``) and ``remat`` (``torch.utils.checkpoint`` per
block). Randomness comes from an explicit ``torch.Generator``, or the
draws are handed in.

Under a mesh with a model split (``ops.partition.set_tp_mesh``) the tree is
this rank's shard (``parallel.mesh.shard_tree``) and each rank runs its
local heads and local FFN hidden: qkv and fc1 by output column, proj and
fc2 by input row with one all-reduce (sum) each, their biases added once
after it; AdaLN's 6C columns are all-gathered once per generation, and
the head's vocab columns stay split (``get_logits``). Each of the four
widths (heads, FFN hidden, AdaLN 6C, vocab) splits only where it divides
over "model" (``ops.partition.model_split(width)``); one that does not is
held whole on every rank and computed unsplit, with the unsharded layer's
launches and no collective. Values that every
model rank holds (h, the modulations) stay bit-identical across ranks:
they come from collectives that hand every rank the same bits. A
quantized amax over a split axis (the INT8 KV scales, the W8A8
activations of proj and fc2) is all-reduced (max) before the division.

Training under a mesh differentiates through those collectives
(``ops.partition``'s autograd forms, each only where its width splits):
the replicated input of qkv, fc1, the AdaLN projection and the head goes
through ``copy_to_model``, proj and fc2 sum through ``reduce_from_model``,
the 6C modulations and the vocab logits are gathered with
``gather_from_model`` (``var_train_forward`` returns whole rows of
logits). The batch rows split over "data"; the training draws are made for
the whole batch and each rank keeps its rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.ops.attention import (
    attention,
    attention_cache_write,
    use_cache_kernel,
)
from sdvar_tpu_torch.ops.masks import block_causal_prefix, device_bias
from sdvar_tpu_torch.ops.partition import (
    copy_to_model,
    data_count,
    data_rows,
    gather_from_model,
    model_split,
)
from sdvar_tpu_torch.ops.quantization import (
    QuantizedKVCache,
    W8A8Linear,
    layer_slice,
    linear_blc,
    linear_rows,
    local_kv_shape,
    quantize_activation,
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
    Under a mesh ``create`` takes the whole batch and makes this rank's
    part: (depth, B/data, L, C/model).
    """

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: VARConfig, batch: int, dtype=torch.bfloat16,
               device="cuda") -> "KVCache":
        dev = resolve_device(device)
        rows, C = local_kv_shape(cfg, batch)
        shape = (cfg.depth, rows, cfg.L, C)
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
    with shared AdaLN, the (B, 1, 6, C) shared projection (its 6C columns
    all-gathered where they split over "model")."""
    c = F.silu(cond_BD.float())
    if cfg.shared_aln:
        sal, n = params["shared_ada_lin"], 6 * cfg.embed_dim
        g = copy_to_model(c, n) @ sal["w"].float() + sal["b"]
        return gather_from_model(g, n).reshape(-1, 1, 6, cfg.embed_dim)
    return c


def precompute_modulations(cfg: VARConfig, params: Params,
                           cond_BD: torch.Tensor) -> torch.Tensor:
    """All-layer AdaLN modulations (depth, B, 6, C) f32, computed once per
    generation (they depend on the class conditioning only); where 6C
    splits over "model" each rank computes its columns and one all-gather
    joins them."""
    C = cfg.embed_dim
    cond_pre = cond_six(cfg, params, cond_BD)
    blocks = params["blocks"]
    if cfg.shared_aln:
        return cond_pre[None, :, 0] + blocks["ada_gss"][:, :1].float()
    cond_pre = copy_to_model(cond_pre, 6 * C)
    w_all = blocks["ada_lin_w"]  # a dequantised layer at a time when INT8
    # summed in f64 and rounded once to f32, so that a column's bits do not
    # depend on how many columns or rows the call computes: cuBLAS picks
    # its f32 kernel, and with it the summation order, by shape, and a
    # model rank computes only its share of the columns
    c64 = cond_pre.double()
    six = torch.stack([
        (c64 @ resolve_weight(layer_slice(w_all, li), torch.float64)).float() + b
        for li, b in enumerate(blocks["ada_lin_b"])
    ])
    six = gather_from_model(six, 6 * C)
    return six.reshape(cfg.depth, -1, 6, C)


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
    B, L, _ = x.shape
    tp, hd = model_split(cfg.num_heads), cfg.head_dim
    H = cfg.num_heads // tp  # this rank's heads (all of them if unsplit)
    C = H * hd
    if layer["q_bias"].shape[-1] != C:
        raise ValueError(f"q_bias has {layer['q_bias'].shape[-1]} columns, "
                         f"the mesh's model={tp} needs {C}: cut the "
                         f"parameters with parallel.mesh.shard_tree")
    qkv_bias = torch.cat([layer["q_bias"], torch.zeros_like(layer["q_bias"]),
                          layer["v_bias"]]).to(x.dtype)
    x_in = copy_to_model(x, cfg.num_heads)
    qkv = linear_blc(x_in, layer["qkv_w"], x.dtype) + qkv_bias
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
            (k, ks), (v, vs) = _quantize_kv(k, v, B, L, C, tp > 1)
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
                for vals, scales, (nq, ns) in zip(
                        (cache.k, cache.v), (cache.k_s, cache.v_s),
                        _quantize_kv(k, v, B, L, C, tp > 1)):
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
    return linear_rows(out, layer["proj_w"], x.dtype, tp) \
        + layer["proj_b"].to(x.dtype)


def _quantize_kv(k, v, B, L, C, sharded):
    """The new tokens' int8 keys and values with their per-token scales,
    ((kq, ks), (vq, vs)); ``sharded``: this rank holds C of each token's
    merged heads, and one all-reduce (max) of both amax planes gives every
    rank the whole token's scale."""
    if not sharded:
        return tuple(quantize_tokens(t.reshape(B, L, C)) for t in (k, v))
    q, s = quantize_tokens(torch.stack([k.reshape(B, L, C),
                                        v.reshape(B, L, C)]), sharded=True)
    return (q[0], s[0]), (q[1], s[1])


def _ffn(cfg: VARConfig, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """MLP with tanh-GELU. A W8A8 fc2 takes the fused route: fc1, then
    bias + GELU (f32) + per-token int8 quantization in one pass, then the
    exact s8 x s8 -> s32 product. Where the hidden width splits over
    "model", fc1's hidden columns and fc2's rows are this rank's: the
    quantization takes the whole row's scale and fc2 sums its partial
    products over the model ranks."""
    split = model_split(cfg.mlp_hidden)
    fc2, sharded = layer["fc2_w"], split > 1
    if isinstance(fc2, W8A8Linear):
        h = linear_blc(x, layer["fc1_w"], x.dtype)  # bias goes into the pass
        hq, hs = quantize_activation(h, layer["fc1_b"], gelu=True,
                                     sharded=sharded)
        return w8a8_prequant_matmul(hq, hs, fc2, x.dtype, sharded=sharded) \
            + layer["fc2_b"].to(x.dtype)
    h = linear_blc(copy_to_model(x, cfg.mlp_hidden), layer["fc1_w"], x.dtype) \
        + layer["fc1_b"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return linear_rows(h, fc2, x.dtype, split) + layer["fc2_b"].to(x.dtype)


def apply_transformer(
    cfg: VARConfig, params: Params, x: torch.Tensor, cond_BD: torch.Tensor,
    attn_bias: Optional[torch.Tensor] = None,
    cache: Union[KVCache, QuantizedKVCache, None] = None,
    cache_begin: int = 0, kv_len: int = 0,
    mods: Optional[torch.Tensor] = None,
    masks: Optional[Dict[str, torch.Tensor]] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Run the block stack.

    x: (B, L, C) in the compute dtype; cond_BD: (B, D) class embedding;
    attn_bias: optional (Lq, Lk) additive bias; cache: optional KVCache or
    QuantizedKVCache updated in place (new tokens at ``cache_begin``,
    attention over keys [0, kv_len)); mods: optional precomputed
    (depth, B, 6, C) modulations. ``masks``: the training draws of
    ``draw_train_masks`` (stochastic depth and proj/FFN dropout; None:
    neither). ``remat``: recompute each block in the backward
    (``torch.utils.checkpoint``), without a cache."""
    if mods is None:
        mods = precompute_modulations(cfg, params, cond_BD)
    if remat and cache is not None:
        raise ValueError("remat recomputes blocks without a KV cache")
    masks = masks or {}
    path_keep, drop_keep = masks.get("path_keep"), masks.get("drop_keep")
    # the division of a kept branch, max(1 - rate, 1e-6), in f32
    divs = (np.maximum(np.float32(1.0) - drop_path_rates(cfg), np.float32(1e-6))
            if path_keep is not None else None)
    blocks = params["blocks"]
    h = x
    for li in range(cfg.depth):
        layer = {name: layer_slice(t, li) for name, t in blocks.items()}
        args = (mods[li], attn_bias,
                None if path_keep is None else path_keep[li],
                None if drop_keep is None else drop_keep[li],
                None if divs is None else float(divs[li]))
        if remat:
            h = checkpoint(_block, cfg, layer, h, *args, cache, li,
                           cache_begin, kv_len, use_reentrant=False)
        else:
            h = _block(cfg, layer, h, *args, cache, li, cache_begin, kv_len)
    return h


def _block(cfg: VARConfig, layer: Dict, h: torch.Tensor, mod: torch.Tensor,
           attn_bias, path_keep, drop_keep, div, cache, li: int,
           cache_begin: int, kv_len: int) -> torch.Tensor:
    """One pre-norm AdaLN block: attention, then the FFN, each branch
    through dropout (``drop_keep`` (2, B, L, C)), its gamma and stochastic
    depth (``path_keep`` (2, B), a kept branch divided by ``div``), in the
    JAX package's order."""
    g1, g2, s1, s2, sh1, sh2 = (mod[:, None, i].to(h.dtype) for i in range(6))
    a_in = _ln(h, cfg.norm_eps) * (1.0 + s1) + sh1
    a_out = _attention(cfg, layer, a_in, attn_bias, cache, li, cache_begin,
                       kv_len)
    h = h + _branch(cfg, a_out, g1, path_keep, drop_keep, div, 0)
    f_in = _ln(h, cfg.norm_eps) * (1.0 + s2) + sh2
    f_out = _ffn(cfg, layer, f_in)
    return h + _branch(cfg, f_out, g2, path_keep, drop_keep, div, 1)


def _branch(cfg: VARConfig, t: torch.Tensor, gamma: torch.Tensor, path_keep,
            drop_keep, div, j: int) -> torch.Tensor:
    """A branch's output into the residual: dropout (kept / (1 - rate)),
    times gamma, then stochastic depth (kept / ``div``)."""
    if drop_keep is not None:
        t = t * drop_keep[j].to(t.dtype) / torch.tensor(
            1.0 - cfg.drop_rate, dtype=torch.float64).to(t.dtype)
    t = t * gamma
    if path_keep is not None:
        keep = path_keep[j].to(t.dtype)[:, None, None]
        t = t * keep / torch.tensor(div, dtype=torch.float32).to(t.dtype)
    return t


def drop_path_rates(cfg: VARConfig) -> np.ndarray:
    """Per-layer stochastic-depth rates, ``linspace(0, dpr, depth)`` in
    f32."""
    return np.linspace(0.0, cfg.dpr, cfg.depth).astype(np.float32)


def draw_train_masks(cfg: VARConfig, B: int, L: int, generator: torch.Generator,
                     device) -> Dict[str, torch.Tensor]:
    """One training forward's random draws, from ``generator`` on
    ``device``: ``cond_drop`` (B,) bool, the rows whose label becomes the
    unconditional class (rate ``cond_drop_rate``); ``path_keep``
    (depth, 2, B) bool, stochastic depth of the attention and FFN branches
    at ``drop_path_rates`` (when dpr > 0); ``drop_keep``
    (depth, 2, B, L, C) bool, proj/FFN dropout (when ``drop_rate`` > 0).
    Absent entries are not applied."""
    out = {}
    if cfg.cond_drop_rate > 0:
        out["cond_drop"] = torch.rand((B,), generator=generator,
                                      device=device) < cfg.cond_drop_rate
    if cfg.dpr > 0:
        keep = torch.from_numpy(1.0 - drop_path_rates(cfg)).to(device)
        u = torch.rand((cfg.depth, 2, B), generator=generator, device=device)
        out["path_keep"] = u < keep[:, None, None]
    if cfg.drop_rate > 0:
        u = torch.rand((cfg.depth, 2, B, L, cfg.embed_dim),
                       generator=generator, device=device)
        out["drop_keep"] = u < 1.0 - cfg.drop_rate
    return out


def get_logits(cfg: VARConfig, params: Params, h: torch.Tensor,
               cond_BD: torch.Tensor) -> torch.Tensor:
    """AdaLN-before-head + classifier, f32 throughout. Where the vocab
    splits over "model" the logits are this rank's vocab columns: the
    sampler gathers them (``ops.partition.sharded_fused_sample``), as does
    an argmax over the vocab (``ops.partition.gather_vocab``)."""
    C = cfg.embed_dim
    hn = params["head_nm"]
    ss = F.silu(cond_BD.float()) @ hn["w"].float() + hn["b"]
    ss = ss.reshape(-1, 1, 2, C)
    scale, shift = ss[:, :, 0, :], ss[:, :, 1, :]
    h32 = _ln(h.float(), cfg.norm_eps) * (scale + 1.0) + shift
    h32 = copy_to_model(h32, cfg.vocab_size)
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


def var_train_forward(
    cfg: VARConfig, params: Params, label_B: torch.Tensor,
    x_BLCv_wo_first_l: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    masks: Optional[Dict[str, torch.Tensor]] = None,
    attn_bias: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    prog_si: int = -1,
    remat: bool = False,
) -> torch.Tensor:
    """Teacher-forcing forward -> logits (B, L', V) f32.

    ``x_BLCv_wo_first_l``: (B, L - first_l, Cvae) inputs of the scales
    after the first (``models.quantizer.idx_to_var_input``). Training
    randomness (cond-embedding dropout, stochastic depth, proj/FFN
    dropout) is drawn from ``generator`` (``draw_train_masks``), or given
    as ``masks``; with neither the forward is deterministic. ``attn_bias``
    defaults to the block-causal mask. ``prog_si`` >= 0: progressive
    training, the sequence and the mask cut at ``begin_ends[prog_si][1]``.
    """
    B = x_BLCv_wo_first_l.shape[0]
    dev = x_BLCv_wo_first_l.device
    ed = cfg.L if prog_si < 0 else cfg.begin_ends[prog_si][1]
    if masks is None and generator is not None:
        masks = _local_draws(cfg, B, ed, generator, dev)
    masks = masks or {}
    label_B = torch.as_tensor(label_B, device=dev).long()
    if "cond_drop" in masks:
        label_B = torch.where(masks["cond_drop"], cfg.num_classes, label_B)

    sos = params["class_emb"][label_B]  # (B, C)
    x = sos[:, None, :] + params["pos_start"][None]  # (B, first_l, C)
    if ed > cfg.first_l:
        we = word_embed(params, x_BLCv_wo_first_l[:, : ed - cfg.first_l],
                        torch.float32)
        x = torch.cat([x.float(), we], dim=1)
    x = (x + lvl_pos_embed(cfg, params)[None, :ed]).to(dtype)
    if attn_bias is None:
        attn_bias = device_bias(dev, block_causal_prefix,
                                tuple(cfg.patch_nums), ed)
    h = apply_transformer(cfg, params, x, sos, attn_bias=attn_bias,
                          masks=masks, remat=remat)
    return gather_from_model(get_logits(cfg, params, h, sos), cfg.vocab_size)


def _local_draws(cfg: VARConfig, B: int, L: int, generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """``draw_train_masks`` for this rank's B rows: under a data split the
    draws of the whole batch (B x data rows, the same generator state on
    every rank), then this rank's rows of them, so a mesh run sees the
    single-device run's draws."""
    n = data_count()
    masks = draw_train_masks(cfg, B * n, L, generator, device)
    if n == 1:
        return masks
    rows = data_rows(B * n)
    return {k: (v[rows] if k == "cond_drop" else v[:, :, rows])
            for k, v in masks.items()}


def count_params(params: Params) -> int:
    """The number of elements of a tree's leaves (a quantized leaf counts
    its values and its scales, as the JAX package's tree leaves do)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()
