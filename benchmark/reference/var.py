"""The VAR transformer (FoundationVision/VAR ``models/var.py``,
``models/basic_var.py``), plain and float32: the teacher-forced forward
over all L tokens of every scale under the block-causal mask, which is
what the KV-cached decode computes scale by scale. Weights are read in the
port's layout (the benchmark made them so): per-layer leaves stacked on a
leading depth axis, linear weights (in, out).

Block: AdaLN (six modulations from silu(class embedding)), attention with
per-head L2-normalised q and k (q scaled by exp(min(scale_mul, log 100)),
softmax scale 1), tanh-GELU MLP; each branch times its gamma, and in
training stochastic depth (a dropped branch adds nothing, a kept one is
divided by 1 - rate). Head: AdaLN-before-head, then the classifier.
A bf16 configuration runs the blocks in bfloat16 (the residual stream,
the GEMMs and the attention) and the word embedding, the AdaLN projections
and the head in float32, so its control lowers only the former; a W8A8
one with an INT8 KV cache quantizes the blocks' GEMM operands, the keys
and values and the head's weights, which its control lowers to int4."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import EXACT, Precision


def scale_ids(patch_nums: Sequence[int], device) -> torch.Tensor:
    return torch.cat([torch.full((pn * pn,), i, device=device)
                      for i, pn in enumerate(patch_nums)])


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def _lin(x, w, b, prec: Precision):
    y = prec.lower(x) @ prec.lower(w.float(), dim=-2)
    return y if b is None else y + b.float()


def forward(var: Dict, p: Dict, labels: torch.Tensor,
            inputs: List[torch.Tensor], prec: Precision = EXACT,
            path_keep: Optional[torch.Tensor] = None,
            drop_rates: Optional[np.ndarray] = None) -> torch.Tensor:
    """Logits (rows, L, V) f32 for class ``labels`` (rows,) (the
    unconditional class is ``num_classes``) and the inputs of scales 1..
    (each (rows, pn^2, Cvae)). ``path_keep`` (depth, 2, rows) bool with
    ``drop_rates`` (depth,): training's stochastic depth."""
    C, H, depth = var["embed_dim"], var["num_heads"], var["depth"]
    hd, eps = var["head_dim"], var["norm_eps"]
    pns = var["patch_nums"]
    dev = labels.device
    rows = labels.shape[0]
    sid = scale_ids(pns, dev)
    L = sid.shape[0]
    sos = p["class_emb"].float()[labels]                       # (rows, C)
    lvl_pos = p["lvl_embed"].float()[sid] + p["pos_1LC"].float()
    first = sos[:, None] + p["pos_start"].float()[None]
    we = p["word_embed"]
    rest = _lin(torch.cat(inputs, 1).float(), we["w"], we["b"], EXACT) \
        if inputs else first[:, :0]
    x = torch.cat([first, rest], 1) + lvl_pos[None]
    mask = torch.where(sid[:, None] >= sid[None, :], 0.0, -math.inf)
    c = F.silu(sos)
    blk = p["blocks"]
    h = prec.stream(x)
    for li in range(depth):
        mod = (_lin(c, blk["ada_lin_w"][li], blk["ada_lin_b"][li], EXACT)
               .reshape(rows, 6, C))
        g1, g2, s1, s2, sh1, sh2 = (mod[:, None, i] for i in range(6))
        a = _ln(h, eps) * (1 + s1) + sh1
        qkv = _lin(a, blk["qkv_w"][li], None, prec)
        q, k, v = qkv.reshape(rows, L, 3, H, hd).unbind(2)
        q = q + blk["q_bias"][li].float().reshape(H, hd)
        v = v + blk["v_bias"][li].float().reshape(H, hd)
        smul = torch.exp(blk["scale_mul"][li].float().clamp(max=math.log(100.0)))
        q = F.normalize(q, dim=-1, eps=1e-12) * smul[:, None]
        k = F.normalize(k, dim=-1, eps=1e-12)
        if prec.int4:   # the cache holds a token's keys and values on one scale
            k = prec.lower(k.reshape(rows, L, C)).reshape(rows, L, H, hd)
            v = prec.lower(v.reshape(rows, L, C)).reshape(rows, L, H, hd)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (rows, H, L, hd)
        if prec.fp8:
            q, k, v = prec.lower(q), prec.lower(k), prec.lower(v)
        att = torch.softmax(q @ k.transpose(-1, -2) + mask, dim=-1)
        o = (prec.lower(att) if prec.fp8 else att) @ v
        o = o.transpose(1, 2).reshape(rows, L, C)
        o = _lin(o, blk["proj_w"][li], blk["proj_b"][li], prec)
        h = prec.stream(h + _branch(o * g1, path_keep, drop_rates, li, 0))
        f = _ln(h, eps) * (1 + s2) + sh2
        f = F.gelu(_lin(f, blk["fc1_w"][li], blk["fc1_b"][li], prec),
                   approximate="tanh")
        f = _lin(f, blk["fc2_w"][li], blk["fc2_b"][li], prec)
        h = prec.stream(h + _branch(f * g2, path_keep, drop_rates, li, 1))
    hn = p["head_nm"]
    ss = (c @ hn["w"].float() + hn["b"].float()).reshape(rows, 1, 2, C)
    h = _ln(h, eps) * (ss[:, :, 0] + 1) + ss[:, :, 1]
    w = p["head"]["w"].float()
    if prec.int4:   # the configuration's head keeps int8 weights
        w = prec.lower(w, dim=-2)
    return h @ w + p["head"]["b"].float()


def _branch(t, path_keep, rates, li: int, j: int):
    if path_keep is None:
        return t
    keep = path_keep[li, j].float()[:, None, None]
    return t * keep / max(1.0 - float(rates[li]), 1e-6)


def cfg_mixed(var: Dict, logits: torch.Tensor, cfg: float) -> List[torch.Tensor]:
    """Rows [cond ‖ uncond] -> per scale (n, pn^2, V):
    (1 + t) cond - t uncond with t = cfg * si / (S - 1)."""
    n = logits.shape[0] // 2
    out, bg = [], 0
    S = len(var["patch_nums"])
    for si, pn in enumerate(var["patch_nums"]):
        t = cfg * si / (S - 1)
        lg = logits[:, bg:bg + pn * pn]
        out.append((1 + t) * lg[:n] - t * lg[n:])
        bg += pn * pn
    return out
