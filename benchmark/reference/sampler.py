"""The sampling rule the port documents for its decode, written out again:
top-k (ties at the k-th value kept), then the nucleus over the kept
logits (the smallest set of the largest, ties kept, whose softmax mass
reaches top_p; the largest always), then Gumbel-max with noise from the
murmur3 finalizer of (row seed, column). Row seeds fold the scale and the
position into each request's seed.

Because the noise is a function of the seed, sampling is a deterministic
choice from given logits: the token with the largest perturbed logit in
the admissible set. A served token is judged against the logits it was
drawn from by its gap: how far its perturbed logit lies below the best
admissible one (0 when the rule picks the same token). The nucleus masses
are summed in float64, so a row's admissible set does not hang on the
order of an f32 sum."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def row_seeds(req: torch.Tensor, si: int, l: int) -> torch.Tensor:
    """(n,) request seeds in [0, 2^32) -> (n, l) row seeds of scale si."""
    s = fmix32(req & MASK32 ^ (((si + 1) * GOLDEN) & MASK32))
    pos = _mul32(torch.arange(l, dtype=torch.int64, device=req.device), GOLDEN)
    return s[:, None] ^ pos[None, :]


def gumbel(rows: torch.Tensor, V: int) -> torch.Tensor:
    """(...,) row seeds -> (..., V) f32 Gumbel noise: 24 bits of
    fmix32(seed + col * golden) -> u in (0, 1) -> -log(-log u)."""
    col = _mul32(torch.arange(V, dtype=torch.int64, device=rows.device), GOLDEN)
    bits = fmix32((rows[..., None] + col) & MASK32)
    u = ((bits >> 8) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    return -torch.log(-torch.log(u))


def admissible(x: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Bool mask (..., V) of the tokens the rule may choose from logits x."""
    V = x.shape[-1]
    keep = torch.ones_like(x, dtype=torch.bool)
    if 0 < top_k < V:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        keep = x >= kth
    if 0.0 < top_p < 1.0:
        m = torch.where(keep, x, -torch.inf)
        srt = torch.sort(m, dim=-1, descending=True).values
        prob = torch.softmax(srt.double(), dim=-1)   # -inf columns weigh 0
        cum = prob.cumsum(-1)
        j = (cum < top_p).sum(-1, keepdim=True).clamp(max=V - 1)
        keep = keep & (x >= srt.gather(-1, j))
    return keep


def gaps(x: torch.Tensor, chosen: torch.Tensor, noise: torch.Tensor,
         top_k: int, top_p: float) -> torch.Tensor:
    """Per token: the best admissible perturbed logit of ``x`` minus the
    perturbed logit of ``chosen`` (0 where the rule picks ``chosen``; an
    inadmissible choice also counts from its perturbed logit)."""
    score = x + noise
    best = torch.where(admissible(x, top_k, top_p), score, -torch.inf) \
        .amax(-1)
    return best - score.gather(-1, chosen.long()[..., None])[..., 0]
