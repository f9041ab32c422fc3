"""VAR's training step from stored token ids, plain and float32: the step
of ``train.py`` with the tokenizer left out, as the port's
``train_step(..., pretokenized=True)`` leaves it out. The ids are the
ground truth, and the teacher-forcing inputs are rebuilt from them by the
quantizer (``quantizer.fhat_from_ids``); the draws, the loss, its
gradients and AdamW are ``train.py``'s (``B1`` and ``adamw`` are its own,
named here so that this module serves where ``train.py`` does)."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import quantizer as RQ
from benchmark.reference import var as RV
from benchmark.reference.precision import EXACT, Precision
from benchmark.reference.train import B1, MICRO, adamw, draws, drop_rates, leaves

__all__ = ["B1", "adamw", "inputs_from_ids", "loss_and_grads"]


@torch.no_grad()
def inputs_from_ids(model: Dict, vae: Dict, ids: torch.Tensor
                    ) -> List[torch.Tensor]:
    """(B, L) ids -> the inputs of scales 1.. (each (B, pn^2, Cvae))."""
    q, pns = model["vqvae"], model["var"]["patch_nums"]
    per_scale, bg = [], 0
    for pn in pns:
        per_scale.append(ids[:, bg:bg + pn * pn].long())
        bg += pn * pn
    with EXACT.f32_math():
        _, inputs = RQ.fhat_from_ids(q, vae["quant"], pns, per_scale)
    return inputs


def loss_and_grads(model: Dict, params: Dict, vae: Dict, ids: torch.Tensor,
                   labels: torch.Tensor, gen: torch.Generator, smooth: float,
                   prec: Precision = EXACT):
    """(loss, {path: gradient}) of one step on one batch of (B, L) ids;
    ``params`` are float32 leaves that require gradients."""
    var = model["var"]
    B = ids.shape[0]
    gt, inputs = ids.long(), inputs_from_ids(model, vae, ids)
    cond, path_keep = draws(var, B, gen, ids.device)
    labels = torch.where(cond, var["num_classes"], labels)
    named = leaves(params)
    total, grads = 0.0, None
    with EXACT.f32_math():
        for r0 in range(0, B, MICRO):
            sl = slice(r0, r0 + MICRO)
            logits = RV.forward(var, params, labels[sl], [x[sl] for x in inputs],
                                prec, path_keep[:, :, sl], drop_rates(var))
            logp = F.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, gt[sl][..., None])[..., 0]
            ce = (1 - smooth) * nll + smooth * (-logp.mean(-1))
            loss = ce.mean(-1).sum() / B
            g = torch.autograd.grad(loss, [t for _, t in named])
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(loss.detach())
    return total, {p: g for (p, _), g in zip(named, grads)}
