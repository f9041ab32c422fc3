"""VAR's training step (FoundationVision/VAR ``trainer.py``, the JAX
package's recipe), plain and float32: the frozen VQVAE tokenizes the
images (encoder, then the residual quantizer), the teacher-forced forward
with the step's draws (class dropout to the unconditional class,
stochastic depth), cross entropy with label smoothing weighted 1/L a
token and averaged over the batch, its gradients by autograd, clipping by
the global norm (unchanged below the limit, else scaled to it), then
AdamW (b1 0.9, b2 0.95, eps 1e-8, bias-corrected; decoupled weight decay
p -= lr (u + wd p) on the decayed leaves).

The step's draws are made again from a generator seeded as the one handed
to the port, in the order the port documents for its training forward:
``cond_drop`` (B,) uniforms below the class-dropout rate, then
``path_keep`` (depth, 2, B) uniforms below 1 - linspace(0, dpr, depth).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import quantizer as RQ
from benchmark.reference import var as RV
from benchmark.reference import vqvae as RD
from benchmark.reference.precision import EXACT, Precision

NOWD_KEYS = ("cls_token", "start_token", "task_token", "cfg_uncond",
             "pos_embed", "pos_1LC", "pos_start", "start_pos", "lvl_embed",
             "gamma", "beta", "ada_gss", "moe_bias", "scale_mul")
B1, B2, EPS = 0.9, 0.95, 1e-8
MICRO = 8  # rows a forward and backward takes


def leaves(tree: Dict, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        out += leaves(v, p) if isinstance(v, dict) else [(p, v)]
    return out


def decays(path: str, t: torch.Tensor) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    if t.dim() <= 1 or leaf == "b" or "bias" in path or leaf.endswith("_b"):
        return False
    return not any(k in path for k in NOWD_KEYS)


def drop_rates(var: Dict) -> np.ndarray:
    return np.linspace(0.0, var["drop_path_rate"], var["depth"]).astype(np.float32)


def draws(var: Dict, B: int, gen: torch.Generator, device):
    cond = torch.rand((B,), generator=gen, device=device) < var["cond_drop_rate"]
    keep = torch.from_numpy(1.0 - drop_rates(var)).to(device)
    u = torch.rand((var["depth"], 2, B), generator=gen, device=device)
    return cond, u < keep[:, None, None]


@torch.no_grad()
def tokenize(model: Dict, vae: Dict, img: torch.Tensor):
    """Images -> (gt ids (B, L), the inputs of scales 1.. )."""
    q, pns = model["vqvae"], model["var"]["patch_nums"]
    with EXACT.f32_math():
        ids = RQ.encode(q, vae["quant"], pns, RD.encode(q, vae, img))
        _, inputs = RQ.fhat_from_ids(q, vae["quant"], pns, ids)
    return torch.cat(ids, 1), inputs


def loss_and_grads(model: Dict, params: Dict, vae: Dict, img: torch.Tensor,
                   labels: torch.Tensor, gen: torch.Generator, smooth: float,
                   prec: Precision = EXACT):
    """(loss, {path: gradient}) of one step on one batch; ``params`` are
    float32 leaves that require gradients."""
    var = model["var"]
    B = img.shape[0]
    gt, inputs = tokenize(model, vae, img)
    cond, path_keep = draws(var, B, gen, img.device)
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


@torch.no_grad()
def adamw(params: Dict, grads: Dict[str, torch.Tensor], state: Dict, lr: float,
          wd: float, clip: float) -> Dict[str, torch.Tensor]:
    """Clip by the global norm, then one AdamW update in place. Returns
    the gradients as the optimizer took them (after the clip)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if clip > 0 and float(norm) >= clip:
        grads = {p: g * (clip / norm.float()) for p, g in grads.items()}
    state["count"] = state.get("count", 0) + 1
    k = state["count"]
    for path, p in leaves(params):
        g = grads[path]
        m = state.setdefault(("mu", path), torch.zeros_like(p))
        v = state.setdefault(("nu", path), torch.zeros_like(p))
        m.mul_(B1).add_((1 - B1) * g)
        v.mul_(B2).add_((1 - B2) * g * g)
        u = (m / (1 - B1 ** k)) / (torch.sqrt(v / (1 - B2 ** k)) + EPS)
        p.sub_(lr * (u + (wd * p if decays(path, p) else 0.0)))
    return grads
