"""VAR's multi-scale residual quantizer (FoundationVision/VAR
``models/quant.py``), plain: the phi refinement, f_hat rebuilt from the
per-scale ids with each next scale's input, and the residual encode of a
latent. Resizes are ``torch.nn.functional``'s own (bicubic with
``align_corners=False``; area = adaptive average pooling)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def phi_index(q: Dict, si: int, num_scales: int) -> int:
    """Which shared phi scale ``si`` uses: ticks linspace(1/3/K, 1-1/3/K, K)
    for K = 4 (else 1/2/K), the nearest to si/(S-1), float64."""
    K = q["share_quant_resi"]
    if K == 1:
        return 0
    edge = 1 / 3 / K if K == 4 else 1 / 2 / K
    ticks = np.linspace(edge, 1 - edge, K)
    return int(np.argmin(np.abs(ticks - si / (num_scales - 1))))


def phi(q: Dict, qp: Dict, si: int, num_scales: int, h: torch.Tensor
        ) -> torch.Tensor:
    r = q["quant_resi"]
    k = phi_index(q, si, num_scales)
    y = F.conv2d(h, qp["phi_w"][k].float(), qp["phi_b"][k].float(), padding=1)
    return h * (1 - r) + y * r


def bicubic(x: torch.Tensor, hw: int) -> torch.Tensor:
    if x.shape[-1] == hw:
        return x
    return F.interpolate(x, size=(hw, hw), mode="bicubic", align_corners=False)


def area(x: torch.Tensor, hw: int) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, (hw, hw))


def fhat_from_ids(q: Dict, qp: Dict, patch_nums: Sequence[int],
                  ids: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Per-scale ids (n, pn^2) -> (f_hat (n, Cvae, HW, HW), the inputs of
    scales 1.. as (n, pn^2, Cvae) token rows)."""
    S, HW = len(patch_nums), patch_nums[-1]
    cb = qp["codebook"].float()
    n, Cv = ids[0].shape[0], cb.shape[1]
    f_hat = torch.zeros((n, Cv, HW, HW), device=cb.device)
    inputs = []
    for si, pn in enumerate(patch_nums):
        h = cb[ids[si].long()].reshape(n, pn, pn, Cv).permute(0, 3, 1, 2)
        f_hat = f_hat + phi(q, qp, si, S, bicubic(h, HW))
        if si < S - 1:
            nxt = patch_nums[si + 1]
            inputs.append(area(f_hat, nxt).reshape(n, Cv, nxt * nxt)
                          .transpose(1, 2))
    return f_hat, inputs


def encode(q: Dict, qp: Dict, patch_nums: Sequence[int], f: torch.Tensor
           ) -> List[torch.Tensor]:
    """Residual-pyramid encode of a latent f (n, Cvae, HW, HW): per scale
    the residual area-resized to (pn, pn), its nearest codebook entries
    (squared distance, first index on a tie), their embedding refined and
    added to f_hat and taken off the residual. Returns (n, pn^2) ids."""
    S, HW = len(patch_nums), patch_nums[-1]
    cb = qp["codebook"].float()
    n, Cv = f.shape[0], f.shape[1]
    rest, out = f.float(), []
    for si, pn in enumerate(patch_nums):
        z = area(rest, pn).permute(0, 2, 3, 1).reshape(-1, Cv)
        d = (z * z).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None] \
            - 2.0 * z @ cb.t()
        idx = d.argmin(-1)
        h = cb[idx].reshape(n, pn, pn, Cv).permute(0, 3, 1, 2)
        h = phi(q, qp, si, S, bicubic(h, HW))
        rest = rest - h
        out.append(idx.reshape(n, pn * pn))
    return out
