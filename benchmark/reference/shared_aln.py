"""Shared AdaLN (FoundationVision/VAR ``models/basic_var.py``
``AdaLNSelfAttn`` with ``shared_aln=True``, the ``--saln=1`` models): one
projection ``shared_ada_lin`` for the whole stack, and each block's six
modulations are that projection plus the block's own ``ada_gss``:

    mods_l = shared_ada_lin(silu(c)) + ada_gss[l]
           = silu(c) @ W + (b + ada_gss[l])

which is the per-layer AdaLN of ``var.forward`` with ``ada_lin_w[l] = W``
for every layer (a broadcast view of the one weight, no copy) and
``ada_lin_b[l] = b + ada_gss[l]``. So the forward is ``var.forward`` on
that view of the tree; its one departure from the published block is the
order of an f32 sum (the bias and ``ada_gss`` are added before the
product's result, not after). Weights in the port's layout:
``shared_ada_lin`` {"w": (C, 6C), "b": (6C,)}, ``blocks.ada_gss`` (depth,
1, 6, C)."""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import var as RV
from benchmark.reference.precision import EXACT, Precision


def per_layer_view(var: Dict, p: Dict) -> Dict:
    """The tree with shared AdaLN written as per-layer AdaLN (the identity
    above), the other leaves as they are; a tree without shared AdaLN is
    returned unchanged."""
    if "shared_ada_lin" not in p:
        return p
    depth, C = var["depth"], var["embed_dim"]
    sal = p["shared_ada_lin"]
    blocks = {k: v for k, v in p["blocks"].items() if k != "ada_gss"}
    blocks["ada_lin_w"] = sal["w"].float().expand(depth, C, 6 * C)
    blocks["ada_lin_b"] = sal["b"].float() \
        + p["blocks"]["ada_gss"].float().reshape(depth, 6 * C)
    out = {k: v for k, v in p.items() if k != "shared_ada_lin"}
    out["blocks"] = blocks
    return out


def forward(var: Dict, p: Dict, labels: torch.Tensor,
            inputs: List[torch.Tensor], prec: Precision = EXACT
            ) -> torch.Tensor:
    """``var.forward`` of a shared-AdaLN (or per-layer) tree."""
    return RV.forward(var, per_layer_view(var, p), labels, inputs, prec)
