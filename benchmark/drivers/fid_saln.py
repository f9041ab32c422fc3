"""Driver ``fid_saln``: the ``fid`` driver (``drivers/fid.py``: its window
over ``sample_fid.sample_batches``, its traced window and its check, taken
by import) for a VAR with shared AdaLN (VAR's ``--saln=1`` models).

Two things differ. The weights are drawn in the port's shared-AdaLN
layout (``var_params``), which the ``fid`` driver's per-layer draw cannot
feed. The check judges the delivered images against the plain reference
of ``reference/shared_aln.py`` with ``pixel="mae"``, the number of a
decoder that runs in bfloat16 (``gencheck``): ``logit_err``,
``sample_gap`` and ``pixel_mae``.
"""

from __future__ import annotations

import math
import types
from typing import Dict

import torch

from benchmark.harness import cells, gencheck, weights
from benchmark.reference import shared_aln as RSA

METRIC = "img_per_s"  # the end-to-end metric of its window, beside setup_s


def var_params(var: Dict, seed: int, device, dtype) -> Dict:
    """``weights.var_params``'s tree (every leaf drawn as it draws it) with
    its per-layer AdaLN replaced by the shared layout, drawn from a stream
    of its own: ``shared_ada_lin`` w (C, 6C) at the trunk's std and b (6C)
    whose gammas are of order 0.5 (std 0.5, the other modulations 0.1), as
    ``weights.var_params`` draws the per-layer biases, so that every block
    takes part; ``blocks.ada_gss`` (depth, 1, 6, C) at VAR's own
    initialiser, std 1/sqrt(C)."""
    p = weights.var_params(var, seed, device, dtype)
    del p["blocks"]["ada_lin_w"], p["blocks"]["ada_lin_b"]
    g = weights.generator(seed, 5, device)
    C, depth = var["embed_dim"], var["depth"]

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(std)

    b = normal((6 * C,), 1.0)
    b[: 2 * C] *= 0.5   # gammas
    b[2 * C:] *= 0.1    # scales and shifts
    p["shared_ada_lin"] = {"w": normal((C, 6 * C), math.sqrt(1.0 / (3 * C))),
                           "b": b}
    p["blocks"]["ada_gss"] = normal((depth, 1, 6, C), 1.0 / math.sqrt(C))
    return p


# this module's own copy of the fid driver (``cells.driver`` loads the file
# anew), whose weights are drawn by ``var_params`` above
_fid = cells.driver("fid")
_fid.weights = types.SimpleNamespace(var_params=var_params,
                                     vqvae_params=weights.vqvae_params)


class Run(_fid.Run):
    def readings(self, control: bool = False) -> Dict[str, float]:
        idx, ids, logits, imgs = self._sample()
        return gencheck.judge(
            self.model, self.model["sampling"],
            RSA.per_layer_view(self.model["var"], self.var_params),
            self.vae_params, [int(self.labels[i]) for i in idx],
            [self.seed0 + i for i in idx], ids, logits, imgs, self.dev,
            control=control, pixel="mae",
            var_control=gencheck.var_control(self.tr))

    def check(self):
        self.release()
        got = self.readings()
        lim = self.cell["limits"]
        return [(k, got[k], lim[k]) for k in ("logit_err", "sample_gap",
                                             "pixel_mae")]


def setup(cell: Dict, seed: int, device) -> Run:
    return Run(cell, seed, device)
