"""The correctness check of a generation cell, shared by its drivers.

For each sampled image the reference rebuilds f_hat and every scale's
input from the served ids, runs the teacher-forced transformer over the
image's prompt (its class, and the unconditional row) and served tokens,
CFG-mixes the logits and decodes the pixels. Three numbers:

- ``logit_err``: the largest difference between the CFG-mixed logits the
  decode sampled from and the reference's, over every scale, position and
  vocabulary entry (logits have a standard deviation of about 2);
- ``sample_gap``: the widest gap of a served token below the sampling
  rule's pick from the logits it was drawn from (``reference/sampler.py``):
  0 for a sound sampler;
- ``pixel_err``: the largest difference of a delivered pixel from the
  reference's decode of the same ids, in [0, 1] units; or, for a decoder
  the cell runs in bfloat16 (``pixel="mae"``), ``pixel_mae``: the worst
  image's mean absolute difference (a bf16 decoder's largest pixel error
  is a tail of a few pixels).

``control=True`` reads ``logit_err`` and the pixel number of the control
in the program's place: the reference's logits in the precision below the
cell's (``var_control``: e4m3 below bf16, int4 below W8A8 + INT8 KV), and
its pixels decoded in the precision below the decoder's from the same
f_hat."""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import quantizer as RQ
from benchmark.reference import sampler as RS
from benchmark.reference import var as RV
from benchmark.reference import vqvae as RD
from benchmark.reference.precision import (CONTROL_BF16, CONTROL_F32,
                                           CONTROL_INT8, EXACT)

BLOCK = 4  # images a reference pass takes


def var_control(traffic: Dict):
    """The control below the cell's transformer precision."""
    return CONTROL_INT8 if traffic.get("quant", "none") != "none" \
        or traffic.get("kv") == "int8" else CONTROL_BF16


class Recorder:
    """Holds each sampler call's ids, and the logits of ``keep`` batches
    drawn from the stream by reservoir sampling (seeded), while ``on``.
    The decode calls the sampler once a scale, in scale order, batch after
    batch, from one thread."""

    def __init__(self, decode_module, scales: int, keep: int, seed: int):
        self.mod, self.scales, self.keep = decode_module, scales, keep
        self.orig = decode_module.sample_with_top_k_top_p
        self.rng = random.Random(seed)
        self.ids: List[torch.Tensor] = []
        self.logits: Dict[int, List[torch.Tensor]] = {}
        self.first_seeds: List[torch.Tensor] = []  # each batch's scale-0 row seeds
        self.on = False

        def sample(logits, seeds, *a, **k):
            ids = self.orig(logits, seeds, *a, **k)
            if self.on:
                b, si = divmod(len(self.ids), self.scales)
                if si == 0:
                    self._admit(b)
                    self.first_seeds.append(seeds)
                if b in self.logits:
                    self.logits[b].append(logits)
                self.ids.append(ids)
            return ids

        decode_module.sample_with_top_k_top_p = sample

    def _admit(self, b: int) -> None:
        if len(self.logits) < self.keep:
            self.logits[b] = []
            return
        j = self.rng.randrange(b + 1)
        if j < self.keep:
            del self.logits[sorted(self.logits)[j]]
            self.logits[b] = []

    def batch_ids(self, b: int) -> List[torch.Tensor]:
        return self.ids[b * self.scales:(b + 1) * self.scales]

    def restore(self) -> None:
        self.mod.sample_with_top_k_top_p = self.orig


@torch.no_grad()
def judge(model: Dict, samp: Dict, var_params: Dict, vae_params: Dict,
          labels: Sequence[int], req_seeds: Sequence[int],
          ids: List[torch.Tensor], logits: List[torch.Tensor],
          images: np.ndarray, device, control: bool = False,
          pixel: str = "max", var_control=CONTROL_BF16) -> Dict[str, float]:
    """``ids`` / ``logits``: per scale, the served (n, pn^2) ids and the
    (n, pn^2, V) CFG-mixed logits they were drawn from; ``images``: (n, 3,
    H, W) delivered, f32 in [0, 1] or uint8."""
    var, q = model["var"], model["vqvae"]
    pns, V = var["patch_nums"], var["vocab_size"]
    px = "pixel_err" if pixel == "max" else "pixel_mae"
    out = {"logit_err": 0.0, "sample_gap": 0.0, px: 0.0}

    def worst(k, v):
        out[k] = max(out[k], float(v))

    for b0 in range(0, len(labels), BLOCK):
        sl = slice(b0, b0 + BLOCK)
        lab = torch.tensor(list(labels[sl]), dtype=torch.int64, device=device)
        req = torch.tensor(list(req_seeds[sl]), dtype=torch.int64,
                           device=device) & RS.MASK32
        ids_b = [t[sl].to(device).long() for t in ids]
        with EXACT.f32_math():
            f_hat, inputs = RQ.fhat_from_ids(q, vae_params["quant"], pns, ids_b)
            rows = torch.cat([lab, torch.full_like(lab, var["num_classes"])])
            inputs2 = [torch.cat([x, x]) for x in inputs]
            ref = RV.cfg_mixed(var, RV.forward(var, var_params, rows, inputs2),
                               samp["cfg"])
            if control:
                got = RV.cfg_mixed(var, RV.forward(var, var_params, rows,
                                                   inputs2, var_control),
                                   samp["cfg"])
            else:
                got = [t[sl].to(device).float() for t in logits]
            for si, pn in enumerate(pns):
                worst("logit_err", (got[si] - ref[si]).abs().max())
                if not control:
                    noise = RS.gumbel(RS.row_seeds(req, si, pn * pn), V)
                    worst("sample_gap", RS.gaps(got[si], ids_b[si], noise,
                                                samp["top_k"],
                                                samp["top_p"]).max())
            img_ref = RD.decode(q, vae_params, f_hat)
        if control and pixel == "max":       # an f32 decoder: TF32
            with CONTROL_F32.f32_math():
                img = RD.decode(q, vae_params, f_hat)
        elif control:                        # a bf16 decoder: e4m3
            with EXACT.f32_math():
                img = RD.decode(q, vae_params, f_hat, CONTROL_BF16)
        else:
            img = torch.as_tensor(np.asarray(images[sl]), device=device)
            img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
        err = (img - img_ref).abs()
        worst(px, err.max() if pixel == "max" else err.mean((1, 2, 3)).max())
        del ref, got
    if control:
        del out["sample_gap"]
    return out
