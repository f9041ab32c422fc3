"""Numerical probes of the speculative pipeline (the counterpart of
``sdvar_tpu/engine/probes.py``):
  - ``logit_diff_probe``: drive the draft scale by scale and, at each
    scale, verify the same drafted prefix with both models; report the
    largest |draft - target| CFG'd logit and the top-1 match rate;
  - ``handoff_invariance_probe``: with greedy sampling and draft == target,
    the handoff output must equal the baseline decode for every entry_num;
  - ``gamma_sweep``: acceptance and call counts per gamma.
The probes use the engine's kv_mode for every cache they make.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from sdvar_tpu_torch.config import SamplingConfig, SpeculativeConfig
from sdvar_tpu_torch.engine.decode import Seeds, decode_all_scales, scale_step
from sdvar_tpu_torch.engine.speculative import (
    SpeculativeEngine,
    _target_verify_window,
)
from sdvar_tpu_torch.utils.device import full_f32


@torch.inference_mode()
@full_f32()
def logit_diff_probe(eng: SpeculativeEngine, label_B, seed: Seeds = 0,
                     samp: SamplingConfig = SamplingConfig(),
                     upto_scale: Optional[int] = None) -> List[Dict]:
    """Per scale: ``match_rate`` (the draft's sampled tokens against the
    target's argmax), ``logit_absdiff_max`` (max |draft - target| CFG'd
    logits on the same slice, ~0 when draft == target) and
    ``target_logit_absmax``. Each model verifies in a cache of its own, so
    the probe never perturbs the draft's decode cache."""
    S = eng.num_scales if upto_scale is None else upto_scale
    labels, dseeds, tseeds = eng._streams(label_B, seed)
    B = labels.shape[0]
    d_state, d_sos, d_lvl, d_mods = eng._start(
        eng.draft_cfg, eng.draft_params, labels, dseeds,
        eng._new_cache(eng.draft_cfg, 2 * B))
    t_state, t_sos, t_lvl, t_mods = eng._start(
        eng.target_cfg, eng.target_params, labels, tseeds,
        eng._new_cache(eng.target_cfg, 2 * B))
    d_vcache = eng._new_cache(eng.draft_cfg, 2 * B)
    report = []
    for si in range(S):
        hub = [] if si == 0 else [d_state.next_map]
        d_state, d_ids = scale_step(eng.draft_cfg, eng.vae_cfg,
                                    eng.draft_params, eng.quant_params, si,
                                    d_state, d_sos, d_lvl, samp, eng.dtype,
                                    mods=d_mods)
        t_argmax, t_logits = _target_verify_window(
            eng.target_cfg, eng.target_params, si, 1, t_state.cache, t_sos,
            t_lvl, hub, samp, eng.dtype, t_mods)
        _, d_logits = _target_verify_window(
            eng.draft_cfg, eng.draft_params, si, 1, d_vcache, d_sos, d_lvl,
            hub, samp, eng.dtype, d_mods)
        report.append({
            "scale": si,
            "match_rate": (d_ids == t_argmax[0]).float().mean().item(),
            "logit_absdiff_max": (d_logits[0] - t_logits[0]).abs().max().item(),
            "target_logit_absmax": t_logits[0].abs().max().item(),
        })
    return report


def handoff_invariance_probe(eng: SpeculativeEngine, label_B,
                             seed: Seeds = 0,
                             cfg_strength: float = 1.5) -> Dict[int, float]:
    """Greedy sampling: max |f_hat - baseline f_hat| of the block-causal
    handoff (sd_mask 3) for every entry_num; with draft == target each is
    0 up to the rounding of a prefill's other product shapes."""
    samp = SamplingConfig(cfg=cfg_strength, top_k=1)
    base = decode_all_scales(eng.target_cfg, eng.vae_cfg, eng.target_params,
                             eng.quant_params, label_B, seed, samp, eng.dtype,
                             kv_mode=eng.kv_mode, device=eng.device)
    diffs = {}
    for entry in range(1, eng.num_scales + 1):
        f_hat, _ = eng.generate_handoff(label_B, seed, entry_num=entry,
                                        sd_mask=3, samp=samp)
        diffs[entry] = (f_hat - base).abs().max().item()
    return diffs


def gamma_sweep(eng: SpeculativeEngine, label_B, seed: Seeds = 0,
                gammas=(1, 2, 3),
                samp: SamplingConfig = SamplingConfig()) -> List[Dict]:
    """``SpecStats.as_dict()`` of one speculative generation per gamma,
    with ``gamma`` and ``mean_match_rate``."""
    out = []
    for g in gammas:
        _, stats = eng.generate_speculative(label_B, seed,
                                            SpeculativeConfig(gamma=g), samp)
        d = stats.as_dict()
        d["gamma"] = g
        d["mean_match_rate"] = (float(np.mean(d["match_rates"]))
                                if d["match_rates"] else 0.0)
        out.append(d)
    return out
