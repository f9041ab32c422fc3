"""SDVAR speculative decoding: a draft VAR proposes whole token maps, scale
by scale, and the target VAR verifies a window of gamma scales in one
forward (the counterpart of ``sdvar_tpu/engine/speculative.py``).

What it does, as the JAX package does it:
  - the static draft -> target handoff (``generate_handoff``) with the six
    sd_mask prefill variants and ``ref_quirks``;
  - the batched draft-gamma / verify loop (``generate_speculative``):
    per-scale top-1 match rates, batch-global, accepted at >= the
    threshold with cascade reject, dynamic gamma on total rejection, the
    force-accept at gamma = 1, optional ``resample_on_reject`` and the
    ``force_accept_all`` measurement switch;
  - multi-phase schedules (``generate_phased``);
  - separate draft and target random streams, so outputs do not depend on
    how the loop is driven: here per-request seed streams folded out of
    each request's seed (``ops.sampling.fold_seeds``), in place of JAX key
    folding.

The caches are written in place and threaded through every call, which is
what the JAX version's buffer donation amounts to. Rollback costs nothing:
the keys and values of scale s are a projection of the input map that
feeds s (from scale s-1's tokens), so an accepted prefix's rows stay
right, and a rejected window's rows are rewritten at the same offsets
before any read (a forward writes [begin, end) and only then attends over
[0, end)). The window's match rates are one device tensor, read back with
one host sync per round.

On a mesh (``mesh=``, the mesh registered with ``ops.partition``) each
rank runs its own requests' rows with its shard of both models and keeps
its part of both caches per batch size. Acceptance stays batch-global:
the per-scale match counts are all-reduced over "data" before the rates
are compared, so every rank takes the same branch (a rank that took
another would wait forever in the next collective), and the target's
argmax sees the whole vocab (all-gathered over "model").
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdvar_tpu_torch.config import (
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine.decode import (
    DecodeState,
    Seeds,
    init_decode,
    scale_step,
)
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import KVCache
from sdvar_tpu_torch.ops.masks import (
    device_bias,
    hidden_prefix_decode_bias,
    prefill_bias,
    verify_window_bias,
)
from sdvar_tpu_torch.ops.partition import (
    data_rows,
    gather_data,
    gather_vocab,
    get_tp_mesh,
    reduce_data,
)
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache
from sdvar_tpu_torch.ops.sampling import (
    cfg_double,
    cfg_mix,
    fold_seeds,
    request_seeds,
    row_seeds,
    sample_with_top_k_top_p,
)
from sdvar_tpu_torch.utils.device import full_f32, resolve_device

DRAFT_STREAM = 1
TARGET_STREAM = 2


@dataclass
class SpecStats:
    """Efficiency counters of one generation."""

    target_calls: int = 0
    draft_calls: int = 0
    accept_count: int = 0
    reject_count: int = 0
    forced_accepts: int = 0
    resampled_scales: int = 0
    match_rates: List[float] = field(default_factory=list)

    def as_dict(self) -> Dict:
        return {
            "target_calls": self.target_calls,
            "draft_calls": self.draft_calls,
            "accept_count": self.accept_count,
            "reject_count": self.reject_count,
            "forced_accepts": self.forced_accepts,
            "resampled_scales": self.resampled_scales,
            "match_rates": list(self.match_rates),
        }


# ---------------------------------------------------------------------------
# Forwards over windows of scales
# ---------------------------------------------------------------------------

def _window_x(cfg: VARConfig, params, start: int, n: int, hub, sos, lvl_pos,
              dtype) -> torch.Tensor:
    """The inputs of scales [start, start + n) as one (2B, Lq, C) block:
    scale 0 from the class embedding, scale k > 0 from the continuous map
    that feeds it, re-embedded with this model's word_embed. ``hub[j]``
    feeds scale start + j, or start + j + 1 when the window starts at 0
    (scale 0 takes no hub entry)."""
    xs = []
    for j, k in enumerate(range(start, start + n)):
        if k == 0:
            xs.append((sos[:, None, :] + params["pos_start"][None]
                       + lvl_pos[None, : cfg.first_l]).to(dtype))
            continue
        nm = hub[j - 1] if start == 0 else hub[j]
        B, pn = nm.shape[0], cfg.patch_nums[k]
        bg, ed = cfg.begin_ends[k]
        nm = nm.reshape(B, cfg.Cvae, pn * pn).transpose(1, 2)
        x = M.word_embed(params, nm, torch.float32) + lvl_pos[None, bg:ed]
        xs.append(cfg_double(x).to(dtype))
    return torch.cat(xs, dim=1)


@functools.lru_cache(maxsize=None)
def _t_per_token(patch_nums: Tuple[int, ...], cfg_strength: float,
                 start: int, gamma: int, device: torch.device) -> torch.Tensor:
    """Per-token CFG strength t = cfg * k / (S-1) over the window's
    scales, on the device once per window."""
    s1 = len(patch_nums) - 1
    t = np.concatenate([
        np.full(patch_nums[k] ** 2, cfg_strength * k / s1, dtype=np.float32)
        for k in range(start, start + gamma)])
    return torch.from_numpy(t).to(device)


def _apply_tokens(cfg: VARConfig, vae_cfg: VQVAEConfig, quant_params, si: int,
                  f_hat: torch.Tensor, ids: torch.Tensor):
    """Token ids (B, pn^2) of scale si -> (f_hat', next continuous map)."""
    B, pn = ids.shape[0], cfg.patch_nums[si]
    h = Q.embed(quant_params, ids).transpose(1, 2).reshape(B, cfg.Cvae, pn, pn)
    return Q.next_autoregressive_input(vae_cfg, quant_params, si, f_hat, h)


def _sample_scale(cfg: VARConfig, vae_cfg: VQVAEConfig, quant_params, si: int,
                  mixed: torch.Tensor, state: DecodeState,
                  samp: SamplingConfig) -> Tuple[DecodeState, torch.Tensor]:
    """Sample scale si from its CFG'd logits with the state's seeds and
    update the state."""
    ids = sample_with_top_k_top_p(
        mixed, row_seeds(state.seeds, si, cfg.patch_nums[si] ** 2),
        samp.top_k, samp.top_p, vocab=cfg.vocab_size)
    f_hat, next_map = _apply_tokens(cfg, vae_cfg, quant_params, si,
                                    state.f_hat, ids)
    return dataclasses.replace(state, f_hat=f_hat, next_map=next_map), ids


def _draft_window(cfg: VARConfig, vae_cfg: VQVAEConfig, params, quant_params,
                  start: int, gamma: int, state: DecodeState, sos, lvl_pos,
                  samp: SamplingConfig, dtype, mods):
    """Draft scales [start, start + gamma) one after another. Returns the
    per-scale ids and the per-scale (f_hat, next_map) checkpoints, for
    rollback to any accepted prefix; the next_maps are the hub of inputs
    the target verifies."""
    ids_list, ckpts = [], []
    for si in range(start, start + gamma):
        state, ids = scale_step(cfg, vae_cfg, params, quant_params, si, state,
                                sos, lvl_pos, samp, dtype, mods=mods)
        ids_list.append(ids)
        ckpts.append((state.f_hat, state.next_map))
    return ids_list, ckpts


def _target_verify_window(cfg: VARConfig, params, start: int, gamma: int,
                          cache, sos, lvl_pos, hub, samp: SamplingConfig,
                          dtype, mods):
    """One forward over scales [start, start + gamma): the window's new
    keys and values go into the cache at its start, and each scale attends
    over the accepted prefix and the window under the block-causal window
    mask. Returns per-scale target argmax ids (B, pn^2) and CFG'd logits
    (B, pn^2, V), the CFG strength per token; under a model split the
    logits are this rank's vocab columns and the argmax runs on the
    all-gathered vocab."""
    pns = cfg.patch_nums
    x = _window_x(cfg, params, start, gamma, hub, sos, lvl_pos, dtype)
    bg0 = cfg.begin_ends[start][0]
    kv_len = cfg.begin_ends[start + gamma - 1][1]
    bias = device_bias(x.device, verify_window_bias, pns, start, gamma, kv_len)
    h = M.apply_transformer(cfg, params, x, sos, attn_bias=bias, cache=cache,
                            cache_begin=bg0, kv_len=kv_len, mods=mods)
    logits = M.get_logits(cfg, params, h, sos)  # (2B, Lq, V) f32
    mixed = cfg_mix(logits, _t_per_token(pns, samp.cfg, start, gamma, x.device))
    whole = gather_vocab(mixed, cfg.vocab_size)
    argmax, per_scale = [], []
    pos = 0
    for k in range(start, start + gamma):
        argmax.append(whole[:, pos: pos + pns[k] ** 2].argmax(-1).to(torch.int32))
        per_scale.append(mixed[:, pos: pos + pns[k] ** 2])
        pos += pns[k] ** 2
    return argmax, per_scale


def _target_prefill_handoff(cfg: VARConfig, vae_cfg: VQVAEConfig, params,
                            quant_params, entry_num: int, sd_mask: int,
                            state: DecodeState, sos, lvl_pos, hub,
                            samp: SamplingConfig, dtype, mods,
                            ref_quirks: bool = False):
    """The handoff prefill: one forward over the drafted prefix
    [0, end(entry_num)) under the sd_mask's bias, then sample the entry
    scale from its slice. ``hub``: the draft's continuous maps feeding
    scales 1..entry_num; ``state.f_hat``: the draft's f_hat.

    ``ref_quirks`` reproduces the committed reference instead of the
    intended algorithm: for sd_mask 1..5 the entry scale's logits come from
    the raw input embeddings (the block outputs fill the cache only); for
    sd_mask 0 only the entry slice runs through the blocks, so the prefix
    never enters the cache and later scales hide its key columns."""
    pns = cfg.patch_nums
    sbg, sed = cfg.begin_ends[entry_num]
    x = _window_x(cfg, params, 0, entry_num + 1, hub, sos, lvl_pos, dtype)
    if ref_quirks and sd_mask == 0:
        bias = device_bias(x.device, hidden_prefix_decode_bias, pns,
                           entry_num, sbg)
        h = M.apply_transformer(cfg, params, x[:, sbg:sed], sos,
                                attn_bias=bias, cache=state.cache,
                                cache_begin=sbg, kv_len=sed, mods=mods)
        logits = M.get_logits(cfg, params, h, sos)
    else:
        bias = device_bias(x.device, prefill_bias, pns, entry_num, sd_mask)
        h = M.apply_transformer(cfg, params, x, sos, attn_bias=bias,
                                cache=state.cache, cache_begin=0, kv_len=sed,
                                mods=mods)
        src = x if (ref_quirks and sd_mask != 0) else h
        logits = M.get_logits(cfg, params, src[:, sbg:sed], sos)
    mixed = cfg_mix(logits, samp.cfg * (entry_num / cfg.num_stages_minus_1))
    return _sample_scale(cfg, vae_cfg, quant_params, entry_num, mixed, state,
                         samp)


def _takeover_generate(cfg: VARConfig, vae_cfg: VQVAEConfig, params,
                       quant_params, seen: int, cur: int, state: DecodeState,
                       sos, lvl_pos, hub, samp: SamplingConfig, dtype, mods):
    """Mid-sequence takeover: one forward that prefills scales [seen, cur)
    (re-embedded with this model's word_embed) and generates scale ``cur``
    from the final slice, under the block-causal window mask. ``hub``: the
    continuous maps feeding scales seen..cur (scale 0 needs none)."""
    pns = cfg.patch_nums
    gamma = cur - seen + 1
    x = _window_x(cfg, params, seen, gamma, hub, sos, lvl_pos, dtype)
    bg0 = cfg.begin_ends[seen][0]
    kv_len = cfg.begin_ends[cur][1]
    bias = device_bias(x.device, verify_window_bias, pns, seen, gamma, kv_len)
    h = M.apply_transformer(cfg, params, x, sos, attn_bias=bias,
                            cache=state.cache, cache_begin=bg0, kv_len=kv_len,
                            mods=mods)
    sbg, sed = cfg.begin_ends[cur]
    logits = M.get_logits(cfg, params, h[:, sbg - bg0: sed - bg0], sos)
    mixed = cfg_mix(logits, samp.cfg * (cur / cfg.num_stages_minus_1))
    return _sample_scale(cfg, vae_cfg, quant_params, cur, mixed, state, samp)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class SpeculativeEngine:
    """Host-side orchestrator of a draft/target pair that share one tokenizer.

    Usage:
        eng = SpeculativeEngine(vae_cfg, draft_cfg, target_cfg, vae_params,
                                draft_params, target_params)
        f_hat, stats = eng.generate_speculative(labels, seed=0)
        images = eng.decode_image(f_hat)

    ``seed``: an int for the whole batch or one per request (as in
    ``engine.decode``). Acceptance is batch-global (the match rate of a
    scale is taken over the whole batch), so in this mode a request's
    tokens may depend on its batch companions. ``mesh``: the registered
    mesh the engine's parameters are cut for (``parallel.mesh.shard_tree``);
    each rank is handed the whole batch and returns its own rows' f_hat
    (and ids), or the whole batch's with ``gather``.
    """

    CACHE_POOL_MAX = 2

    def __init__(self, vae_cfg: VQVAEConfig, draft_cfg: VARConfig,
                 target_cfg: VARConfig, vae_params, draft_params,
                 target_params, dtype=torch.bfloat16, kv_mode: str = "bf16",
                 mesh=None, device="cuda"):
        if mesh is not None and mesh is not get_tp_mesh():
            raise ValueError("mesh: pass the mesh registered with "
                             "ops.partition.set_tp_mesh")
        if draft_cfg.patch_nums != target_cfg.patch_nums:
            raise ValueError("draft and target must share the scale schedule")
        if kv_mode not in ("bf16", "f32", "int8"):
            raise ValueError(f"unknown kv_mode {kv_mode!r} (bf16 | f32 | int8)")
        self.device = resolve_device(device)
        self.vae_cfg = vae_cfg
        self.draft_cfg, self.target_cfg = draft_cfg, target_cfg
        self.vae_params = vae_params
        self.draft_params, self.target_params = draft_params, target_params
        self.quant_params = vae_params["quant"]
        self.dtype = dtype
        self.kv_mode = kv_mode
        self.mesh = mesh
        self.num_scales = len(draft_cfg.patch_nums)
        # per-batch-size (draft, target) caches, reused across calls (a
        # server calls once per batch): every scale writes its rows before
        # it reads them. Each entry holds two full caches, so only the
        # CACHE_POOL_MAX most recent batch sizes are kept.
        self._cache_pool: Dict[int, Tuple] = {}

    def clear_cache_pool(self) -> None:
        """Drop all pooled KV caches (frees their device memory)."""
        self._cache_pool.clear()

    def _pool_put(self, B: int, caches: Tuple) -> None:
        self._cache_pool[B] = caches  # B was popped at call start: appends
        while len(self._cache_pool) > self.CACHE_POOL_MAX:
            self._cache_pool.pop(next(iter(self._cache_pool)))

    def _new_cache(self, cfg: VARConfig, batch2: int):
        """A fresh KV cache of the engine's kv_mode for ``batch2`` rows of
        the whole batch (this rank's part under a mesh)."""
        if self.kv_mode == "int8":
            return QuantizedKVCache.create(cfg, batch2, device=self.device)
        return KVCache.create(
            cfg, batch2, device=self.device,
            dtype=torch.float32 if self.kv_mode == "f32" else torch.bfloat16)

    def _start(self, cfg: VARConfig, params, labels, seeds, cache):
        """(state, sos, lvl_pos, mods) of one model for a generation."""
        state, sos, lvl_pos = init_decode(cfg, params, labels, seeds,
                                          self.dtype, kv_mode=self.kv_mode,
                                          cache=cache, device=self.device)
        return state, sos, lvl_pos, M.precompute_modulations(cfg, params, sos)

    def _streams(self, label_B, seed: Seeds):
        """The whole batch's labels and draft/target seed streams, as
        ``init_decode`` takes them."""
        labels = torch.as_tensor(label_B, dtype=torch.long, device=self.device)
        req = request_seeds(seed, labels.shape[0], self.device)
        return labels, fold_seeds(req, DRAFT_STREAM), fold_seeds(req, TARGET_STREAM)

    # -- public API ---------------------------------------------------------

    @torch.inference_mode()
    @full_f32()
    def generate_speculative(self, label_B, seed: Seeds = 0,
                             spec: SpeculativeConfig = SpeculativeConfig(),
                             samp: SamplingConfig = SamplingConfig(),
                             resample_on_reject: bool = False,
                             return_ids: bool = False, gather: bool = False):
        """Batched draft-gamma / verify loop. Returns (f_hat, stats), and
        the committed ids (B, L) with ``return_ids``."""
        stats = SpecStats()
        S = self.num_scales
        labels, dseeds, tseeds = self._streams(label_B, seed)
        B = labels.shape[0]
        rows = data_rows(B)
        d_cache, t_cache = self._cache_pool.pop(B, (None, None))
        if d_cache is None:
            d_cache = self._new_cache(self.draft_cfg, 2 * B)
            t_cache = self._new_cache(self.target_cfg, 2 * B)
        d_state, d_sos, d_lvl, d_mods = self._start(
            self.draft_cfg, self.draft_params, labels, dseeds, d_cache)
        _, t_sos, t_lvl, t_mods = self._start(
            self.target_cfg, self.target_params, labels, tseeds, t_cache)
        ids_by_scale: List[Optional[torch.Tensor]] = [None] * S

        stage, gamma, attempt = 0, spec.gamma, 0
        while stage < S:
            g = min(gamma, S - stage)
            # 1. draft g scales; a retry after total rejection draws anew
            seeds = dseeds if attempt == 0 else fold_seeds(dseeds, 1000 + attempt)
            seeds = seeds[rows]  # the whole batch's streams, this rank's rows
            d_ids, d_ckpts = _draft_window(
                self.draft_cfg, self.vae_cfg, self.draft_params,
                self.quant_params, stage, g,
                dataclasses.replace(d_state, seeds=seeds), d_sos, d_lvl, samp,
                self.dtype, d_mods)
            stats.draft_calls += g
            # 2. the target verifies the window in one forward
            hub = ([] if stage == 0 else [d_state.next_map]) \
                + [nm for _, nm in d_ckpts[:-1]]
            t_argmax, t_logits = _target_verify_window(
                self.target_cfg, self.target_params, stage, g, t_cache, t_sos,
                t_lvl, hub, samp, self.dtype, t_mods)
            stats.target_calls += 1

            # 3. per-scale top-1 match rates, cascade reject (one sync):
            # the batch's match counts (summed over the data ranks) over
            # its token count
            if spec.force_accept_all:
                rates = [1.0] * g
            else:
                counts = reduce_data(torch.stack([
                    (d == t).sum(dtype=torch.int32)
                    for d, t in zip(d_ids, t_argmax)]))
                n = torch.tensor([B * self.target_cfg.patch_nums[k] ** 2
                                  for k in range(stage, stage + g)],
                                 dtype=torch.float32, device=counts.device)
                rates = (counts.float() / n).tolist()
            stats.match_rates.extend(rates)
            accept = 0
            for r in rates:
                if r < spec.match_threshold:
                    break
                accept += 1

            if accept > 0:
                f_hat, next_map = d_ckpts[accept - 1]
                d_state = dataclasses.replace(d_state, f_hat=f_hat,
                                              next_map=next_map)
                ids_by_scale[stage: stage + accept] = d_ids[:accept]
                stats.accept_count += accept
                stage += accept
                attempt = 0
                if accept == g:
                    continue
            # some (or all) scales rejected
            stats.reject_count += g - accept

            if resample_on_reject and stage < S:
                # the target's own sample for the first rejected scale:
                # progress with target-quality tokens every round
                rs = fold_seeds(fold_seeds(tseeds, stage), attempt)[rows]
                d_state, ids = _sample_scale(
                    self.target_cfg, self.vae_cfg, self.quant_params, stage,
                    t_logits[accept], dataclasses.replace(d_state, seeds=rs),
                    samp)
                ids_by_scale[stage] = ids
                stats.resampled_scales += 1
                stage += 1
                attempt = 0
                continue

            if accept == 0:
                if spec.dynamic_gamma and gamma > 1:
                    gamma -= 1
                    attempt += 1
                elif spec.force_accept_at_gamma1:  # livelock guard
                    f_hat, next_map = d_ckpts[0]
                    d_state = dataclasses.replace(d_state, f_hat=f_hat,
                                                  next_map=next_map)
                    ids_by_scale[stage] = d_ids[0]
                    stats.accept_count += 1
                    stats.forced_accepts += 1
                    stage += 1
                    attempt = 0
                else:
                    attempt += 1
            else:
                attempt += 1

        self._pool_put(B, (d_cache, t_cache))
        f_hat = gather_data(d_state.f_hat) if gather else d_state.f_hat
        if return_ids:
            ids = torch.cat(ids_by_scale, dim=1)
            return f_hat, stats, gather_data(ids) if gather else ids
        return f_hat, stats

    @torch.inference_mode()
    @full_f32()
    def generate_handoff(self, label_B, seed: Seeds = 0, entry_num: int = 4,
                         sd_mask: int = 0,
                         samp: SamplingConfig = SamplingConfig(),
                         ref_quirks: bool = False):
        """Static draft -> target handoff: the draft generates scales
        [0, entry_num), the target prefills that prefix under sd_mask's
        bias and finishes [entry_num, S). The default is the intended
        algorithm; ``ref_quirks`` reproduces the committed reference (see
        ``_target_prefill_handoff``). Returns (f_hat, stats)."""
        S = self.num_scales
        if not 0 < entry_num <= S:
            raise ValueError(f"entry_num {entry_num} not in [1, {S}]")
        stats = SpecStats()
        labels, dseeds, tseeds = self._streams(label_B, seed)
        B = labels.shape[0]
        d_state, d_sos, d_lvl, d_mods = self._start(
            self.draft_cfg, self.draft_params, labels, dseeds,
            self._new_cache(self.draft_cfg, 2 * B))
        _, d_ckpts = _draft_window(
            self.draft_cfg, self.vae_cfg, self.draft_params,
            self.quant_params, 0, entry_num, d_state, d_sos, d_lvl, samp,
            self.dtype, d_mods)
        stats.draft_calls += entry_num
        if entry_num == S:
            return d_ckpts[-1][0], stats

        t_state, t_sos, t_lvl, t_mods = self._start(
            self.target_cfg, self.target_params, labels, tseeds,
            self._new_cache(self.target_cfg, 2 * B))
        state, _ = _target_prefill_handoff(
            self.target_cfg, self.vae_cfg, self.target_params,
            self.quant_params, entry_num, sd_mask,
            dataclasses.replace(t_state, f_hat=d_ckpts[-1][0]), t_sos, t_lvl,
            [nm for _, nm in d_ckpts], samp, self.dtype, t_mods, ref_quirks)
        stats.target_calls += 1

        pns = self.target_cfg.patch_nums
        hide_upto = (self.target_cfg.begin_ends[entry_num][0]
                     if ref_quirks and sd_mask == 0 else 0)
        for si in range(entry_num + 1, S):
            bias = (device_bias(self.device, hidden_prefix_decode_bias, pns,
                                si, hide_upto) if hide_upto else None)
            state, _ = scale_step(self.target_cfg, self.vae_cfg,
                                  self.target_params, self.quant_params, si,
                                  state, t_sos, t_lvl, samp, self.dtype,
                                  mods=t_mods, attn_bias=bias)
            stats.target_calls += 1
        return state.f_hat, stats

    @torch.inference_mode()
    @full_f32()
    def generate_phased(self, label_B, seed: Seeds,
                        schedule: Tuple[Tuple[str, int], ...],
                        samp: SamplingConfig = SamplingConfig()):
        """Multi-phase generation over a (model, number of scales)
        schedule, e.g. (("target", 2), ("draft", 5), ("target", 3)); the
        counts sum to the number of scales. Each takeover re-embeds the
        scales the incoming model has not seen with its own word_embed and
        prefills them and generates the next scale in one forward;
        continuation scales run the KV-cached decode. The quantizer state
        (f_hat and the continuous maps) does not depend on the model.
        Returns (f_hat, stats)."""
        S = self.num_scales
        if sum(n for _, n in schedule) != S or not all(
                m in ("draft", "target") and n > 0 for m, n in schedule):
            raise ValueError(f"bad schedule {schedule} for {S} scales")
        stats = SpecStats()
        labels, dseeds, tseeds = self._streams(label_B, seed)
        B = labels.shape[0]
        models = {
            "draft": (self.draft_cfg, self.draft_params, dseeds),
            "target": (self.target_cfg, self.target_params, tseeds),
        }
        ctx: Dict[str, list] = {}  # model -> [state, sos, lvl, mods, seen]
        maps: List[torch.Tensor] = []  # maps[k]: the map feeding scale k+1
        f_hat = None
        cur = 0
        for name, count in schedule:
            cfg, params, seeds = models[name]
            if name not in ctx:
                ctx[name] = [*self._start(cfg, params, labels, seeds,
                                          self._new_cache(cfg, 2 * B)), 0]
            state, sos, lvl, mods, seen = ctx[name]
            if f_hat is not None:
                state = dataclasses.replace(state, f_hat=f_hat)
            first = cur
            if cur > seen or (cur == seen and cur > 0):
                # prefill the unseen scales [seen, cur), generate scale cur
                state, _ = _takeover_generate(
                    cfg, self.vae_cfg, params, self.quant_params, seen, cur,
                    state, sos, lvl, maps[max(seen - 1, 0): cur], samp,
                    self.dtype, mods)
                stats.target_calls += int(name == "target")
                stats.draft_calls += int(name == "draft")
                maps.append(state.next_map)
                first = cur + 1
            for si in range(first, cur + count):
                state, _ = scale_step(cfg, self.vae_cfg, params,
                                      self.quant_params, si, state, sos, lvl,
                                      samp, self.dtype, mods=mods)
                stats.target_calls += int(name == "target")
                stats.draft_calls += int(name == "draft")
                maps.append(state.next_map)
            cur += count
            f_hat = state.f_hat
            ctx[name] = [state, sos, lvl, mods, cur]
        return f_hat, stats

    @torch.inference_mode()
    def decode_image(self, f_hat: torch.Tensor) -> torch.Tensor:
        """f_hat -> images (B, 3, H, W) in [0, 1] through the f32 pixel
        decoder."""
        return (VQ.fhat_to_img(self.vae_cfg, self.vae_params, f_hat) + 1.0) * 0.5
