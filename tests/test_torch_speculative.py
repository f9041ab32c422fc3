"""The port's speculative engine against the JAX package's, and the port's
own invariants, on ``tests/test_speculative.py``'s stack: depth 2,
patch_nums (1, 2, 3, 4), head x30 so that greedy argmaxes are well apart,
f32, greedy sampling (``top_k=1``), so both engines are deterministic and
their runs comparable. The stack's AdaLN biases are drawn non-zero: the
initialiser's gates (1e-5) would let the blocks' outputs barely differ
from their inputs, and every mask and cache variant would then agree
whatever it computed.

Every engine test runs twice in the port, with the cache-kernel switch off
and on (``ops.attention.set_cache_kernel``; on the CPU the fused path runs
through its plain version); the JAX references are built once per module.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu import config as JC
from sdvar_tpu.engine.speculative import SpeculativeEngine as JEngine
from sdvar_tpu.models.quantizer import init_quantizer_params as j_init_quant
from sdvar_tpu.models.var import init_var_params as j_init_var
from sdvar_tpu_torch.config import (
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
    var_config_pair,
)
from sdvar_tpu_torch.engine import probes
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
from sdvar_tpu_torch.ops import attention as A
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax

PNS = (1, 2, 3, 4)
S = len(PNS)
VAR_KW = dict(num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
              head_dim=32)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
F32 = torch.float32
LABELS = [3, 7]
SAMP = SamplingConfig(cfg=1.5, top_k=1)
J_SAMP = JC.SamplingConfig(cfg=1.5, top_k=1)
KEY = 5
SCHEDULES = [
    (("draft", 2), ("target", 2)),
    (("target", 1), ("draft", 2), ("target", 1)),
    (("target", 2), ("draft", 2)),
    (("draft", 1), ("target", 1), ("draft", 1), ("target", 1)),
]


_j_init_var = jax.jit(j_init_var, static_argnums=0)  # one compile, not one per op


def _var_tree(cfg, key, seed):
    """The JAX initialiser's tree as numpy, head x30, AdaLN biases drawn."""
    p = jax.tree.map(np.asarray, _j_init_var(cfg, key))
    p["head"]["w"] = p["head"]["w"] * np.float32(30.0)
    b = p["blocks"]["ada_lin_b"]
    p["blocks"]["ada_lin_b"] = np.random.default_rng(seed).normal(
        0, 0.3, b.shape).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def stack():
    jt = JC.VARConfig(depth=2, **VAR_KW)
    jq = JC.VQVAEConfig(**VAE_KW)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    trees = {"target": _var_tree(jt, k1, 1), "draft": _var_tree(jt, k3, 3)}
    # a draft close to the target (its head perturbed): match rates between
    # 0 and 1, so windows are accepted in part
    near = jax.tree.map(lambda a: a, trees["target"])
    w = near["head"]["w"]
    near["head"] = {"w": w + np.random.default_rng(5).normal(
        0, 0.5 * w.std(), w.shape).astype(np.float32), "b": near["head"]["b"]}
    trees["near"] = near
    quant = jax.tree.map(np.asarray, j_init_quant(jq, k2, eini=1.0))
    tq = {k: torch.from_numpy(np.array(v)) for k, v in quant.items()}
    port = {k: var_params_from_jax(t, device="cpu") for k, t in trees.items()}
    return {"jv": jt, "jq": jq, "jtrees": trees, "jquant": quant,
            "tv": VARConfig(depth=2, **VAR_KW), "tq": VQVAEConfig(**VAE_KW),
            "tquant": tq, "port": port, "k4": k4}


def _jax_engine(stack, draft, kv_mode="f32"):
    t = stack["jtrees"]
    return JEngine(stack["jq"], stack["jv"], stack["jv"],
                   {"quant": stack["jquant"]}, t[draft], t["target"],
                   dtype=jnp.float32, kv_mode=kv_mode)


def _engine(stack, draft, kv_mode="f32"):
    p = stack["port"]
    return SpeculativeEngine(stack["tq"], stack["tv"], stack["tv"],
                             {"quant": stack["tquant"]}, p[draft], p["target"],
                             dtype=F32, kv_mode=kv_mode, device="cpu")


@pytest.fixture(scope="module")
def jref(stack):
    """One JAX engine run per (call, args), shared by both switch settings
    and every test of the module: (f_hat as numpy, stats dict)."""
    @functools.lru_cache(maxsize=None)
    def run(call, *args):
        key = jax.random.PRNGKey(KEY)
        labels = jnp.asarray(LABELS)
        if call == "spec":
            draft, gamma, resample, kv_mode, spec_kw = args
            f, st = _jax_engine(stack, draft, kv_mode).generate_speculative(
                labels, key, JC.SpeculativeConfig(gamma=gamma, **dict(spec_kw)),
                J_SAMP, resample_on_reject=resample)
        elif call == "handoff":
            sd_mask, quirks = args
            f, st = _jax_engine(stack, "target").generate_handoff(
                labels, key, entry_num=2, sd_mask=sd_mask, samp=J_SAMP,
                ref_quirks=quirks)
        else:
            f, st = _jax_engine(stack, "target").generate_phased(
                labels, key, args[0], J_SAMP)
        return np.asarray(f), st.as_dict()
    return run


@pytest.fixture(params=[False, True], ids=["unfused", "cache_kernel"])
def cache_kernel(request):
    """The cache-kernel switch for one test, restored afterwards."""
    prev = A.use_cache_kernel()
    A.set_cache_kernel(request.param)
    yield request.param
    A.set_cache_kernel(prev)


def _baseline(stack, kv_mode="f32"):
    return decode_all_scales(stack["tv"], stack["tq"], stack["port"]["target"],
                             stack["tquant"], LABELS, 0, SAMP, F32,
                             return_ids=True, kv_mode=kv_mode, device="cpu")


@pytest.mark.parametrize("resample", [False, True], ids=["cascade", "resample"])
@pytest.mark.parametrize("draft", ["target", "draft"], ids=["self", "distinct"])
@pytest.mark.parametrize("gamma", [1, 2, 3])
def test_generate_speculative_matches_jax(stack, jref, cache_kernel, gamma,
                                          draft, resample):
    want_f, want_stats = jref("spec", draft, gamma, resample, "f32", ())
    f, stats = _engine(stack, draft).generate_speculative(
        LABELS, KEY, SpeculativeConfig(gamma=gamma), SAMP,
        resample_on_reject=resample)
    assert stats.as_dict() == want_stats
    np.testing.assert_allclose(f.numpy(), want_f, rtol=1e-5, atol=1e-5)
    if draft == "target":
        assert stats.accept_count == S and stats.target_calls == -(-S // gamma)


@pytest.mark.parametrize("resample", [False, True], ids=["cascade", "resample"])
def test_partial_acceptance_matches_jax(stack, jref, cache_kernel, resample):
    """A draft near the target: windows accepted in part, the cascade's
    rollback to the accepted prefix, and resampling after it."""
    want_f, want_stats = jref("spec", "near", 3, resample, "f32", ())
    f, stats = _engine(stack, "near").generate_speculative(
        LABELS, KEY, SpeculativeConfig(gamma=3), SAMP,
        resample_on_reject=resample)
    assert stats.as_dict() == want_stats
    assert any(0 < r < 1 for r in stats.match_rates)
    np.testing.assert_allclose(f.numpy(), want_f, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quirks", [False, True], ids=["intended", "ref_quirks"])
@pytest.mark.parametrize("sd_mask", range(6))
def test_generate_handoff_matches_jax(stack, jref, cache_kernel, sd_mask,
                                      quirks):
    want_f, want_stats = jref("handoff", sd_mask, quirks)
    f, stats = _engine(stack, "target").generate_handoff(
        LABELS, KEY, entry_num=2, sd_mask=sd_mask, samp=SAMP, ref_quirks=quirks)
    assert stats.target_calls == want_stats["target_calls"] == S - 2
    assert stats.as_dict() == want_stats
    np.testing.assert_allclose(f.numpy(), want_f, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=["dt", "tdt", "td", "dtdt"])
def test_generate_phased_matches_jax(stack, jref, cache_kernel, schedule):
    """Within JAX's own bound for the phased schedules (2e-4), and, self-
    drafted and greedy, equal to the port's baseline decode."""
    want_f, want_stats = jref("phased", schedule)
    f, stats = _engine(stack, "target").generate_phased(LABELS, KEY, schedule,
                                                        SAMP)
    assert stats.as_dict() == want_stats
    np.testing.assert_allclose(f.numpy(), want_f, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f.numpy(), _baseline(stack)[0].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_int8_kv_selfdraft_accepts_everything(stack, jref, cache_kernel):
    want_f, want_stats = jref("spec", "target", 2, False, "int8", ())
    f, stats = _engine(stack, "target", "int8").generate_speculative(
        LABELS, KEY, SpeculativeConfig(gamma=2), SAMP)
    assert stats.accept_count == S and stats.reject_count == 0
    assert stats.as_dict() == want_stats
    np.testing.assert_allclose(f.numpy(), want_f, rtol=1e-5, atol=1e-5)


def test_force_accept_all_matches_jax(stack, jref, cache_kernel):
    """The measurement switch: every drafted scale accepted, ceil(S/gamma)
    verify calls, the draft's own decode."""
    want_f, want_stats = jref("spec", "draft", 3, False, "f32",
                              (("force_accept_all", True),))
    eng = _engine(stack, "draft")
    f, stats, ids = eng.generate_speculative(
        LABELS, KEY, SpeculativeConfig(gamma=3, force_accept_all=True), SAMP,
        return_ids=True)
    assert stats.as_dict() == want_stats and stats.target_calls == 2
    np.testing.assert_allclose(f.numpy(), want_f, rtol=1e-5, atol=1e-5)
    base_f, base_ids = decode_all_scales(
        stack["tv"], stack["tq"], stack["port"]["draft"], stack["tquant"],
        LABELS, 0, SAMP, F32, return_ids=True, kv_mode="f32", device="cpu")
    assert torch.equal(ids, base_ids) and torch.equal(f, base_f)


@pytest.mark.parametrize("kv_mode", ["f32", "int8"])
@pytest.mark.parametrize("gamma", [1, 2, 3])
def test_selfdraft_greedy_equals_baseline(stack, cache_kernel, gamma, kv_mode):
    """Draft == target, greedy: every scale accepted, and the ids and f_hat
    are the baseline decode's bits (the accepted scales are the draft's
    own decode)."""
    f, stats, ids = _engine(stack, "target", kv_mode).generate_speculative(
        LABELS, KEY, SpeculativeConfig(gamma=gamma), SAMP, return_ids=True)
    base_f, base_ids = _baseline(stack, kv_mode)
    assert stats.accept_count == S and stats.forced_accepts == 0
    assert torch.equal(ids, base_ids) and torch.equal(f, base_f)


def test_resample_exact_target_parity(stack, cache_kernel):
    """Every scale through the resample path (impossible threshold): the
    target-only baseline decode, ids equal. The resampled scales' keys
    were written from accepted inputs and the rejected rows are rewritten
    before any read, so nothing stale is attended."""
    spec = SpeculativeConfig(gamma=2, match_threshold=1.1, dynamic_gamma=False,
                             force_accept_at_gamma1=False)
    f, stats, ids = _engine(stack, "draft").generate_speculative(
        LABELS, KEY, spec, SAMP, resample_on_reject=True, return_ids=True)
    assert stats.resampled_scales == S and stats.accept_count == 0
    base_f, base_ids = _baseline(stack)
    assert torch.equal(ids, base_ids)
    torch.testing.assert_close(f, base_f, rtol=1e-5, atol=1e-5)


def test_cache_kernel_switch_gives_the_same_bits(stack):
    """The engine's results with the switch on are the switch-off bits:
    rejection, rollback and resampling, the hidden-prefix handoff and a
    takeover schedule."""
    def runs():
        eng = _engine(stack, "near")
        spec = eng.generate_speculative(LABELS, KEY, SpeculativeConfig(gamma=3),
                                        SAMP, resample_on_reject=True)
        hand = eng.generate_handoff(LABELS, KEY, entry_num=2, sd_mask=0,
                                    samp=SAMP, ref_quirks=True)
        phased = eng.generate_phased(LABELS, KEY, SCHEDULES[1], SAMP)
        return [(f, st.as_dict()) for f, st in (spec, hand, phased)]

    prev = A.use_cache_kernel()
    try:
        A.set_cache_kernel(False)
        off = runs()
        A.set_cache_kernel(True)
        on = runs()
    finally:
        A.set_cache_kernel(prev)
    for (f0, s0), (f1, s1) in zip(off, on):
        assert torch.equal(f0, f1) and s0 == s1


def test_cache_kernel_runs_every_cached_attention(stack, monkeypatch):
    """With the switch on, every cached attention of both models goes
    through the fused write (one call per layer and forward: depth 2 x
    (4 draft scales + 2 verify windows) at gamma 2), none through the
    unfused route; off, the reverse."""
    calls = {"write": 0, "attention": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(A, "attention_cache_write_plain",
                        count("write", A.attention_cache_write_plain))
    monkeypatch.setattr(A, "attention_plain",
                        count("attention", A.attention_plain))
    prev = A.use_cache_kernel()
    try:
        for on, want in ((True, {"write": 12, "attention": 0}),
                         (False, {"write": 0, "attention": 12})):
            A.set_cache_kernel(on)
            calls.update(write=0, attention=0)
            _engine(stack, "target").generate_speculative(
                LABELS, KEY, SpeculativeConfig(gamma=2), SAMP)
            assert calls == want, (on, calls)
    finally:
        A.set_cache_kernel(prev)


def test_bf16_cache_under_f32_model_raises_with_the_switch(stack, cache_kernel):
    """The fused path takes every cache the decode makes under its model;
    a bf16 cache under an f32 model is not one of them, and it raises
    rather than take the unfused route quietly."""
    eng = _engine(stack, "target", "bf16")
    if cache_kernel:
        with pytest.raises(ValueError, match="not taken"):
            eng.generate_speculative(LABELS, KEY, SpeculativeConfig(), SAMP)
    else:
        assert eng.generate_speculative(LABELS, KEY, SpeculativeConfig(),
                                        SAMP)[1].accept_count == S


def test_distinct_depth_pair_through_the_bridge(stack):
    """A JAX draft/target pair of other depths (``var_config_pair``, 2 and
    3) carried over by the bridge unchanged: the port's engine gives the
    JAX engine's stats and f_hat, the target verifying all S scales of the
    depth-2 draft in one forward."""
    kw = {k: v for k, v in VAR_KW.items() if k != "patch_nums"}
    jd, jt = JC.var_config_pair(2, 3, PNS, **kw)
    td, tt = var_config_pair(2, 3, PNS, **kw)
    assert (td.depth, tt.depth) == (jd.depth, jt.depth) == (2, 3)
    assert vars(td) == vars(jd) and vars(tt) == vars(jt)
    k = stack["k4"]
    jdraft = stack["jtrees"]["draft"]
    jtarget = _var_tree(jt, k, 4)
    # gamma = S with every scale accepted: one draft window and one verify
    # of the whole sequence, the fewest JAX programs to compile
    jf, jst = JEngine(stack["jq"], jd, jt, {"quant": stack["jquant"]}, jdraft,
                      jtarget, dtype=jnp.float32, kv_mode="f32"
                      ).generate_speculative(
        jnp.asarray(LABELS), jax.random.PRNGKey(KEY),
        JC.SpeculativeConfig(gamma=S, force_accept_all=True), J_SAMP)
    ptarget = var_params_from_jax(jtarget, device="cpu")
    assert ptarget["blocks"]["qkv_w"].shape[0] == 3
    eng = SpeculativeEngine(stack["tq"], td, tt, {"quant": stack["tquant"]},
                            stack["port"]["draft"], ptarget, dtype=F32,
                            kv_mode="f32", device="cpu")
    f, st = eng.generate_speculative(
        LABELS, KEY, SpeculativeConfig(gamma=S, force_accept_all=True), SAMP)
    assert st.as_dict() == jst.as_dict()
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)


def test_same_seed_same_result_other_seed_other_draft(stack):
    """Sampled (not greedy) speculative generation is a function of the
    seeds: the same seed twice gives the same bits, another seed other
    tokens."""
    samp = SamplingConfig(cfg=2.0, top_k=8, top_p=0.9)
    eng = _engine(stack, "draft")
    a, sa, ia = eng.generate_speculative([6], 21, SpeculativeConfig(), samp,
                                         return_ids=True)
    b, sb, ib = eng.generate_speculative([6], 21, SpeculativeConfig(), samp,
                                         return_ids=True)
    c, _, ic = eng.generate_speculative([6], 22, SpeculativeConfig(), samp,
                                        return_ids=True)
    assert torch.equal(a, b) and sa.as_dict() == sb.as_dict()
    assert torch.equal(ia, ib) and not torch.equal(ia, ic)


def test_cache_pool_is_bounded_and_reused(stack):
    eng = _engine(stack, "target")
    for b in (1, 2, 3, 2):
        eng.generate_speculative(list(range(b)), 0, SpeculativeConfig(), SAMP)
    assert list(eng._cache_pool) == [3, 2]
    pooled = eng._cache_pool[2]
    eng.generate_speculative([1, 2], 0, SpeculativeConfig(), SAMP)
    assert eng._cache_pool[2] == pooled
    eng.clear_cache_pool()
    assert not eng._cache_pool


def test_bad_arguments_raise(stack):
    with pytest.raises(ValueError, match="mesh registered"):
        SpeculativeEngine(stack["tq"], stack["tv"], stack["tv"],
                          {"quant": stack["tquant"]}, stack["port"]["draft"],
                          stack["port"]["target"], mesh=object(), device="cpu")
    eng = _engine(stack, "target")
    with pytest.raises(ValueError, match="entry_num"):
        eng.generate_handoff(LABELS, 0, entry_num=0)
    with pytest.raises(ValueError, match="schedule"):
        eng.generate_phased(LABELS, 0, (("draft", 1),))
    with pytest.raises(ValueError, match="sd_mask"):
        eng.generate_handoff(LABELS, 0, entry_num=2, sd_mask=6)


def test_probes(stack, cache_kernel):
    """Self-draft: the two models' logits agree exactly and match 1.0 at
    every scale, the handoff equals the baseline for every entry_num, and
    the sweep's target calls are ceil(S / gamma)."""
    eng = _engine(stack, "target")
    report = probes.logit_diff_probe(eng, LABELS, KEY, SAMP)
    assert [r["scale"] for r in report] == list(range(S))
    assert all(r["match_rate"] == 1.0 and r["logit_absdiff_max"] == 0.0
               and r["target_logit_absmax"] > 0 for r in report)
    diffs = probes.handoff_invariance_probe(eng, LABELS, KEY)
    assert diffs == {e: 0.0 for e in range(1, S + 1)}
    sweep = probes.gamma_sweep(eng, LABELS, KEY, samp=SAMP)
    assert [(d["gamma"], d["target_calls"], d["mean_match_rate"])
            for d in sweep] == [(1, 4, 1.0), (2, 2, 1.0), (3, 2, 1.0)]
    distinct = probes.logit_diff_probe(_engine(stack, "draft"), LABELS, KEY,
                                       SAMP, upto_scale=2)
    assert len(distinct) == 2 and distinct[1]["logit_absdiff_max"] > 0
