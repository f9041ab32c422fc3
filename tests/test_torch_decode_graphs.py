"""The decode's CUDA graphs (``engine/decode.py``: ``graphs_apply``,
``ScaleGraphs``).

On the CPU: which decodes take the graphs, and the replay's bookkeeping
(static inputs refreshed, a graph a scale and shape, weights that moved
drop the graphs) with each capture stood in for by a plain graph that
re-runs the captured forward on replay. Marked ``gpu`` (they skip where
there is no card): the graphed decode bit-equal to the eager one on the
card. Run those on a machine with an NVIDIA card (``--noconftest``: the
tests' conftest imports JAX, which the port does not need there):
    python -m pytest tests/test_torch_decode_graphs.py -q -m gpu -o addopts="" --noconftest
"""

import types

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import KVCache, init_var_params
from sdvar_tpu_torch.ops.attention import set_cache_kernel
from sdvar_tpu_torch.ops.partition import set_tp_mesh
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache, quantize_var_params

CPU_VAR = VARConfig(depth=2, num_classes=10, patch_nums=(1, 2, 3),
                    vocab_size=64, Cvae=8, head_dim=32)
CPU_VAE = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))
SAMP = SamplingConfig(cfg=1.5, top_k=10, top_p=0.9)
F32 = torch.float32


@pytest.fixture(scope="module")
def cpu_stack():
    params = init_var_params(CPU_VAR, seed=3, device="cpu")
    quant = VQ.init_vqvae_params(CPU_VAE, seed=4, device="cpu", eini=1.0)["quant"]
    return params, quant


def _cache(cfg, batch, kv_mode, device):
    if kv_mode == "int8":
        return QuantizedKVCache.create(cfg, 2 * batch, device=device)
    return KVCache.create(cfg, 2 * batch, device=device,
                          dtype=F32 if kv_mode == "f32" else torch.bfloat16)


class _PlainGraph:
    """A CUDA graph's stand-in on the CPU: the capture runs the forward
    once, and each replay runs it again into the same output tensor,
    reading the static inputs as they then are (the cache writes of a
    scale are the same rows on every run)."""

    def __init__(self, fn):
        self.fn, self.out, self.replays = fn, fn(), 0

    def replay(self):
        self.out.copy_(self.fn())
        self.replays += 1


@pytest.fixture
def plain_graphs(monkeypatch):
    """Graphs on the CPU: ``graphs_apply`` as on a card, captures made by
    ``_PlainGraph``; yields the graphs made."""
    made = []

    def capture(fn, dev):
        made.append(_PlainGraph(fn))
        return made[-1], made[-1].out

    monkeypatch.setattr(D, "graphs_apply",
                        lambda cache, device: cache is not None)
    monkeypatch.setattr(D, "_capture", capture)
    return made


def _choice_mesh(stack, monkeypatch):
    set_tp_mesh(types.SimpleNamespace(data=1, model=2))
    try:
        return D.graphs_apply(object(), "cuda")
    finally:
        set_tp_mesh(None)


def _choice_attn_bias(stack, monkeypatch):
    """A step with an attention bias runs the block stack eagerly, even
    when handed the decode's graphs."""
    params, quant = stack

    class Refuse:
        def forward(self, *a):
            raise AssertionError("a biased step must not replay")

    state, sos, lvl = D.init_decode(CPU_VAR, params, [1, 2], 5, F32,
                                    kv_mode="f32", device="cpu")
    mods = M.precompute_modulations(CPU_VAR, params, sos)
    D.scale_step(CPU_VAR, CPU_VAE, params, quant, 0, state, sos, lvl, SAMP,
                 F32, mods=mods, attn_bias=torch.zeros(1, 1), graphs=Refuse())
    return False


def _choice_no_cache(stack, monkeypatch):
    return D.graphs_apply(None, "cuda")


def _choice_cpu(stack, monkeypatch):
    return D.graphs_apply(object(), "cpu")


def _choice_reused_cache(stack, monkeypatch):
    return D.graphs_apply(object(), "cuda")


def _choice_cpu_decode(stack, monkeypatch):
    """A CPU decode into a reused cache never makes graphs."""
    monkeypatch.setattr(D, "ScaleGraphs", None)
    params, quant = stack
    cache = _cache(CPU_VAR, 2, "f32", "cpu")
    D.decode_all_scales(CPU_VAR, CPU_VAE, params, quant, [1, 2], 5, SAMP, F32,
                        kv_mode="f32", cache=cache, device="cpu")
    return False


def _choice_scale_step_alone(stack, monkeypatch):
    """``scale_step`` as the speculative engine calls it, with no
    ``graphs``, runs the block stack eagerly."""
    params, quant = stack
    calls = []
    eager = M.apply_transformer
    monkeypatch.setattr(M, "apply_transformer",
                        lambda *a, **k: calls.append(1) or eager(*a, **k))
    state, sos, lvl = D.init_decode(CPU_VAR, params, [1, 2], 5, F32,
                                    kv_mode="f32", device="cpu")
    mods = M.precompute_modulations(CPU_VAR, params, sos)
    for si in range(CPU_VAR.num_scales):
        state, _ = D.scale_step(CPU_VAR, CPU_VAE, params, quant, si, state,
                                sos, lvl, SAMP, F32, mods=mods)
    return len(calls) != CPU_VAR.num_scales


@pytest.mark.parametrize("case, graphed", [
    (_choice_mesh, False),
    (_choice_attn_bias, False),
    (_choice_no_cache, False),
    (_choice_cpu, False),
    (_choice_cpu_decode, False),
    (_choice_scale_step_alone, False),
    (_choice_reused_cache, True),
], ids=lambda v: v.__name__.removeprefix("_choice_")
   if callable(v) else str(v))
def test_decode_path_choice(cpu_stack, monkeypatch, case, graphed):
    """Eager under a mesh, with an attention bias, without a reused cache,
    on the CPU and for ``scale_step`` on its own; graphed for a reused
    cache on a card."""
    assert case(cpu_stack, monkeypatch) is graphed


def _decode(stack, labels, seed, cache=None, kv_mode="f32", params=None):
    p, quant = stack
    return D.decode_all_scales(CPU_VAR, CPU_VAE, params or p, quant, labels,
                               seed, SAMP, F32, return_ids=True,
                               kv_mode=kv_mode, cache=cache, device="cpu")


@pytest.mark.parametrize("kv_mode", ["f32", "bf16", "int8"])
def test_replays_refresh_the_static_inputs(cpu_stack, plain_graphs, kv_mode):
    """Three decodes of other labels and seeds into one cache: the first
    captures a graph a scale, the later ones replay them, and each equals
    the eager decode of its batch bit for bit."""
    cache = _cache(CPU_VAR, 2, kv_mode, "cpu")
    before = None
    for labels, seed in (([1, 2], 5), ([7, 3], 6), ([0, 9], 2 ** 31 + 7)):
        f_hat, ids = _decode(cpu_stack, labels, seed, cache, kv_mode)
        want_f, want_ids = _decode(cpu_stack, labels, seed, None, kv_mode)
        assert torch.equal(ids, want_ids) and torch.equal(f_hat, want_f)
        before = before or [g.replays for g in plain_graphs]
    assert len(plain_graphs) == CPU_VAR.num_scales
    assert [g.replays - n for g, n in zip(plain_graphs, before)] \
        == [2] * CPU_VAR.num_scales


def test_a_graph_a_shape_and_switch(cpu_stack, plain_graphs):
    """Each cache captures its own graphs, and the cache-kernel switch a
    set of its own on the same cache; the first sets still replay, and
    each decode equals its eager one."""
    caches = {b: _cache(CPU_VAR, b, "f32", "cpu") for b in (2, 4)}
    S = CPU_VAR.num_scales
    _decode(cpu_stack, [1, 2, 3, 4], 1, caches[4])
    _decode(cpu_stack, [1, 2], 1, caches[2])
    assert len(plain_graphs) == 2 * S
    set_cache_kernel(True)
    try:
        f_hat, ids = _decode(cpu_stack, [5, 6, 7, 8], 2, caches[4])
    finally:
        set_cache_kernel(False)
    assert len(plain_graphs) == 3 * S
    want_f, want_ids = _decode(cpu_stack, [5, 6, 7, 8], 2)
    assert torch.equal(ids, want_ids) and torch.equal(f_hat, want_f)
    before = [g.replays for g in plain_graphs]
    for b, labels in ((4, [3, 3, 3, 3]), (2, [0, 8])):
        f_hat, ids = _decode(cpu_stack, labels, 4, caches[b])
        want_f, want_ids = _decode(cpu_stack, labels, 4)
        assert torch.equal(ids, want_ids) and torch.equal(f_hat, want_f)
    assert [g.replays - n for g, n in zip(plain_graphs, before)] \
        == [1] * 2 * S + [0] * S


def test_moved_weights_drop_the_graphs(cpu_stack, plain_graphs):
    """Weights at other addresses (a new tree, or a leaf replaced) are not
    the captured ones: the cache's graphs are dropped and captured again."""
    params, quant = cpu_stack
    cache = _cache(CPU_VAR, 2, "f32", "cpu")
    _decode(cpu_stack, [1, 2], 1, cache)
    other = {k: v for k, v in params.items()}
    other["head"] = {k: v.clone() * 2 for k, v in params["head"].items()}
    f_hat, ids = _decode(cpu_stack, [1, 2], 1, cache, params=other)
    want_f, want_ids = _decode(cpu_stack, [1, 2], 1, params=other)
    assert torch.equal(ids, want_ids) and torch.equal(f_hat, want_f)
    assert len(plain_graphs) == 2 * CPU_VAR.num_scales
    assert len(cache._scale_graphs) == 1


def _hold_sampler_calls(monkeypatch):
    """The benchmark check's pattern: a wrapper around the decode's sampler
    call that holds each call's logits and ids."""
    held = []
    orig = D.sample_with_top_k_top_p

    def sample(logits, seeds, *a, **k):
        ids = orig(logits, seeds, *a, **k)
        held.append((logits, ids))
        return ids

    monkeypatch.setattr(D, "sample_with_top_k_top_p", sample)
    return held


def test_held_sampler_inputs_survive_later_replays(cpu_stack, plain_graphs,
                                                   monkeypatch):
    """Logits and ids held from a decode's sampler calls keep their values
    through two later replayed decodes: no graph buffer reaches them."""
    cache = _cache(CPU_VAR, 2, "f32", "cpu")
    _decode(cpu_stack, [4, 4], 9, cache)
    held = _hold_sampler_calls(monkeypatch)
    _decode(cpu_stack, [1, 2], 1, cache)
    first = [(lg.clone(), ids.clone()) for lg, ids in held]
    _decode(cpu_stack, [7, 3], 2, cache)
    _decode(cpu_stack, [5, 0], 3, cache)
    for (lg, ids), (lg0, ids0) in zip(held, first):
        assert torch.equal(lg, lg0) and torch.equal(ids, ids0)


# --------------------------------------------------------------------------
# On the card: real graphs against the eager decode
# --------------------------------------------------------------------------

GPU_VAR = VARConfig(depth=4)
GPU_VAE = VQVAEConfig()
GPU_SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)


@pytest.fixture(scope="module")
def card_stack():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    params = init_var_params(GPU_VAR, seed=0, device=dev, dtype=torch.bfloat16)
    quant = VQ.init_vqvae_params(GPU_VAE, seed=1, device=dev, eini=1.0)["quant"]
    return dev, params, quant


def _card_decode(card_stack, labels, seed, cache=None, kv_mode="bf16",
                 params=None, dtype=torch.bfloat16):
    dev, p, quant = card_stack
    out = D.decode_all_scales(GPU_VAR, GPU_VAE, params or p, quant,
                              torch.as_tensor(labels), seed, GPU_SAMP, dtype,
                              return_ids=True, kv_mode=kv_mode, cache=cache,
                              device=dev)
    torch.cuda.synchronize()
    return out


def _equal_to_eager(card_stack, cache, labels, seed, **kw):
    f_hat, ids = _card_decode(card_stack, labels, seed, cache, **kw)
    want_f, want_ids = _card_decode(card_stack, labels, seed, None, **kw)
    return torch.equal(ids, want_ids) and torch.equal(f_hat, want_f)


BATCHES = [(list(range(8)), 11), ([999 - i for i in range(8)], 2 ** 31 + 5),
           ([i * 37 % 1000 for i in range(8)], 4_000_000_123)]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_mode, w8a8, cache_kernel", [
    ("bf16", False, False), ("bf16", False, True), ("f32", False, False),
    ("f32", False, True), ("int8", False, False), ("int8", True, False),
    ("int8", True, True)])
def test_graphed_decode_is_the_eager_decode(card_stack, kv_mode, w8a8,
                                            cache_kernel):
    """The first decode (captured) and a second and a third with other
    labels and seeds (replayed) equal the eager decode bit for bit, for
    each KV mode, W8A8 weights and the cache-kernel switch."""
    dev, params, _ = card_stack
    if w8a8:
        params = quantize_var_params(params, mode="w8a8")
    cache = _cache(GPU_VAR, 8, kv_mode, dev)
    set_cache_kernel(cache_kernel)
    try:
        for labels, seed in BATCHES:
            assert _equal_to_eager(card_stack, cache, labels, seed,
                                   kv_mode=kv_mode, params=params)
    finally:
        set_cache_kernel(False)
    assert len(next(iter(cache._scale_graphs.values())).scales) \
        == GPU_VAR.num_scales


@pytest.mark.gpu
def test_graphed_buckets_interleaved(card_stack):
    """The server's buckets 8/16/32, one cache each, decoded in an
    interleaved order with their graphs in one pool: each batch equals its
    eager decode bit for bit."""
    dev = card_stack[0]
    caches = {b: _cache(GPU_VAR, b, "bf16", dev) for b in (8, 16, 32)}
    for i, b in enumerate((8, 16, 32, 16, 8, 32, 32, 8)):
        labels = [(7 * i + j) % 1000 for j in range(b)]
        assert _equal_to_eager(card_stack, caches[b], labels, 100 + i)


@pytest.mark.gpu
def test_held_sampler_calls_on_the_card(card_stack, monkeypatch):
    """The benchmark check's pattern on the card: each scale's sampler
    logits and ids, held from a replayed decode across two later ones,
    still equal their own eager values."""
    dev = card_stack[0]
    cache = _cache(GPU_VAR, 8, "bf16", dev)
    _card_decode(card_stack, *BATCHES[0], cache)  # captures
    held = _hold_sampler_calls(monkeypatch)
    _card_decode(card_stack, *BATCHES[1], cache)
    graphed = list(held)
    _card_decode(card_stack, *BATCHES[2], cache)
    _card_decode(card_stack, *BATCHES[0], cache)
    held.clear()
    _card_decode(card_stack, *BATCHES[1])  # eager
    assert len(held) == len(graphed) == GPU_VAR.num_scales
    for (lg, ids), (lg0, ids0) in zip(graphed, held):
        assert torch.equal(lg, lg0) and torch.equal(ids, ids0)


# --------------------------------------------------------------------------
# Who owns the FID sampler's KV cache (and the graphs captured against it)
# --------------------------------------------------------------------------


def _fid_run(stack, params, batch, cache=None):
    from sdvar_tpu_torch import sample_fid
    vae = VQ.init_vqvae_params(CPU_VAE, seed=4, device="cpu", eini=1.0)
    return list(sample_fid.sample_batches(
        CPU_VAR, CPU_VAE, params, vae, [1, 2, 3], batch, SAMP, dtype=F32,
        kv_mode="f32", log_every=0, device="cpu", cache=cache))


def _owner_kept_for_the_next_call(stack):
    """A call passed no cache leaves its own, which the next call of the
    same shape takes up; a call of another batch replaces it."""
    from sdvar_tpu_torch import sample_fid
    params = stack[0]
    _fid_run(stack, params, 2)
    first = sample_fid._spare.cache
    _fid_run(stack, params, 2)
    assert sample_fid._spare.cache is first
    _fid_run(stack, params, 3)
    return sample_fid._spare.cache is not first and \
        sample_fid._spare.key[1] == 3


def _owner_dropped_with_the_weights(stack):
    """The spare belongs to the weights it decoded with: freeing them
    frees it."""
    import gc
    from sdvar_tpu_torch import sample_fid
    params = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  {kk: vv.clone() for kk, vv in v.items()})
              for k, v in stack[0].items()}
    _fid_run(stack, params, 2)
    held = sample_fid._spare is not None
    del params
    gc.collect()
    return held and sample_fid._spare is None


def _owner_the_callers_cache(stack):
    """A cache the caller passes is the decode's, and is left to the
    caller alone: the spare stays as it was."""
    from sdvar_tpu_torch import sample_fid
    params = stack[0]
    _fid_run(stack, params, 2)
    spare = sample_fid._spare
    cache = _cache(CPU_VAR, 2, "f32", "cpu")
    got = _fid_run(stack, params, 2, cache=cache)
    want = _fid_run(stack, params, 2)
    return (sample_fid._spare.cache is spare.cache
            and bool(cache.k.abs().sum() > 0)
            and all(np.array_equal(a, b) for a, b in zip(got, want)))


@pytest.mark.parametrize("case", [_owner_kept_for_the_next_call,
                                  _owner_dropped_with_the_weights,
                                  _owner_the_callers_cache],
                         ids=lambda f: f.__name__.removeprefix("_owner_"))
def test_fid_cache_owner(cpu_stack, case):
    """``sample_fid.sample_batches``' KV cache: the caller's when passed,
    else a spare kept for the next call for as long as the weights live."""
    assert case(cpu_stack)


@pytest.mark.gpu
def test_capture_spans_under_the_profiler(card_stack):
    """A new cache's first decode under ``torch.profiler`` captures each
    scale (a ``sdvar.decode.capture`` span with its rows and scale, the
    instantiation's ``sdvar.decode.instantiate`` inside it) and replays
    it; the next decode only replays; both equal the eager decode."""
    from sdvar_tpu_torch.utils import profiling
    dev = card_stack[0]
    cache = _cache(GPU_VAR, 8, "bf16", dev)
    S = GPU_VAR.num_scales
    for captures, (labels, seed) in ((S, BATCHES[0]), (0, BATCHES[1])):
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        try:
            f_hat, ids = _card_decode(card_stack, labels, seed, cache)
        finally:
            prof.stop()
        spans = profiling.spans()
        names = [s.name for s in spans]
        caps = [s for s in spans if s.name == "sdvar.decode.capture"]
        inst = [s for s in spans if s.name == "sdvar.decode.instantiate"]
        assert [(c.ids["rows"], c.ids["si"]) for c in caps] \
            == [(16, si) for si in range(captures)]
        assert [s.parent for s in inst] == [c.index for c in caps]
        assert names.count("sdvar.decode.replay") == S
        want_f, want_ids = _card_decode(card_stack, labels, seed)
        assert torch.equal(ids, want_ids) and torch.equal(f_hat, want_f)
