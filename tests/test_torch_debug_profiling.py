"""The port's debug and profiling utilities on the CPU (the counterparts of
``tests/test_debug.py``): ``nan_report`` gives the JAX package's lines on
the same tree, ``assert_finite``, ``checked`` and ``checked_grad_probe``
raise on NaN or inf (the probe names the bad gradient leaf), the RNG
fingerprint, anomaly mode, and ``run_training``'s ``dbg_nan`` stopping on
poisoned parameters with the bad leaf named; ``SpanTimer`` on the host
clock and through ``train_step``'s spans, ``trace`` writing a Chrome trace
with an ``annotate`` region, ``memory_stats`` on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.config import TrainConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.utils import debug as dbg
from sdvar_tpu_torch.utils import profiling as prof

PNS = (1, 2)


def _tree():
    return {"a": {"w": np.ones((4, 4), np.float32),
                  "b": np.array([1.0, np.nan, np.inf], np.float32)},
            "ids": np.arange(3),
            "clean": np.zeros((2,), np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def test_nan_report_matches_jax():
    from sdvar_tpu.utils import debug as jdbg

    import jax.numpy as jnp

    want = jdbg.nan_report({k: (jnp.asarray(v) if not isinstance(v, dict) else
                                {kk: jnp.asarray(vv) for kk, vv in v.items()})
                            for k, v in _tree().items()}, "params")
    got = dbg.nan_report(_torch(_tree()), "params")
    assert got == want and len(got) == 1
    assert got[0].startswith("params/a/b:") and "nan=1 inf=1 of 3" in got[0]
    assert dbg.first_bad_leaf(_torch(_tree()), "params") == "params/a/b"
    assert dbg.nan_report({"x": torch.ones(3)}) == []
    assert dbg.first_bad_leaf({"x": torch.ones(3)}) is None


def test_assert_finite_raises_with_report():
    with pytest.raises(FloatingPointError, match="grads/g"):
        dbg.assert_finite({"g": torch.tensor([float("nan")])}, "grads")
    dbg.assert_finite({"g": torch.tensor([0.0]), "n": [torch.ones(2)]}, "grads")


def test_checked_flags_a_nan_output():
    f = dbg.checked(torch.log)
    with pytest.raises(FloatingPointError, match="nan=1"):
        f(torch.tensor([-1.0]))
    np.testing.assert_allclose(f(torch.tensor([1.0])).numpy(), 0.0)


def test_checked_grad_probe_names_the_bad_gradient():
    """sqrt(w x) at w = 0: the forward is finite (0), the backward
    1 / (2 sqrt 0) is inf; the probe names the leaf."""
    def loss_fn(p, x):
        return torch.sqrt(p["w"] * x).sum(), {}

    grads, loss = dbg.checked_grad_probe(loss_fn, {"w": torch.tensor([4.0])},
                                         torch.tensor([1.0]))
    np.testing.assert_allclose(float(loss), 2.0)
    np.testing.assert_allclose(grads["w"].numpy(), [0.25])
    with pytest.raises(FloatingPointError, match="grads/w"):
        dbg.checked_grad_probe(loss_fn, {"w": torch.tensor([0.0])},
                               torch.tensor([1.0]))


def test_checked_grad_probe_catches_a_backward_nan():
    """A NaN made inside the backward (0 * inf) raises under anomaly mode."""
    def loss_fn(p, x):
        return (torch.sqrt(p["w"]) * x).sum(), {}

    with pytest.raises(FloatingPointError):
        dbg.checked_grad_probe(loss_fn, {"w": torch.tensor([0.0])},
                               torch.tensor([0.0]))
    assert not torch.is_anomaly_enabled()


def test_rng_fingerprint_stable_and_distinct():
    a, b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert dbg.rng_fingerprint(a) == dbg.rng_fingerprint(b)
    assert len(dbg.rng_fingerprint(a)) == 16
    assert dbg.rng_fingerprint(a) != dbg.rng_fingerprint(
        torch.Generator().manual_seed(8))
    torch.rand(3, generator=a)  # the state moves with the stream
    assert dbg.rng_fingerprint(a) != dbg.rng_fingerprint(b)


def test_enable_debug_nans_toggles_anomaly_mode():
    try:
        dbg.enable_debug_nans()
        assert torch.is_anomaly_enabled()
    finally:
        dbg.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()


def _tiny():
    tc = TrainConfig(depth=2, reso=32, global_batch_size=2, epochs=1,
                     label_smooth=0.0, dbg_nan=True)
    return (tc, VARConfig(depth=2, patch_nums=PNS, vocab_size=32, Cvae=8,
                          head_dim=32, num_classes=1000),
            VQVAEConfig(vocab_size=32, z_channels=8, ch=32, patch_nums=PNS))


def test_train_loop_dbg_nan_names_poisoned_params(tmp_path, monkeypatch):
    """run_training with dbg_nan stops at the first non-finite loss with a
    FloatingPointError that names the poisoned leaf."""
    from sdvar_tpu_torch.train import train_loop as TL

    tc, var_cfg, vae_cfg = _tiny()
    orig = TL.build_everything

    def poisoned(*a, **kw):
        vc, rc, vae, state = orig(*a, **kw)
        state.params["word_embed"]["w"][0, 0] = float("nan")
        return vc, rc, vae, state

    monkeypatch.setattr(TL, "build_everything", poisoned)
    with pytest.raises(FloatingPointError,
                       match=r"(?s)non-finite loss at it 1.*params/word_embed/w"):
        TL.run_training(tc, out_dir=str(tmp_path), max_iters=1,
                        dtype=torch.float32, var_cfg=var_cfg, vae_cfg=vae_cfg,
                        device="cpu")


def test_span_timer_on_the_host_clock():
    t = prof.SpanTimer("cpu")
    for _ in range(3):
        with t.span("a"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with t.span("b"):
        pass
    rep = t.report()
    totals = [r["total_s"] for r in rep.values()]
    assert totals == sorted(totals, reverse=True)  # the longest first
    assert rep["a"]["count"] == 3 and rep["b"]["count"] == 1
    assert rep["a"]["total_s"] > 0
    np.testing.assert_allclose(rep["a"]["mean_ms"], 1e3 * rep["a"]["total_s"] / 3)


def test_train_step_spans(tmp_path):
    """One train_step with a timer: tokenize, forward, backward and
    optimizer once each (no data all-reduce without a mesh)."""
    from sdvar_tpu_torch.models.var import init_var_params
    from sdvar_tpu_torch.models.vqvae import init_vqvae_params
    from sdvar_tpu_torch.train import trainer as T

    _, var_cfg, vae_cfg = _tiny()
    state = T.init_train_state(init_var_params(var_cfg, seed=0, device="cpu"))
    vae = init_vqvae_params(vae_cfg, seed=0, device="cpu")
    img = torch.zeros(2, 3, 32, 32)
    t = prof.SpanTimer("cpu")
    T.train_step(var_cfg, vae_cfg, state, vae, img, torch.tensor([1, 2]), 1e-4,
                 0.05, None, dtype=torch.float32, timer=t)
    rep = t.report()
    assert set(rep) == {"tokenize", "forward", "backward", "optimizer"}
    assert all(r["count"] == 1 for r in rep.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path)):
        with prof.annotate("sdvar_region"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(str(tmp_path), prof.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sdvar_region" for e in events)


def test_memory_stats_on_the_cpu():
    assert prof.memory_stats("cpu") == {}
