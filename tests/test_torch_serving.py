"""The port's continuous-batching server on the CPU against the JAX
package's, on the small stack of ``tests/test_serving.py`` (depth 2,
patch_nums (1, 2, 3), 48px): completion, determinism across batch
composition, error payloads, the pixel-decoder dispatch, calibrated W8A8
sites, the W8A8 + INT8-KV configuration, uint8 delivery, greedy parity
with the JAX server, and speculative mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import SamplingConfig as JSamplingConfig
from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.engine import decode as JD
from sdvar_tpu.engine.serving import GenerationServer as JGenerationServer
from sdvar_tpu.models.var import init_var_params as j_init_var
from sdvar_tpu.models.vqvae import init_vqvae_params as j_init_vqvae
from sdvar_tpu_torch.config import (
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.engine import serving as S
from sdvar_tpu_torch.engine.serving import GenerationServer
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax, vqvae_params_from_jax

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
F32 = torch.float32


@pytest.fixture(scope="module")
def stack():
    """JAX-initialised weights (as ``tests/test_serving.py`` makes them),
    numpy for the JAX server and carried over by the bridge for the
    port's."""
    jv, jq = JVARConfig(**VAR_KW), JVQVAEConfig(**VAE_KW)
    key = jax.random.PRNGKey(0)
    qp = jax.tree.map(np.asarray, j_init_vqvae(jq, key))
    vp = jax.tree.map(np.asarray, j_init_var(jv, jax.random.fold_in(key, 1)))
    return (jv, jq, vp, qp, VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW),
            var_params_from_jax(vp, device="cpu"),
            vqvae_params_from_jax(qp, device="cpu"))


def _mk(stack, **kw):
    tv, tq, tvp, tqp = stack[4:]
    kw = {"samp": SamplingConfig(cfg=1.5, top_k=8), "dtype": F32,
          "buckets": [1, 2, 4], "max_batch": 4, "device": "cpu", **kw}
    params = kw.pop("var_params", tvp)
    return GenerationServer(tv, tq, params, tqp, **kw)


def _serve(srv, requests, timeout=300):
    srv.start()
    try:
        ids = [srv.submit(label=lab, seed=seed) for lab, seed in requests]
        return [srv.get(i, timeout=timeout) for i in ids]
    finally:
        srv.stop()


def test_all_requests_complete(stack):
    srv = _mk(stack)
    results = _serve(srv, [(i % 10, 100 + i) for i in range(7)])
    for r in results:
        assert r.ok and r.image.shape == (3, 48, 48) and r.image.dtype == np.float32
        assert np.isfinite(r.image).all()
        assert r.image.min() >= 0.0 and r.image.max() <= 1.0
    assert srv.stats["completed"] == 7 and "failed" not in srv.stats
    assert 0 < srv.stats["occupancy_sum"] <= srv.stats["batches"]


def test_determinism_across_batch_composition(stack):
    """At one bucket size, a request's image is the same whether it was
    batched alone or with others, in another slot; other seeds give other
    images. The decode's tokens and f_hat are bit-equal across slots; the
    CPU's f32 convolutions of the pixel decoder round by slot (measured
    7.7e-06), hence the JAX package's 1e-5."""
    solo = _serve(_mk(stack, buckets=[4], max_wait_ms=0.0), [(3, 7)])[0]
    batched = _serve(_mk(stack, buckets=[4], max_wait_ms=300.0),
                     [(5, 8), (1, 9), (3, 7)])
    assert batched[2].batch_size == solo.batch_size == 4
    np.testing.assert_allclose(solo.image, batched[2].image, rtol=1e-5, atol=1e-5)
    assert np.abs(batched[2].image - batched[0].image).max() > 1e-3


def test_error_payload_delivered(stack):
    srv = _mk(stack)

    def boom(batch):
        raise RuntimeError("synthetic failure")

    srv._run_batch = boom
    r = _serve(srv, [(0, 1)], timeout=60)[0]
    assert not r.ok and r.image is None
    assert "RuntimeError" in r.error and "synthetic failure" in r.error
    assert r.latency_s >= 0 and r.batch_size == 0
    assert srv.stats["failed"] == 1


@pytest.fixture(scope="module")
def sites(stack):
    """The port's calibration of the stack's decoder (every site at the
    48px top level) on two f_hats from the decode."""
    tv, tq, tvp, tqp = stack[4:]
    f_hats = [D.decode_all_scales(tv, tq, tvp, tqp["quant"], [1, 2, 3, 4], s,
                                  SamplingConfig(cfg=1.5, top_k=8), F32,
                                  device="cpu") for s in (40, 41)]
    out = VQ.calibrate_decoder_w8a8(tq, tqp, f_hats, alpha=0.75)
    assert len(out) == 8 and all(s is not None for s in out)
    return out


def test_pixel_decoder_dispatch(stack, sites, monkeypatch):
    """f32 server: the golden f32 decoder; bf16: the channels-last bf16
    decoder; bf16 with sites: the calibrated W8A8 decoder."""
    calls = []
    for name in ("fhat_to_img", "fhat_to_img_nhwc", "fhat_to_img_nhwc_w8a8_static"):
        real = getattr(VQ, name)
        monkeypatch.setattr(VQ, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    for kw, want in (({}, "fhat_to_img"),
                     ({"dtype": torch.bfloat16}, "fhat_to_img_nhwc"),
                     ({"dtype": torch.bfloat16, "pixel_sites": sites},
                      "fhat_to_img_nhwc_w8a8_static")):
        calls.clear()
        r = _serve(_mk(stack, **kw), [(1, 7)])[0]
        assert r.ok and r.image.min() >= 0.0 and r.image.max() <= 1.0
        assert calls == [want], (kw.keys(), calls)


def test_calibrated_sites_server(stack, sites):
    """A bf16 server with calibrated W8A8 sites: the same tokens as the
    sites-less bf16 server, pixels within the quantized decoder's error
    class of its images (mean 0.05, the JAX package's bound; measured
    about 0.004)."""
    q = _serve(_mk(stack, dtype=torch.bfloat16, pixel_sites=sites), [(3, 11)])[0]
    b = _serve(_mk(stack, dtype=torch.bfloat16), [(3, 11)])[0]
    assert q.ok and b.ok and np.isfinite(q.image).all()
    assert np.abs(q.image - b.image).mean() < 0.05
    assert not np.array_equal(q.image, b.image)


def test_w8a8_int8_kv_server(stack, sites):
    """The all-int8 configuration (W8A8 weights, INT8 KV cache, calibrated
    W8A8 pixel sites, bf16, uint8 delivery) on the CPU: each image equals
    the decode plus the static W8A8 decoder run directly on that request,
    quantized to uint8 in f32."""
    tv, tq, tvp, tqp = stack[4:]
    q8 = quantize_var_params(tvp, mode="w8a8")
    samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9)
    srv = _mk(stack, var_params=q8, samp=samp, dtype=torch.bfloat16,
              kv_mode="int8", pixel_sites=sites, deliver="u8", buckets=[4],
              max_wait_ms=300.0)
    reqs = [(2, 5), (7, 6), (4, 9)]
    results = _serve(srv, reqs)
    for (lab, seed), r in zip(reqs, results):
        assert r.ok and r.image.dtype == np.uint8 and r.image.shape == (3, 48, 48)
        f_hat = D.decode_all_scales(tv, tq, q8, tqp["quant"], [lab] * 4,
                                    [seed] * 4, samp, torch.bfloat16,
                                    kv_mode="int8", device="cpu")
        img = (VQ.fhat_to_img_nhwc_w8a8_static(tq, tqp, f_hat, sites)[0] + 1) * 0.5
        want = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8).numpy()
        np.testing.assert_array_equal(r.image, want)
    assert isinstance(srv._caches[4], S.QuantizedKVCache)


def test_u8_delivery_matches_f32(stack):
    """deliver="u8" gives the f32 image quantized in f32 (as the server
    computes it, not in f64): clip(x * 255 + 0.5, 0, 255) cast to uint8."""
    r_f = _serve(_mk(stack), [(2, 5)])[0]
    r_u = _serve(_mk(stack, deliver="u8"), [(2, 5)])[0]
    assert r_u.image.dtype == np.uint8 and r_f.image.dtype == np.float32
    x = r_f.image
    expect = np.clip(x * np.float32(255.0) + np.float32(0.5), 0, 255).astype(np.uint8)
    assert (x * np.float32(255.0)).dtype == np.float32
    np.testing.assert_array_equal(r_u.image, expect)


def test_greedy_f32_server_matches_jax(stack, monkeypatch):
    """Greedy (top_k=1) f32 servers, the port's and the JAX package's, on
    the same weights and requests: the same token ids (read where each
    server calls its decode) and images within 1e-3 (both use the golden
    f32 decoder)."""
    jv, jq, vp, qp = stack[:4]
    ids = {"jax": [], "port": []}

    def spy(real, name):
        def wrapped(*a, **kw):
            f_hat, out_ids, cache = real(*a, **{**kw, "return_ids": True})
            ids[name].append(np.asarray(out_ids))
            return f_hat, cache
        return wrapped

    monkeypatch.setattr(JD, "decode_all_scales", spy(JD.decode_all_scales, "jax"))
    monkeypatch.setattr(D, "decode_all_scales", spy(D.decode_all_scales, "port"))
    reqs = [(3, 1), (8, 2)]
    jsrv = JGenerationServer(jv, jq, vp, qp, samp=JSamplingConfig(cfg=1.5, top_k=1),
                             dtype=jnp.float32, buckets=[2], max_batch=2,
                             max_wait_ms=300.0)
    want = _serve(jsrv, reqs)
    got = _serve(_mk(stack, samp=SamplingConfig(cfg=1.5, top_k=1), buckets=[2],
                     max_batch=2, max_wait_ms=300.0), reqs)
    assert len(ids["jax"]) == len(ids["port"]) == 1
    np.testing.assert_array_equal(ids["port"][0], ids["jax"][0])
    for g, w in zip(got, want):
        assert g.ok and w.ok
        np.testing.assert_allclose(g.image, w.image, rtol=1e-3, atol=1e-3)


def test_unported_modes_and_bad_options_raise(stack, sites):
    with pytest.raises(ValueError, match="MeshConfig"):
        _mk(stack, mesh_cfg=object())
    with pytest.raises(ValueError, match="draft_params"):
        _mk(stack, draft_cfg=stack[4])
    with pytest.raises(ValueError, match="draft_params"):
        _mk(stack, spec=SpeculativeConfig())
    with pytest.raises(ValueError, match="bf16 server"):
        _mk(stack, pixel_sites=sites)  # an f32 server
    with pytest.raises(ValueError, match="deliver"):
        _mk(stack, deliver="png")
    with pytest.raises(ValueError, match="bucket"):
        _mk(stack, max_batch=8)


@pytest.fixture(scope="module")
def draft(stack):
    """Another JAX-initialised VAR of the stack's config, as the draft."""
    vp = jax.tree.map(np.asarray, j_init_var(stack[0], jax.random.PRNGKey(2)))
    return var_params_from_jax(vp, device="cpu")


def _spec(stack, draft, **kw):
    return _mk(stack, draft_cfg=stack[4], draft_params=draft,
               spec=SpeculativeConfig(gamma=2), buckets=[4],
               samp=SamplingConfig(cfg=1.5, top_k=8, top_p=0.9),
               max_wait_ms=300.0, **kw)


def test_speculative_server(stack, draft):
    """Speculative mode: every request comes back ok, each batch's images
    are the engine's own on that batch (padding slots: label 0, seed 0),
    and the spec_* counters add up over the batches."""
    srv = _spec(stack, draft)
    reqs = [(i % 10, 40 + i) for i in range(7)]
    results = _serve(srv, reqs)
    assert all(r.ok and r.image.shape == (3, 48, 48) for r in results)
    st = srv.stats
    nb = st["batches"]
    assert nb == 2 and st["completed"] == 7
    S = len(PNS)
    # every scale of every batch is accepted, by match or by force
    assert st["spec_accept_count"] == S * nb
    assert 0 <= st["spec_forced_accepts"] <= st["spec_accept_count"]
    # a drafted scale is accepted on its match or rejected (a forced
    # accept is a rejected scale taken all the same)
    assert st["spec_draft_calls"] == (st["spec_accept_count"]
                                      - st["spec_forced_accepts"]
                                      + st["spec_reject_count"])
    assert -(-S // 2) * nb <= st["spec_target_calls"] <= st["spec_draft_calls"]
    labels = [lab for lab, _ in reqs[:4]]
    seeds = [seed for _, seed in reqs[:4]]
    f_hat, _ = srv.engine.generate_speculative(labels, seeds, srv.spec, srv.samp)
    img = srv.engine.decode_image(f_hat).numpy()
    for i in range(4):
        np.testing.assert_array_equal(results[i].image, img[i])


def test_speculative_server_same_batch_same_bits(stack, draft):
    """Acceptance is batch-global, so a request's image is a function of
    its batch; the same batch submitted twice gives the same bits."""
    reqs = [(2, 5), (7, 6), (4, 9)]
    first = _serve(_spec(stack, draft, deliver="u8"), reqs)
    again = _serve(_spec(stack, draft, deliver="u8"), reqs)
    for a, b in zip(first, again):
        assert a.ok and b.ok and a.image.dtype == np.uint8
        np.testing.assert_array_equal(a.image, b.image)
