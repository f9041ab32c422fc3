"""Port pixel decoders against the JAX package's on tiny VQVAEs, through the
weight bridge: the f32 golden NCHW decoder, the channels-last decoders in
bf16 and f32, and the W8A8 decoders with their sites."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import vqvae as JVQ
from sdvar_tpu.ops.partition import get_tp_mesh, set_pallas_interpret, set_tp_mesh
from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.utils.from_jax import pixel_sites_from_jax, vqvae_params_from_jax

KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))


def _perturb_norms(tree, rng):
    """GroupNorm gains/biases away from ones/zeros, so the affine is tested."""
    if isinstance(tree, dict):
        if set(tree) == {"g", "b"}:
            tree["g"] = tree["g"] + rng.standard_normal(tree["g"].shape).astype(np.float32) * 0.1
            tree["b"] = tree["b"] + rng.standard_normal(tree["b"].shape).astype(np.float32) * 0.1
        for v in tree.values():
            _perturb_norms(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _perturb_norms(v, rng)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def test_fhat_to_img_matches_jax():
    """Weights made by the port's initialiser go to JAX as numpy arrays and
    come back through the bridge; both decoders run them in f32."""
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    p = _numpy_tree(VQ.init_vqvae_params(tcfg, seed=3, device="cpu"))
    _perturb_norms(p, np.random.default_rng(0))
    tp = vqvae_params_from_jax(p, device="cpu")
    f_hat = np.random.default_rng(1).standard_normal((2, 8, 3, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JVQ.fhat_to_img, static_argnums=0)(jcfg, p, f_hat))
    got = VQ.fhat_to_img(tcfg, tp, torch.from_numpy(f_hat)).numpy()
    assert got.shape == (2, 3, 48, 48)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_port_init_matches_jax_tree():
    """The port's initialiser builds the JAX package's tree (same keys and
    shapes, from ``jax.eval_shape`` of its initialiser) with its
    distributions: uniform convs in +/- 1/sqrt(fan_in), GroupNorm ones and
    zeros."""
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    shapes = jax.eval_shape(lambda k: JVQ.init_vqvae_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tp = VQ.init_vqvae_params(tcfg, seed=0, device="cpu")

    def walk(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            assert isinstance(b, list) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert tuple(b.shape) == a.shape, path

    walk(shapes, tp, ())
    conv = tp["decoder"]["mid"]["block_1"]["conv1"]
    lim = 1 / np.sqrt(conv["w"].shape[1] * 9)
    assert conv["w"].abs().max() <= lim and conv["w"].std() > 0.5 * lim
    assert bool((tp["decoder"]["norm_out"]["g"] == 1).all())
    assert not tp["decoder"]["norm_out"]["b"].any()


# ---------------------------------------------------------------------------
# channels-last decoders and the W8A8 sites
# ---------------------------------------------------------------------------

# the JAX package's W8A8 decoder test config: decoder widths 32 and 64, so
# sites at two widths and a mixed None pattern under min_w=64
SITE_KW = dict(ch=32, ch_mult=(1, 2), z_channels=8, num_res_blocks=1,
               patch_nums=(1, 2, 4), quant_conv_ks=3, using_sa=False)


@pytest.fixture(scope="module")
def nhwc_stack():
    jcfg, tcfg = JVQVAEConfig(**KW), VQVAEConfig(**KW)
    p = _numpy_tree(VQ.init_vqvae_params(tcfg, seed=3, device="cpu"))
    _perturb_norms(p, np.random.default_rng(0))
    f_hat = np.random.default_rng(1).standard_normal((2, 8, 3, 3)).astype(np.float32)
    gold = np.asarray(jax.jit(JVQ.fhat_to_img, static_argnums=0)(jcfg, p, f_hat))
    return jcfg, tcfg, p, vqvae_params_from_jax(p, device="cpu"), f_hat, gold


def test_fhat_to_img_nhwc_f32_matches_jax(nhwc_stack):
    """f32 channels-last against JAX's (and the golden NCHW decoder): the
    same function up to the order of f32 sums, max |d| <= 2e-4."""
    jcfg, tcfg, p, tp, f_hat, gold = nhwc_stack
    want = np.asarray(JVQ.fhat_to_img_nhwc(jcfg, p, f_hat, dtype=jnp.float32))
    got = VQ.fhat_to_img_nhwc(tcfg, tp, torch.from_numpy(f_hat), dtype=torch.float32)
    assert got.shape == (2, 3, 48, 48) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert np.abs(got.numpy() - want).max() <= 2e-4
    assert np.abs(got.numpy() - gold).max() <= 2e-4


def test_fhat_to_img_nhwc_bf16_matches_jax(nhwc_stack):
    """bf16 channels-last against JAX's. Both round every conv and norm to
    bf16, at other places, and each lies as far from the golden decoder as
    the other (measured: port 0.0150 mean / 0.183 max, JAX 0.0160 / 0.147),
    so they differ from each other by about sqrt(2) of that (measured
    0.0187 / 0.178; GroupNorm gains perturbed, the worst case). Held to the
    JAX package's own bf16 bound against the golden decoder, mean 0.02 and
    max 0.2, both ways."""
    jcfg, tcfg, p, tp, f_hat, gold = nhwc_stack
    want = np.asarray(JVQ.fhat_to_img_nhwc(jcfg, p, f_hat))
    got = VQ.fhat_to_img_nhwc(tcfg, tp, torch.from_numpy(f_hat)).numpy()
    for ref in (want, gold):
        d = np.abs(got - ref)
        assert d.mean() <= 0.02 and d.max() <= 0.2, (d.mean(), d.max())


def test_fhat_to_img_nhwc_bf16_close_on_plain_norms(site_stack):
    """The same comparison with GroupNorm at its initial ones and zeros, where
    the bf16 noise is smaller: mean 0.01, max 0.08 (measured 0.0064 /
    0.046)."""
    jcfg, tcfg, p, tp, _, f_hat = site_stack
    want = np.asarray(JVQ.fhat_to_img_nhwc(jcfg, p, f_hat))
    got = VQ.fhat_to_img_nhwc(tcfg, tp, torch.from_numpy(f_hat)).numpy()
    d = np.abs(got - want)
    assert d.mean() <= 0.01 and d.max() <= 0.08, (d.mean(), d.max())


def test_fhat_to_img_bf16_matches_jax(nhwc_stack):
    """The NCHW bf16 decoder against JAX's and the golden one: mean 0.02
    both ways, max 0.2 against the golden decoder and 0.25 against JAX's
    (measured 0.0186 / 0.220 against JAX, 0.0154 / 0.179 against the
    golden decoder, JAX's own 0.0157 / 0.175)."""
    jcfg, tcfg, p, tp, f_hat, gold = nhwc_stack
    want = np.asarray(JVQ.fhat_to_img_bf16(jcfg, p, f_hat))
    got = VQ.fhat_to_img_bf16(tcfg, tp, torch.from_numpy(f_hat)).numpy()
    for ref, top in ((want, 0.25), (gold, 0.2)):
        d = np.abs(got - ref)
        assert d.mean() <= 0.02 and d.max() <= top, (d.mean(), d.max())


def test_d30_decoder_site_order():
    """The d30 256px decoder (default VQVAE) has 29 eligible convs, in the
    JAX package's call order by (width, input channels); min_w=256 leaves
    8 of them: the six top-level res-block convs, the level-1 upsample conv
    and conv_out. Traced on the meta device."""
    cfg = VQVAEConfig()
    p = VQ.init_vqvae_params(cfg, seed=0, device="cpu")
    meta = _map(p["decoder"], lambda t: t.to("meta"))
    shapes = []

    def count(pp, x):
        shapes.append(tuple(x.shape))

    z = torch.empty(2, 32, 16, 16, device="meta", dtype=torch.bfloat16)
    out = VQ.decoder_forward_nhwc(cfg, meta, z.to(memory_format=torch.channels_last),
                                  count)
    assert tuple(out.shape) == (2, 3, 256, 256)
    want = ([(32, 640)] * 2 + [(32, 320)] * 5 + [(64, 320)] * 7
            + [(128, 320)] * 2 + [(128, 160)] * 5 + [(256, 160)] * 8)
    assert [(s[2], s[3]) for s in shapes] == want
    assert sum(s[2] >= 256 for s in shapes) == 8


@pytest.mark.parametrize("width,calls", [(16, [1, 1, 1]), (VQ.PER_IMAGE_MAX_W, [1, 1, 1]),
                                         (2 * VQ.PER_IMAGE_MAX_W, [3])])
def test_narrow_convs_run_one_image_per_call(monkeypatch, width, calls):
    """3x3 convs up to ``PER_IMAGE_MAX_W`` wide run one cuDNN call per image,
    so an image's bits cannot depend on its slot in the batch; the result is
    the batched conv's, channels_last."""
    g = torch.Generator().manual_seed(width)
    p = {"w": torch.randn(16, 8, 3, 3, generator=g), "b": torch.randn(16, generator=g)}
    x = torch.randn(3, 8, 8, width, generator=g).to(memory_format=torch.channels_last)
    seen, conv = [], torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        lambda t, *a, **k: seen.append(t.shape[0]) or conv(t, *a, **k))
    y = VQ.conv2d_nhwc(p, x)
    assert seen == calls
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, conv(x, p["w"], p["b"], padding=1), rtol=1e-5, atol=1e-5)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@pytest.fixture(scope="module")
def site_stack():
    """The SITE_KW decoder with JAX-initialised weights, two calibration
    batches and one f_hat (latent 32x32: decoder widths 32 and 64)."""
    jcfg, tcfg = JVQVAEConfig(**SITE_KW), VQVAEConfig(**SITE_KW)
    p = jax.tree.map(np.asarray, JVQ.init_vqvae_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    cal = [(rng.standard_normal((2, 8, 32, 32)) * 0.5).astype(np.float32)
           for _ in range(2)]
    f_hat = (rng.standard_normal((1, 8, 32, 32)) * 0.5).astype(np.float32)
    return jcfg, tcfg, p, vqvae_params_from_jax(p, device="cpu"), cal, f_hat


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode on the CPU, with
    no TP mesh registered (another test of the worker may have left one)."""
    prev = get_tp_mesh()
    set_tp_mesh(None)
    set_pallas_interpret(True)
    try:
        yield
    finally:
        set_pallas_interpret(False)
        set_tp_mesh(prev)


def _pattern(sites):
    return [s is None for s in sites]


def test_jax_sites_through_the_bridge(site_stack, interpret):
    """JAX-calibrated sites, carried over by ``pixel_sites_from_jax``, land
    on the same convs of the port's decoder: the same count and None
    pattern, the same site tensors, and the port's static W8A8 decode
    within mean |d| 0.02 (the ceiling of the JAX package's own test is
    0.05) and max 0.15 of JAX's: measured 0.0154 and 0.096, where each lies
    0.0124-0.0127 from the golden decoder. The int8 sums are exact; the
    bf16 convs between the sites round at other places, and an activation
    that lands on the other side of an int8 step passes that on."""
    jcfg, tcfg, p, tp, cal, f_hat = site_stack
    jsites = JVQ.calibrate_decoder_w8a8(jcfg, p, cal, alpha=0.75, min_w=64)
    want = np.asarray(JVQ.fhat_to_img_nhwc_w8a8_static(jcfg, p, f_hat, jsites))
    jnp_sites = [None if s is None else {k: np.asarray(v) for k, v in s.items()}
                 for s in jsites]
    sites = pixel_sites_from_jax(jnp_sites, device="cpu")
    # post_quant_conv, conv_in and 8 block convs at width 32; the upsample
    # conv, 4 block convs and conv_out at width 64
    assert len(sites) == len(jsites) == 16
    assert _pattern(sites) == _pattern(jsites) == [True] * 10 + [False] * 6
    for s, js in zip(sites, jnp_sites):
        if s is not None:
            np.testing.assert_array_equal(s.wk.permute(1, 2, 3, 0).numpy(), js["wq"])
            np.testing.assert_array_equal(s.act_inv.numpy(), js["act_inv"])
    got = VQ.fhat_to_img_nhwc_w8a8_static(tcfg, tp, torch.from_numpy(f_hat),
                                          sites).numpy()
    d = np.abs(got - want)
    assert d.mean() <= 0.02 and d.max() <= 0.15, (d.mean(), d.max())


def test_port_calibration_matches_jax(site_stack, interpret):
    """The port's own calibration on the same f_hats: the same site count
    and None pattern, act_inv within 3% (measured 2.0%: the bf16
    activations it takes maxima of went through convs that round at other
    places)."""
    jcfg, tcfg, p, tp, cal, f_hat = site_stack
    jsites = JVQ.calibrate_decoder_w8a8(jcfg, p, cal, alpha=0.75, min_w=64)
    sites = VQ.calibrate_decoder_w8a8(tcfg, tp, [torch.from_numpy(c) for c in cal],
                                      alpha=0.75, min_w=64)
    assert _pattern(sites) == _pattern(jsites)
    for s, js in zip(sites, jsites):
        if s is not None:
            np.testing.assert_allclose(s.act_inv.numpy(), np.asarray(js["act_inv"]),
                                       rtol=3e-2)
            O, C = js["wq"].shape[3], js["wq"].shape[2]
            assert s.wk.shape == (O, 3, 3, C)
    img = VQ.fhat_to_img_nhwc_w8a8_static(tcfg, tp, torch.from_numpy(f_hat), sites)
    gold = np.asarray(JVQ.fhat_to_img(jcfg, p, f_hat))
    assert np.abs(img.numpy() - gold).mean() < 0.05


def test_dynamic_w8a8_decoder_matches_jax(site_stack, interpret):
    """``fhat_to_img_nhwc_w8a8`` (per-tensor dynamic activation scales)
    against JAX's: mean 0.03 and max 0.2 (measured 0.0232 / 0.148, each
    0.0205-0.0208 from the golden decoder; JAX's own test allows 0.1 there),
    and no further from the golden decoder than JAX's, within 10%."""
    jcfg, tcfg, p, tp, cal, f_hat = site_stack
    want = np.asarray(JVQ.fhat_to_img_nhwc_w8a8(jcfg, p, f_hat))
    got = VQ.fhat_to_img_nhwc_w8a8(tcfg, tp, torch.from_numpy(f_hat)).numpy()
    d = np.abs(got - want)
    assert d.mean() <= 0.03 and d.max() <= 0.2, (d.mean(), d.max())
    gold = np.asarray(JVQ.fhat_to_img(jcfg, p, f_hat))
    assert np.abs(got - gold).mean() <= 1.1 * np.abs(want - gold).mean()


def test_site_count_is_checked(site_stack):
    _, tcfg, _, tp, cal, f_hat = site_stack
    sites = VQ.calibrate_decoder_w8a8(tcfg, tp, torch.from_numpy(cal[0]))
    with pytest.raises(ValueError, match="sites given"):
        VQ.fhat_to_img_nhwc_w8a8_static(tcfg, tp, torch.from_numpy(f_hat),
                                        sites[:-1])
    with pytest.raises(ValueError, match="more eligible convs"):
        VQ.fhat_to_img_nhwc_w8a8_static(tcfg, tp, torch.from_numpy(f_hat),
                                        sites[:-1][:2])


def test_pixel_sites_bridge_refuses_other_leaves():
    site = {"wq": np.zeros((3, 3, 4, 4), np.int8), "scale": np.ones(4, np.float32),
            "bias": np.zeros(4, np.float32), "act_inv": np.ones(4, np.float32)}
    assert pixel_sites_from_jax([site, None], device="cpu")[1] is None
    with pytest.raises(TypeError, match="int8"):
        pixel_sites_from_jax([{**site, "wq": site["wq"].astype(np.float32)}], "cpu")
    with pytest.raises(TypeError, match="dict"):
        pixel_sites_from_jax([{k: v for k, v in site.items() if k != "bias"}], "cpu")
    with pytest.raises(TypeError, match="dict"):
        pixel_sites_from_jax([tuple(site.values())], "cpu")


def test_sites_see_contiguous_nhwc_activations(site_stack):
    """Every eligible conv hands its plan a contiguous (B, H, W, C) view of a
    channels_last activation, which the CUDA kernel's wrapper requires:
    no layout copy is made around a site."""
    _, tcfg, _, tp, _, f_hat = site_stack
    seen = []

    def plan(p, x):
        seen.append(x.is_contiguous())

    for dtype in (torch.bfloat16, torch.float32):
        z = torch.from_numpy(f_hat).to(dtype=dtype, memory_format=torch.channels_last)
        with torch.inference_mode():
            z = VQ.conv2d_nhwc(tp["post_quant_conv"], z, plan=plan)
            out = VQ.decoder_forward_nhwc(tcfg, tp["decoder"], z, plan)
        assert out.is_contiguous(memory_format=torch.channels_last)
    assert len(seen) == 32 and all(seen)
