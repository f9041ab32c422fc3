"""``ops/partition.py`` and the sharded quantization math in one process:
the registry, a 1x1 mesh that keeps the unsharded paths (the counterpart
of ``tests/test_tp_pallas.py``'s one-device-mesh test), the probe kernel's
plain version against the JAX package's ``kern`` in interpret mode, and
the identities the mesh's quantized forward rests on, with the ranks'
shards computed side by side here: the max of the ranks' act-quant and KV
scales is the unsharded scale, quantizing with it gives the unsharded int8
values, and the sum of the ranks' int32 partial products is the unsharded
product. The two-process runs are in ``test_torch_mesh.py``; the probe
kernel against its plain version on the card is gpu-marked below."""

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops import partition as PT
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize_plain, act_scale_plain
from sdvar_tpu_torch.ops.kernels.scale_probe import (
    scale_probe_kernel,
    scale_probe_plain,
)
from sdvar_tpu_torch.ops.quantization import (
    _int_mm,
    as_w8a8,
    quantize_tokens,
    quantize_var_params,
    quantize_weight,
)
from sdvar_tpu_torch.parallel import mesh as MS


@pytest.fixture
def registry():
    prev = PT.get_tp_mesh()
    yield
    PT.set_tp_mesh(prev)


def test_registry(registry):
    PT.set_tp_mesh(None)
    assert PT.get_tp_mesh() is None and not PT.tp_mesh_active()
    assert PT.model_split(6) == 1
    assert PT.data_rows(6) == slice(0, 6)
    mesh = MS.single_device_mesh()
    PT.set_tp_mesh(mesh)
    assert PT.get_tp_mesh() is mesh and not PT.tp_mesh_active()
    PT.set_tp_mesh(MS.Mesh(data=2, model=1, rank=1))
    assert PT.tp_mesh_active() and PT.model_split(6) == 1
    assert PT.data_rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="not a mesh"):
        PT.set_tp_mesh(object())


def test_one_rank_mesh_keeps_unsharded_paths(registry, monkeypatch):
    """A registered 1x1 mesh is a no-op: no collective is reached, and the
    quantized decode gives the unregistered decode's bits."""
    def refuse(*a, **k):
        raise AssertionError("a collective was reached under a 1x1 mesh")

    pns = (1, 2, 3)
    vc = VARConfig(depth=2, num_classes=10, patch_nums=pns, vocab_size=64,
                   Cvae=8, head_dim=32)
    qc = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=pns)
    p = quantize_var_params(init_var_params(vc, seed=3, device="cpu"),
                            mode="w8a8")
    q = init_vqvae_params(qc, seed=4, device="cpu", eini=1.0)
    samp = SamplingConfig(cfg=1.5, top_k=4)

    def run():
        return decode_all_scales(vc, qc, p, q["quant"], [3, 7], 0, samp,
                                 torch.float32, return_ids=True,
                                 kv_mode="int8", device="cpu")

    PT.set_tp_mesh(None)
    want = run()
    monkeypatch.setattr(MS.Mesh, "all_reduce", refuse)
    monkeypatch.setattr(MS.Mesh, "all_gather", refuse)
    PT.set_tp_mesh(MS.create_mesh())
    got = run()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_probe_plain_matches_jax_kern_in_interpret_mode(registry):
    """The probe's plain version against the JAX package's ``kern``
    (``tests/test_tp_pallas.py:194-203``) run through ``pallas_call`` in
    interpret mode, bit for bit; without a mesh the sharded form is the
    plain version. (JAX is imported here, so that the gpu-marked test below
    runs where there is no JAX.)"""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    x = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    np.testing.assert_array_equal(scale_probe_plain(torch.from_numpy(x)).numpy(),
                                  want)
    PT.set_tp_mesh(None)
    np.testing.assert_array_equal(
        PT.sharded_scale_probe(torch.from_numpy(x)).numpy(), want)


def _split(x: torch.Tensor, n: int):
    return list(x.chunk(n, dim=-1))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_rows_quantize_to_the_unsharded_bits(gelu, dtype):
    """The act-quant of proj's and fc2's inputs under a model split: each
    rank's scale over its columns (the scale-only pass), the max over
    ranks, the quantizing pass with it; concatenated, the unsharded int8
    values and scales."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(5, 7, 256, generator=g) * 3).to(dtype)
    x[0, 0] = 0.0  # the scale floor
    b = torch.randn(256, generator=g).to(dtype)
    want_q, want_s = act_quantize_plain(x, b, gelu)
    torch.testing.assert_close(act_scale_plain(x, b, gelu), want_s, rtol=0,
                               atol=0)
    for n in (2, 4):
        parts = list(zip(_split(x, n), _split(b, n)))
        s = torch.stack([act_scale_plain(xp, bp, gelu)
                         for xp, bp in parts]).amax(0)
        q = torch.cat([act_quantize_plain(xp, bp, gelu, scale=s)[0]
                       for xp, bp in parts], -1)
        torch.testing.assert_close(s, want_s, rtol=0, atol=0)
        torch.testing.assert_close(q, want_q, rtol=0, atol=0)


def test_split_heads_kv_scales_are_the_unsharded_bits():
    """The INT8 KV quantization under a model split, as ``quantize_tokens``
    does it with ``sharded=True``: the max of the ranks' amax before the
    division."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 9, 128, generator=g) * 2).to(torch.bfloat16)
    want_q, want_s = quantize_tokens(x)
    parts = _split(x.float(), 2)
    amax = torch.stack([p.abs().amax(-1) for p in parts]).amax(0)
    s = torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    q = torch.cat([torch.clamp(torch.round(p / s[..., None]), -127, 127)
                   .to(torch.int8) for p in parts], -1)
    torch.testing.assert_close(q, want_q, rtol=0, atol=0)


def test_row_split_int32_partials_sum_to_the_unsharded_product():
    g = torch.Generator().manual_seed(2)
    xq = torch.randint(-127, 128, (24, 192), generator=g, dtype=torch.int8)
    w = quantize_weight(torch.randn(192, 64, generator=g))
    qw = as_w8a8(*w)
    want = _int_mm(xq, qw.q)
    got = sum(_int_mm(xp, as_w8a8(wp, w.scale).q)
              for xp, wp in zip(xq.chunk(2, -1), w.q.chunk(2, 0)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_probe_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.randn(8, 512, device="cuda")
    n = scale_probe_kernel.launches
    got = scale_probe_kernel(x)
    assert scale_probe_kernel.launches == n + 1
    assert torch.equal(got, scale_probe_plain(x))
    shard = x[:, 256:]  # a column shard: strided, packed by the wrapper
    assert torch.equal(scale_probe_kernel(shard), scale_probe_plain(shard))
