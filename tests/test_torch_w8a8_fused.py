"""The fused W8A8 matmul's plain version (the CPU path of
``ops/kernels/w8a8_fused``) against the JAX package: bit-equal to its
``quantize_activation`` + ``w8a8_prequant_matmul``, and held against the TPU
kernel itself, ``tools/microbench_int8_matmul.py:_pallas_w8a8``, run in
interpret mode; the wrapper's checks. Inputs are made with numpy from a
seed and handed to both."""

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sdvar_tpu.ops import quantization as JQ
from sdvar_tpu_torch.ops.kernels.w8a8_fused import w8a8_fused, w8a8_fused_plain
from sdvar_tpu_torch.ops.quantization import as_w8a8, k_major

MICROBENCH = Path(__file__).resolve().parents[1] / "tools" / "microbench_int8_matmul.py"


def _operands(shape, N, seed):
    """x (..., K) normal * 3, int8 weights uniform in [-127, 127] and
    per-column scales in [1e-3, 1e-2), as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    wq = rng.integers(-127, 128, (shape[-1], N)).astype(np.int8)
    ws = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    return x, wq, ws


@pytest.fixture(scope="module")
def pallas_w8a8():
    """``_pallas_w8a8`` loaded from the tool by file path, its
    ``pl.pallas_call`` run in interpret mode. Importing the tool sets
    ``jax_compilation_cache_dir`` and puts the repository on ``sys.path``;
    both come back afterwards."""
    saved_dir, saved_path = jax.config.jax_compilation_cache_dir, list(sys.path)
    spec = importlib.util.spec_from_file_location("_microbench_int8_jax", MICROBENCH)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        sys.path[:] = saved_path
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield mod._pallas_w8a8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bit_equal_to_jax_prequant(dtype):
    """s8: JAX's per-token quantization, exact int32 dot and ``acc * xs *
    ws`` in bf16, bit for bit, at a K where an f32 sum of the int products
    would round (K * 127^2 > 2^24); an all-zero token takes the 1e-8
    floor."""
    x, wq, ws = _operands((2, 9, 1152), 80, 1)
    x[0, 0] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    xq, xs = JQ.quantize_activation(jx)
    want = JQ.w8a8_prequant_matmul(xq, xs, JQ.W8A8Linear(jnp.asarray(wq),
                                                         jnp.asarray(ws)),
                                   jnp.bfloat16)
    got = w8a8_fused_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                           k_major(torch.from_numpy(wq)), torch.from_numpy(ws))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 80)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("s8", [True, False])
@pytest.mark.parametrize("shape,N", [((2, 32, 256), 512), ((3, 40, 512), 384)])
def test_plain_matches_pallas_interpret(pallas_w8a8, s8, shape, N):
    """Against the TPU kernel in interpret mode, bf16 x as the tool feeds
    it: at most 3% of the outputs differ and by at most 1% of max|y|. The
    interpret-mode kernel rounds a few ``x / xs`` quotients the other way
    (measured: 1.5-1.7% of the elements, max |d| 0.25 at max |y| 79 and
    0.5 at 115.5), and each such step moves an output by about
    ``xs * wq * ws``."""
    x, wq, ws = _operands(shape, N, 2)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(pallas_w8a8(jx, jnp.asarray(wq), jnp.asarray(ws), s8=s8)
                      ).astype(np.float32)
    got = w8a8_fused(torch.from_numpy(x).to(torch.bfloat16),
                     as_w8a8(torch.from_numpy(wq), torch.from_numpy(ws)).q,
                     torch.from_numpy(ws), s8=s8).float().numpy()
    assert got.shape == want.shape == shape[:-1] + (N,)
    d = np.abs(got - want)
    assert (d != 0).mean() <= 0.03
    assert d.max() <= 0.01 * np.abs(want).max()


def test_bf16_form_equals_s8_below_2_24():
    """Where no partial sum reaches 2^24 the f32 sum of the int-valued
    operands is exact, so the two forms give the same bits."""
    x, wq, ws = _operands((4, 16, 64), 48, 3)
    tx, tq, ts = (torch.from_numpy(x), k_major(torch.from_numpy(wq)),
                  torch.from_numpy(ws))
    torch.testing.assert_close(w8a8_fused(tx, tq, ts, s8=False),
                               w8a8_fused(tx, tq, ts, s8=True), rtol=0, atol=0)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    """A row-major wq, K off the MMA depth (32 for s8, 16 for the bf16
    form), N off 8, a non-f32 scale: each raises, on the CPU too."""
    x, wq, ws = _operands((2, 8, 96), 64, 4)
    tx, ts = torch.from_numpy(x), torch.from_numpy(ws)
    with pytest.raises(ValueError, match="K-major"):
        w8a8_fused(tx, torch.from_numpy(wq), ts)
    with pytest.raises(ValueError, match="multiple of 32"):
        w8a8_fused(tx[..., :48], k_major(torch.from_numpy(wq[:48])), ts)
    w8a8_fused(tx[..., :48], k_major(torch.from_numpy(wq[:48])), ts, s8=False)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8_fused(tx[..., :40], k_major(torch.from_numpy(wq[:40])), ts, s8=False)
    with pytest.raises(ValueError, match="of 8"):
        w8a8_fused(tx, k_major(torch.from_numpy(wq[:, :60])), ts[:60])
    with pytest.raises(ValueError, match="float32"):
        w8a8_fused(tx, k_major(torch.from_numpy(wq)), ts.double())
