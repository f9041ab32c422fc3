"""The port's INT8 3x3 convolution (plain version, the CPU path) and its host
side against the JAX package's ``ops/pallas/conv_s8.py`` (Pallas kernel in
interpret mode) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdvar_tpu.ops.pallas import conv_s8 as JCS8
from sdvar_tpu.ops.partition import get_tp_mesh, set_pallas_interpret, set_tp_mesh
from sdvar_tpu_torch.ops import conv_s8 as CS8
from sdvar_tpu_torch.ops.kernels.conv_s8 import conv3x3_s8_kernel, conv3x3_s8_plain

SHAPES = [(2, 16, 32, 8, 12), (1, 8, 64, 4, 4), (2, 24, 32, 12, 8),
          (1, 16, 32, 160, 3)]


def _ints(shape, rng):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (int16) as ordered integers: adjacent values
    differ by 1."""
    u = bits.astype(np.int32)
    return np.where(u < 0, -(u & 0x7FFF), u)


def _int_conv(x8, w8):
    """Exact integer 'same' convolution, NHWC x HWIO, in int64."""
    B, H, W, _ = x8.shape
    xp = np.pad(x8.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    return sum(np.einsum("bhwc,co->bhwo", xp[:, dy:dy + H, dx:dx + W],
                         w8[dy, dx].astype(np.int64))
               for dy in range(3) for dx in range(3))


@pytest.mark.parametrize("B,H,W,C,O", SHAPES)
def test_plain_matches_pallas_kernel(B, H, W, C, O):
    """f32: the port rounds ``acc * scale`` and ``+ bias`` separately (the
    CUDA kernel's epilogue, bit for bit); the interpreted Pallas kernel runs
    on XLA:CPU, which contracts the two into one FMA. So the two agree
    within rtol 1e-6 plus one rounding of the product (2^-23 of
    |acc * scale|, which shows where the sum cancels). bf16: bit-equal or
    one ulp apart."""
    rng = np.random.default_rng(B * H + W + C)
    x8, w8 = _ints((B, H, W, C), rng), _ints((3, 3, C, O), rng)
    scale = rng.uniform(5e-4, 2e-3, O).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    prod = _int_conv(x8, w8).astype(np.float32) * scale
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JCS8.conv3x3_s8(x8, w8, scale, bias, interpret=True,
                                          out_dtype=jdt))
        got = CS8.conv3x3_s8(torch.from_numpy(x8), torch.from_numpy(w8),
                             torch.from_numpy(scale), torch.from_numpy(bias),
                             out_dtype=tdt)
        assert tuple(got.shape) == (B, H, W, O) and got.dtype == tdt
        if tdt == torch.float32:
            np.testing.assert_array_equal(got.numpy(), prod + bias)
            lim = 1e-6 * np.abs(want) + 2.0 ** -23 * np.abs(prod)
            assert (np.abs(got.numpy() - want) <= lim).all()
        else:
            ulps = np.abs(_ordered(got.view(torch.int16).numpy())
                          - _ordered(want.view(np.int16)))
            assert ulps.max() <= 1, ulps.max()


@pytest.mark.parametrize("B,H,W,C,O", SHAPES)
def test_integer_sums_exact(B, H, W, C, O):
    """scale 1, bias 0: the f32 outputs are the exact s32 sums, equal to the
    Pallas kernel's and to a numpy integer convolution."""
    rng = np.random.default_rng(C * O)
    x8, w8 = _ints((B, H, W, C), rng), _ints((3, 3, C, O), rng)
    ones, zeros = np.ones(O, np.float32), np.zeros(O, np.float32)
    want = np.asarray(JCS8.conv3x3_s8(x8, w8, ones, zeros, interpret=True,
                                      out_dtype=jnp.float32))
    got = CS8.conv3x3_s8(torch.from_numpy(x8), torch.from_numpy(w8),
                         torch.from_numpy(ones), torch.from_numpy(zeros),
                         out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _int_conv(x8, w8).astype(np.float32))


def test_edges_are_zero_padded():
    """The border equals a VALID convolution of the zero-padded input."""
    rng = np.random.default_rng(7)
    B, H, W, C, O = 1, 16, 32, 4, 4
    x8, w8 = _ints((B, H, W, C), rng), _ints((3, 3, C, O), rng)
    got = conv3x3_s8_plain(torch.from_numpy(x8),
                           torch.from_numpy(w8).permute(3, 0, 1, 2).contiguous(),
                           torch.ones(O), torch.zeros(O), torch.float32)
    xp = torch.nn.functional.pad(torch.from_numpy(x8).permute(0, 3, 1, 2).double(),
                                 (1, 1, 1, 1))
    ref = torch.nn.functional.conv2d(
        xp, torch.from_numpy(w8).permute(3, 2, 0, 1).double()).permute(0, 2, 3, 1)
    assert torch.equal(got, ref.float())
    want = np.asarray(JCS8.conv3x3_s8(x8, w8, np.ones(O, np.float32),
                                      np.zeros(O, np.float32), interpret=True,
                                      out_dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,stride", [((2, 16, 32, 8), 1), ((1, 8, 64, 4), 1),
                                          ((1, 16, 32, 8), 2), ((1, 12, 32, 8), 1),
                                          ((1, 16, 30, 8), 1), ((1, 16, 16, 8), 1),
                                          ((1, 16, 32, 6), 1)])
def test_eligible_is_the_jax_predicate(shape, stride):
    assert CS8.eligible(shape, stride) == JCS8.eligible(shape, stride)


@pytest.mark.parametrize("alpha,headroom", [(0.65, 1.0), (0.75, 1.0), (0.5, 1.2)])
def test_quantize_site_bit_equal(alpha, headroom):
    rng = np.random.default_rng(3)
    C, O = 16, 12
    w = (rng.standard_normal((O, C, 3, 3)) * 0.2).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    amax = (np.logspace(-2, 0.5, C) * rng.uniform(0.5, 2, C)).astype(np.float32)
    want = JCS8.quantize_site(w, b, amax, headroom=headroom, alpha=alpha)
    got = CS8.quantize_site(torch.from_numpy(w), torch.from_numpy(b),
                            torch.from_numpy(amax), headroom=headroom, alpha=alpha)
    assert set(got) == set(CS8.SITE_KEYS) and got["wq"].dtype == np.int8
    for k in CS8.SITE_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.fixture
def interpret():
    """The JAX package's kernels in interpret mode on the CPU, with no TP
    mesh registered (another test of the worker may have left one)."""
    prev = get_tp_mesh()
    set_tp_mesh(None)
    set_pallas_interpret(True)
    try:
        yield
    finally:
        set_pallas_interpret(False)
        set_tp_mesh(prev)


def test_static_site_matches_jax(interpret):
    """Skewed per-channel activations: the same int8 activations, outputs
    within rtol 1e-6 (f32)."""
    rng = np.random.default_rng(11)
    B, H, W, C, O = 2, 16, 32, 16, 8
    x = (rng.standard_normal((B, H, W, C)) * np.logspace(-2, 0.5, C)).astype(np.float32)
    w = (rng.standard_normal((O, C, 3, 3)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(O) * 0.1).astype(np.float32)
    jsite = JCS8.quantize_site(w, b, np.abs(x).max(axis=(0, 1, 2)))
    site = CS8.site_from_arrays(CS8.quantize_site(w, b, np.abs(x).max(axis=(0, 1, 2))),
                                "cpu")
    xt = torch.from_numpy(x)
    jxq = np.clip(np.round(x * np.asarray(jsite["act_inv"])), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(CS8.quantize_static(site, xt).numpy(), jxq)
    want = np.asarray(JCS8.conv3x3_s8_static(jsite, jnp.asarray(x), interpret=True))
    got = CS8.conv3x3_s8_static(site, xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_dynamic_w8a8_matches_jax():
    rng = np.random.default_rng(3)
    B, H, W, C, O = 1, 16, 32, 8, 8
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    p = {"w": (rng.standard_normal((O, C, 3, 3)) * 0.2).astype(np.float32),
         "b": (rng.standard_normal(O) * 0.1).astype(np.float32)}
    want = np.asarray(JCS8.conv2d_nhwc_w8a8(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), interpret=True))
    got = CS8.conv2d_nhwc_w8a8({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    x8 = torch.zeros(1, 8, 32, 4, dtype=torch.int8)
    wk = torch.zeros(4, 3, 3, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_s8_kernel(x8, wk, torch.ones(4), torch.zeros(4))
