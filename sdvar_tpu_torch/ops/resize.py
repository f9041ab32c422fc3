"""PyTorch-parity separable image resizing as dense matmuls.

A copy of ``sdvar_tpu/ops/resize.py``: every (in_size, out_size) pair is
static and tiny, so the exact interpolation weights are built with numpy as
a dense (out x in) matrix (bicubic: cubic convolution with A=-0.75,
half-pixel source mapping, border clamping; area: adaptive-average-pool
bins) and the 2-D resize is two f32 einsums over the trailing dims. The
matrices are the ones ``tests/test_resize.py`` pins for the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "bicubic_resize",
    "area_resize",
    "bicubic_weight_matrix",
    "area_weight_matrix",
]


def _cubic_conv1(x, A: float):
    # |x| <= 1 branch of the cubic convolution kernel (Keys 1981), A = -0.75.
    return ((A + 2) * x - (A + 3)) * x * x + 1


def _cubic_conv2(x, A: float):
    # 1 < |x| < 2 branch.
    return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A


@functools.lru_cache(maxsize=None)
def bicubic_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float64 matrix W with out = W @ in, equal to
    ``F.interpolate(mode='bicubic', align_corners=False)`` along one axis."""
    A = -0.75
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float64)
    scale = in_size / out_size
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        t = src - base
        w = np.array(
            [
                _cubic_conv2(t + 1.0, A),
                _cubic_conv1(t, A),
                _cubic_conv1(1.0 - t, A),
                _cubic_conv2(2.0 - t, A),
            ]
        )
        for tap in range(4):
            j = min(max(base - 1 + tap, 0), in_size - 1)
            W[i, j] += w[tap]
    return W


@functools.lru_cache(maxsize=None)
def area_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float64 matrix equal to
    ``F.interpolate(mode='area')`` along one axis: output bin i averages
    input cells [floor(i*n/m), ceil((i+1)*n/m))."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float64)
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        W[i, start:end] = 1.0 / (end - start)
    return W


@functools.lru_cache(maxsize=None)
def _weights_on(kind: str, in_size: int, out_size: int,
                device: torch.device) -> torch.Tensor:
    """The matrix on ``device``, made once; made outside inference mode
    even when a decode asks first, so that a training forward (VQVAE
    training's resizes) can save it for its backward."""
    fn = bicubic_weight_matrix if kind == "bicubic" else area_weight_matrix
    with torch.inference_mode(False):
        return torch.as_tensor(fn(in_size, out_size), dtype=torch.float32,
                               device=device)


def _apply_separable(x: torch.Tensor, kind: str, out_hw) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w): two f32 einsums (the weights feed
    the codebook argmin downstream, so no reduced-precision matmul)."""
    Wh = _weights_on(kind, x.shape[-2], out_hw[0], x.device)
    Ww = _weights_on(kind, x.shape[-1], out_hw[1], x.device)
    y = torch.einsum("...hw,vw->...hv", x.float(), Ww)
    y = torch.einsum("uh,...hv->...uv", Wh, y)
    return y.to(x.dtype)


def bicubic_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize of (..., H, W) to (..., out_h, out_w), torch-parity."""
    return _apply_separable(x, "bicubic", out_hw)


def area_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Area (adaptive-average) resize of (..., H, W), torch-parity."""
    return _apply_separable(x, "area", out_hw)
