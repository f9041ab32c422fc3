"""INT8 weights (weight-only "w8" and W8A8), float8 e4m3 weights ("fp8")
and the INT8 KV cache (the counterpart of ``sdvar_tpu/ops/quantization.py``).

Scheme, as in the JAX package:
  - weights: symmetric per-output-channel int8, w ~ q * s with q int8
    (in, out) and s f32 (out,), stacked on a leading ``depth`` axis for the
    block weights. ``QuantizedLinear`` leaves multiply bf16/f32 activations
    by the int8 weights (``int8_matmul``, the CUDA kernel on the card);
    ``W8A8Linear`` leaves also quantize the activation per token and run an
    exact s8 x s8 -> s32 product.
  - fp8: symmetric per-output-channel float8_e4m3fn, amax mapped to
    ``FP8_MAX`` (``FP8Linear``); its matmuls dequantize the weight to the
    compute dtype and run ``torch.matmul``, as the JAX package's einsum
    does (no Pallas kernel sits behind it there).
  - KV cache: symmetric per-token int8 (amax over the whole merged C of a
    written token), dequantized inside the attention kernel.

Two choices differ from the JAX package, where they are TPU tuning
(``set_fused_act_quant``, ``fused_act_quant_enabled``, ``MIN_FUSED_ROWS``
and ``quantize.eligible`` stay behind):
  - ``_ffn`` with a ``W8A8Linear`` fc2 always takes the fused route: fc1,
    then bias + GELU + per-token quantization in one pass
    (``ops/kernels/quantize.act_quantize``), then the s32 product.
  - ``quantize_activation`` on a CUDA tensor is the same kernel with
    ``gelu=False`` and no bias, which computes exactly this module's
    function (floor 1e-8, no clip) in one launch instead of the plain
    version's five or six elementwise ones.
A CUDA tensor always takes the kernel and a CPU tensor the plain version.

The s8 x s8 -> s32 GEMMs are an XLA ``dot_general`` in the JAX package, not
a Pallas kernel, so on the card they go to ``torch._int_mm`` as a plain
large matmul goes to ``torch.matmul``; on the CPU the product is exact
integer arithmetic as well. Integer accumulation is exact, so the port is
at least as tight as JAX's ``w8a8_matmul``, which accumulates int8-as-bf16
in f32 and rounds once K * 127^2 > 2^24.

"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.ops.kernels.matmul_int8 import int8_matmul_blc
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize, act_scale
from sdvar_tpu_torch.ops.partition import (
    data_rows,
    model_split,
    reduce_from_model,
    reduce_model,
)
from sdvar_tpu_torch.utils.device import resolve_device


class QuantizedLinear(NamedTuple):
    """int8 weight (in, out) or (depth, in, out) and f32 scale (out,) or
    (depth, out); matmuls keep the activation's dtype."""

    q: torch.Tensor
    scale: torch.Tensor


class W8A8Linear(NamedTuple):
    """Same fields as ``QuantizedLinear``; its matmuls also quantize the
    activation per token (dynamic symmetric W8A8). ``q`` keeps the (in, out)
    shape but is stored K-major, the layout the int8 tensor core GEMM behind
    ``torch._int_mm`` takes: build it with ``as_w8a8``, which decides that
    layout in one place (``_int_mm`` raises on any other)."""

    q: torch.Tensor
    scale: torch.Tensor


class FP8Linear(NamedTuple):
    """float8_e4m3fn weight (in, out) or (depth, in, out) and f32 scale
    (out,) or (depth, out); matmuls run in the activation's dtype on the
    dequantized weight."""

    q: torch.Tensor
    scale: torch.Tensor


FP8_MAX = 448.0  # the largest finite e4m3 value

QUANTIZED = (QuantizedLinear, W8A8Linear, FP8Linear)

WEIGHT_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w", "ada_lin_w")
# weights whose matmuls take the W8A8 path in "w8a8" mode: ada_lin_w (tiny,
# used once per generation) and the logits head (gated by ``act_head``)
# stay weight-only
W8A8_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def _on(t: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim tensor of t's dtype on t's device. Dividing by
    it gives the IEEE quotient on either device: on a CUDA tensor PyTorch
    turns division by a host number into a product with its reciprocal,
    whose last bit can differ, and a value of exactly amax / 2 (a rounding
    tie, common in bf16 data) then rounds the other way."""
    return t.new_full((), value)


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QuantizedLinear:
    """Symmetric per-output-channel int8: amax over the INPUT axis, round
    half to even, clip at +-127."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = (amax / _on(amax, 127.0)).float()
    q = torch.clamp(torch.round(w / torch.clamp(scale, min=1e-12)), -127, 127)
    return QuantizedLinear(q.to(torch.int8), scale.squeeze(axis))


def quantize_weight_fp8(w: torch.Tensor, axis: int = -2) -> FP8Linear:
    """Symmetric per-output-channel e4m3: amax over the INPUT axis maps to
    ``FP8_MAX``, round to nearest even. The scale is computed in the
    weight's dtype (a bf16 division for a bf16 weight), then widened to
    f32, and the division by it promotes to f32, as in the JAX package."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = (amax / _on(amax, FP8_MAX)).float()
    q = (w / torch.clamp(scale, min=1e-12)).to(torch.float8_e4m3fn)
    return FP8Linear(q, scale.squeeze(axis))


def k_major(q: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values stored with K contiguous."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def as_w8a8(q: torch.Tensor, scale: torch.Tensor) -> W8A8Linear:
    """The one constructor of ``W8A8Linear`` leaves: q stored K-major."""
    return W8A8Linear(k_major(q), scale)


def dequantize_weight(qw, dtype=torch.bfloat16) -> torch.Tensor:
    """q * s in f32, cast to ``dtype``."""
    return (qw.q.float() * qw.scale.unsqueeze(-2)).to(dtype)


def quantize_var_params(params: Dict, keys: Tuple[str, ...] = WEIGHT_KEYS,
                        quantize_head: Optional[bool] = None,
                        mode: str = "w8", act_head: bool = False) -> Dict:
    """A parameter tree whose big block matmul weights (and the head, per
    ``quantize_head``) are quantized leaves; embeddings and norm-side
    parameters stay as they are. ``mode``: "w8" (``QuantizedLinear``,
    activations stay bf16), "w8a8" (``W8A8Linear`` for ``W8A8_KEYS``, and
    for the head when ``act_head``) or "fp8" (``FP8Linear``).
    ``quantize_head`` None means per mode, as in the JAX package: the int8
    modes quantize the head, fp8 keeps it as it is (e4m3's 3-bit mantissa
    right before sampling flips argmaxes)."""
    if mode not in ("w8", "w8a8", "fp8"):
        raise ValueError(f"unknown mode {mode!r} (w8 | w8a8 | fp8)")
    if quantize_head is None:
        quantize_head = mode != "fp8"
    qfn = quantize_weight_fp8 if mode == "fp8" else quantize_weight
    out = dict(params)
    blocks = dict(params["blocks"])
    for k in keys:
        if k in blocks:
            qw = qfn(blocks[k], axis=-2)
            if mode == "w8a8" and k in W8A8_KEYS:
                qw = as_w8a8(*qw)
            blocks[k] = qw
    out["blocks"] = blocks
    if quantize_head:
        hw = qfn(params["head"]["w"], axis=-2)
        if mode == "w8a8" and act_head:
            hw = as_w8a8(*hw)
        out["head"] = {"w": hw, "b": params["head"]["b"]}
    return out


def layer_slice(w, li: int):
    """Layer ``li`` of a depth-stacked weight, quantized or not."""
    if isinstance(w, QUANTIZED):
        return type(w)(w.q[li], w.scale[li])
    return w[li]


def resolve_weight(w, dtype) -> torch.Tensor:
    """Quantized leaf -> dequantized matrix; plain tensors pass through."""
    if isinstance(w, QUANTIZED):
        return dequantize_weight(w, dtype)
    return w.to(dtype)


def quantize_activation(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        gelu: bool = False, sharded: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8: (..., K) -> (int8 values, f32
    (..., 1) scales), scale max(amax / 127, 1e-8); |x| / scale <= 127 by
    construction, so no clip. ``bias`` and ``gelu`` are applied first, in
    the same pass (the fused route of ``models.var._ffn``).

    ``sharded``: x holds this rank's columns of each row, split over
    "model". The scale is then the whole row's: a scale-only pass gives
    the rank's scales, they are all-reduced (max), and the quantizing pass
    divides by them. Division by 127 is monotone and the floor commutes
    with the max, so that is the unsharded scale, and the int8 values are
    the unsharded ones."""
    if not sharded:
        return act_quantize(x, bias, gelu=gelu)
    xs = reduce_model(act_scale(x, bias, gelu=gelu), "max")
    return act_quantize(x, bias, gelu=gelu, scale=xs)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ int8 (K, N) -> int32 (M, N). On the card through
    ``torch._int_mm`` with a row-major and b K-major, the layout its int8
    tensor-core GEMMs take (on the H100 a row-major b is refused at some
    small shapes, for example M=24, K=64, N=192); a b in any other layout
    raises, on either device, since ``as_w8a8`` builds every weight so.
    ``_int_mm`` takes M > 16 and K, N multiples of 8: fewer rows are padded
    with zeros and sliced off again."""
    M, K = a.shape
    N = b.shape[1]
    if N > 1 and (b.stride(0) != 1 or b.stride(1) != K):
        raise ValueError(f"_int_mm: b {tuple(b.shape)} with strides "
                         f"{b.stride()} is not K-major (build it with as_w8a8)")
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    if K % 8 or N % 8:
        raise ValueError(f"_int_mm: K={K} and N={N} must be multiples of 8")
    if M <= 16:
        a = torch.cat([a, a.new_zeros((32 - M, K))])
    return torch._int_mm(a.contiguous(), b)[:M]


def w8a8_prequant_matmul(xq: torch.Tensor, xs: torch.Tensor, qw: W8A8Linear,
                         dtype, sharded: bool = False) -> torch.Tensor:
    """int8 (..., K) rows + (..., 1) f32 scales @ int8 (K, N): exact s32
    sum, then ``acc * x_scale * w_scale`` in f32, cast to ``dtype`` (the
    int32 sum converts to f32 inside the first product). ``sharded``: K is
    split over "model" (this rank's rows of the weight); the int32 partial
    sums are all-reduced before the epilogue, so the sum stays exact and
    the result is the unsharded bits."""
    K = xq.shape[-1]
    acc = _int_mm(xq.reshape(-1, K), qw.q).view(*xq.shape[:-1], -1)
    if sharded:
        acc = reduce_model(acc)
    return (acc * xs).mul_(qw.scale).to(dtype)


def w8a8_matmul(x_blc: torch.Tensor, qw: W8A8Linear, dtype) -> torch.Tensor:
    """(..., K) @ int8 (K, N) with per-token activation quantization."""
    xq, xs = quantize_activation(x_blc)
    return w8a8_prequant_matmul(xq, xs, qw, dtype)


def linear_blc(x_blc: torch.Tensor, w, dtype) -> torch.Tensor:
    """(..., K) @ w -> (..., N) in ``dtype``: ``W8A8Linear`` through the
    quantized-activation product, ``QuantizedLinear`` through the
    INT8-weight matmul, an ``FP8Linear`` dequantized to ``dtype`` and a
    plain weight through ``torch.matmul`` (bf16 products accumulate in
    f32)."""
    if isinstance(w, W8A8Linear):
        return w8a8_matmul(x_blc, w, dtype)
    if isinstance(w, QuantizedLinear):
        return int8_matmul_blc(x_blc.to(dtype), w.q, w.scale)
    return torch.matmul(x_blc.to(dtype), resolve_weight(w, dtype))


def linear_rows(x_blc: torch.Tensor, w, dtype, split: int) -> torch.Tensor:
    """``linear_blc`` for a weight whose input rows split over "model"
    (proj, fc2): x holds this rank's columns. Each rank's partial product
    is summed over the model ranks: a ``W8A8Linear`` sums its exact int32
    partials before the scale epilogue (the unsharded bits), any other
    weight its partials in ``dtype`` (with a gradient in training:
    ``reduce_from_model``). ``split``: the ranks that split the rows
    (``model_split(width)``); with 1, ``linear_blc``."""
    if split == 1:
        return linear_blc(x_blc, w, dtype)
    if isinstance(w, W8A8Linear):
        xq, xs = quantize_activation(x_blc, sharded=True)
        return w8a8_prequant_matmul(xq, xs, w, dtype, sharded=True)
    return reduce_from_model(linear_blc(x_blc, w, dtype),
                             x_blc.shape[-1] * split)


# ---------------------------------------------------------------------------
# INT8 KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedKVCache:
    """INT8 KV cache with per-token scales, batch-major like ``KVCache``.

    k, v:     int8 (depth, B, L_max, C)
    k_s, v_s: f32 (depth, B, L_max), the JAX package's scale layout

    Written in place at [layer, :, begin:end); attention reads one layer's
    [0, kv_len) values and scales as strided views, so nothing is copied.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_s: torch.Tensor
    v_s: torch.Tensor

    @staticmethod
    def create(cfg: VARConfig, batch: int, max_len: Optional[int] = None,
               device="cuda") -> "QuantizedKVCache":
        """``batch`` rows of the whole batch; under a mesh, this rank's
        part (``local_kv_shape``)."""
        dev = resolve_device(device)
        L = max_len or cfg.L
        rows, C = local_kv_shape(cfg, batch)
        vals = (cfg.depth, rows, L, C)
        return QuantizedKVCache(
            k=torch.zeros(vals, dtype=torch.int8, device=dev),
            v=torch.zeros(vals, dtype=torch.int8, device=dev),
            k_s=torch.ones(vals[:3], dtype=torch.float32, device=dev),
            v_s=torch.ones(vals[:3], dtype=torch.float32, device=dev),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def local_kv_shape(cfg: VARConfig, batch: int) -> Tuple[int, int]:
    """(rows, merged head width) of this rank's KV cache for a batch of
    ``batch`` rows: rows over "data", heads over "model" where they divide
    (the whole cache without a mesh)."""
    rows = data_rows(batch, "KV cache batch")
    tp = model_split(cfg.num_heads)  # 1: the heads stay whole on each rank
    return rows.stop - rows.start, cfg.num_heads // tp * cfg.head_dim


def quantize_tokens(x: torch.Tensor, sharded: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C) -> int8 values + (...) f32 per-token scales (amax over C,
    floor 1e-12, clip at +-127). ``sharded``: x holds this rank's heads of
    each token, split over "model"; the amax is all-reduced (max) over the
    model ranks before the division, so scales and values are the
    unsharded ones."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    if sharded:
        amax = reduce_model(amax, "max")
    scale = torch.clamp(amax / _on(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_tokens(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)
