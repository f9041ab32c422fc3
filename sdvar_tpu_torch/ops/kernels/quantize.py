"""Fused activation quantization: the CUDA kernel's wrapper, its launch
plan and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/quantize.py:_kernel``
(reached through ``act_quantize``). Same function, one pass over a row:

    h = x.float() + bias                                 (bias optional)
    h = 0.5 h (1 + tanh(0.7978845608028654 (h + 0.044715 h^3)))  (gelu)
    s = max(amax(|h|) / 127, 1e-8)                       per token, f32
    q = round_half_even(h / s)  as int8                  (no clip needed)

The kernel lives in ``sdvar_tpu_torch/csrc/act_quant.cu`` (CUDA C++ for
sm_90a, loaded with ctypes and bound once: the W8A8 decode launches it 1200
times, most of them at the host's pace); its source note gives the bound,
the design and the numerics: without GELU it gives the plain version's
bits (the quotient is a reciprocal product corrected to the IEEE quotient
near a rounding tie, ``exact_quotient_rint`` here); with GELU CUDA's tanhf
against PyTorch's tanh may move a q on a rounding boundary by one step (the
checks allow |dq| <= 1 on fewer than 1e-3 of the elements and scales within
1e-6 relative). ``quant_plan`` picks the launch geometry in Python: threads
a row, 16-byte loads a thread, rows a block. The TPU version's row-block
VMEM budget (``_pick_bm``) and its ``MIN_FUSED_ROWS`` gate are TPU tuning
and are not carried over.

Two more modes serve a row split over ranks (``quantize_activation(
sharded=True)`` in ``ops/quantization.py``): the scales alone, with no int8
store (``act_scale``), and the int8 values under a given scale, with no
amax (``scale=``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sdvar_tpu_torch.ops.kernels import _build


def _act_rows(x: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool
              ) -> torch.Tensor:
    """The rows the quantization sees: x in f32, plus bias, through GELU."""
    h = x.float()
    if bias is not None:
        h = h + bias.float()
    if gelu:
        h = 0.5 * h * (1.0 + torch.tanh(0.7978845608028654
                                        * (h + 0.044715 * h * h * h)))
    return h


def _row_scale(h: torch.Tensor) -> torch.Tensor:
    amax = h.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor on amax's device, not a Python number: on a CUDA
    # tensor PyTorch turns division by a host number into a product with
    # its reciprocal, whose last bit can differ from the IEEE quotient the
    # kernels take, and an element of exactly amax / 2 (a rounding tie of
    # x / s) then rounds the other way
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)


def act_quantize_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       gelu: bool = True, scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) -> (int8 (..., K), f32 (..., 1) per-token scales). A given
    ``scale`` (f32 (..., 1), at least this row's own) replaces the row's
    own: a row split over ranks quantizes with the scale of the whole row
    (``ops.quantization``'s sharded form)."""
    h = _act_rows(x, bias, gelu)
    s = _row_scale(h) if scale is None else scale
    return torch.round(h / s).to(torch.int8), s


def act_scale_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    gelu: bool = True) -> torch.Tensor:
    """The f32 (..., 1) scales of :func:`act_quantize_plain` alone."""
    return _row_scale(_act_rows(x, bias, gelu))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MIN_GROUP, MAX_GROUP = 32, 1024  # threads that hold a row
MAX_LOADS = 3  # 16-byte loads of a row a thread holds in registers
VECTOR_BYTES = 16
SMS = 132                # streaming multiprocessors of an H100 SXM
THREADS_PER_SM = 2048
# below this many threads in all (about half the card's), a launch is bound
# by its latency, and one load a thread is the shorter chain
# (tools/ab_act_quant.py, H100 SXM: up to M = 512 rows at K = 1920)
LATENCY_BOUND_THREADS = 1 << 17


@functools.lru_cache(maxsize=1024)
def quant_plan(M: int, K: int, x_dtype: torch.dtype, vector: bool = True
               ) -> dict:
    """The launch geometry of ``csrc/act_quant.cu`` for M rows of K
    elements of ``x_dtype``: ``vec`` elements a load (16 bytes' worth, or 1
    when ``vector`` is false), a row held by ``group`` threads (a power of
    two from 32 to 1024: the fewest that hold the row in at most two loads
    a thread, and 1024 for a row of more than 2048 loads; in one load a
    thread where M rows of them are at most ``LATENCY_BOUND_THREADS``),
    ``nv`` loads a thread (1 to ``MAX_LOADS``; three only past 2048 loads,
    as VAR-d36's fc2 input of 9216 f32), blocks of
    ``threads``
    (128, or the group when larger) holding ``rows_per_block`` rows at a
    time, and ``grid`` blocks: one for each ``rows_per_block`` rows, at
    most as many as the card holds at once (2048 threads an SM), each
    walking its rows ``grid`` blocks apart. Raises ValueError with the
    wrapper's message for a row the kernel cannot hold in registers (more
    than 3072 loads)."""
    if x_dtype not in _DTYPES:
        raise ValueError(f"act_quantize_kernel: x must be float32 or "
                         f"bfloat16, got {x_dtype}")
    if M <= 0 or K <= 0:
        raise ValueError(f"act_quantize_kernel: no launch for M={M} K={K}")
    vec = VECTOR_BYTES // (4 if x_dtype == torch.float32 else 2) if vector else 1
    if K % vec:
        raise ValueError(f"act_quantize_kernel: K={K} is not a multiple of "
                         f"the {vec}-element vector")
    nvec = K // vec
    if nvec > MAX_LOADS * MAX_GROUP:
        raise ValueError(f"act_quantize_kernel: K={K} exceeds the "
                         f"{MAX_LOADS * MAX_GROUP * vec} elements a row group holds "
                         f"in registers"
                         f"{'' if vector else ' one element a load'}")
    whole = max(MIN_GROUP, 1 << max(nvec - 1, 0).bit_length())
    if whole <= MAX_GROUP and M * whole <= LATENCY_BOUND_THREADS:
        group, nv = whole, 1  # few rows: the shortest chain a thread
    else:
        group = min(MAX_GROUP, max(
            MIN_GROUP, 1 << max(-(-nvec // 2) - 1, 0).bit_length()))
        nv = -(-nvec // group)
    threads = max(128, group)
    rows = threads // group
    return {"vec": vec, "group": group, "nv": nv, "threads": threads,
            "rows_per_block": rows,
            "grid": min(-(-M // rows), SMS * (THREADS_PER_SM // threads))}


def exact_quotient_rint(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``rint(fl(h / s))`` as the kernel forms it, in f32 on any device:
    ``p = fl(h * fl(1 / s))`` rounded half to even, except where p lies
    within 2^-12 of a half-integer, |p| > 128 or 1 / s is not a normal
    number: there the IEEE quotient, rounded. Equal to
    ``torch.round(h / s)``: for |p| <= 128, p is within 3 * 2^-24 * 128
    (under 2.3e-5) of the IEEE quotient, so away from a half-integer both
    round to the same integer."""
    h, s = h.float(), s.float()
    r = torch.ones_like(s) / s
    p = h * r
    t = torch.round(p)
    near = (p - t).abs() >= 0.5 - 2.0 ** -12
    careful = ~(r >= 2.0 ** -126) | ~(p.abs() <= 128.0)
    return torch.where(near | careful, torch.round(h / s), t)


_fn = None


def _lib():
    """The C entry point, bound once (no lock, no lookup a launch)."""
    global _fn
    if _fn is None:
        fn = _build.load("act_quant").sdvar_act_quantize
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_longlong, I, I, I, I,
                       I, I, I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool,
            scale: Optional[torch.Tensor], store_q: bool):
    """One launch; the host path is kept short (no reshape of a
    contiguous x, outputs allocated in their final shapes): at the
    decode's first scales the host's time per launch is the launch's
    cost."""
    if not x.is_cuda:
        raise ValueError("act_quantize_kernel: x must be a CUDA tensor")
    xd = _DTYPES.get(x.dtype)
    if xd is None or x.dim() < 1:
        raise ValueError(f"act_quantize_kernel: x must be (..., K) float32 or "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    shape = x.shape
    K = shape[-1]
    dev = x.get_device()
    if bias is not None and (bias.shape != (K,) or bias.get_device() != dev
                             or bias.stride(0) != 1 or bias.dtype not in _DTYPES):
        raise ValueError(f"act_quantize_kernel: bias must be a contiguous "
                         f"float32 or bfloat16 ({K},) on x's device")
    if x.is_contiguous():
        x2, M, xs = x, (x.numel() // K if K else 0), K
    else:
        x2 = x.reshape(-1, K)
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        M, xs = x2.shape[0], x2.stride(0)
    if scale is None:
        s = torch.empty((*shape[:-1], 1), dtype=torch.float32, device=x.device)
    else:
        if (scale.dtype != torch.float32 or scale.get_device() != dev
                or scale.numel() != M):
            raise ValueError(f"act_quantize_kernel: scale must be float32 "
                             f"(..., 1) with one value per row ({M}) on x's "
                             f"device")
        s = scale.contiguous().view(*shape[:-1], 1)
    q = torch.empty(shape, dtype=torch.int8, device=x.device) if store_q else None
    if M:
        vector = K % (VECTOR_BYTES // x2.element_size()) == 0
        if vector and (x2.data_ptr() % VECTOR_BYTES
                       or xs * x2.element_size() % VECTOR_BYTES):
            x2, xs = x2.reshape(-1, K).clone(memory_format=torch.contiguous_format), K
        if vector and bias is not None and bias.data_ptr() % VECTOR_BYTES:
            bias = bias.clone()
        plan = quant_plan(M, K, x2.dtype, vector)
        err = _lib()(x2.data_ptr(), None if bias is None else bias.data_ptr(),
                     None if q is None else q.data_ptr(), s.data_ptr(), xd,
                     1 if bias is None else _DTYPES[bias.dtype], M, K, xs,
                     1 if gelu else 0,
                     2 if scale is not None else (0 if store_q else 1),
                     plan["group"], plan["nv"], int(vector), plan["threads"],
                     plan["grid"], torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            raise RuntimeError(f"act_quantize_kernel: launch failed with "
                               f"cudaError {err}")
        act_quantize_kernel.launches += 1
    return q, s


def act_quantize_kernel(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        gelu: bool = True, scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on a CUDA tensor; same contract as
    :func:`act_quantize_plain`. Adds one to ``act_quantize_kernel.launches``
    per launch."""
    return _launch(x, bias, gelu, scale, store_q=True)


def act_scale_kernel(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     gelu: bool = True) -> torch.Tensor:
    """The same kernel writing the scales alone (no int8 store); same
    contract as :func:`act_scale_plain`. Counted in
    ``act_quantize_kernel.launches``."""
    return _launch(x, bias, gelu, None, store_q=False)[1]


act_quantize_kernel.launches = 0


def act_quantize(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 gelu: bool = True, scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return act_quantize_plain(x, bias, gelu, scale)
    return act_quantize_kernel(x, bias, gelu, scale)


def act_scale(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
              gelu: bool = True) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return act_scale_plain(x, bias, gelu)
    return act_scale_kernel(x, bias, gelu)
