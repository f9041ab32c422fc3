"""Fused attention: the CUDA kernels' wrappers and their plain versions.

``attention_kernel`` replaces the TPU kernel
``sdvar_tpu/ops/pallas/attention.py:_kernel``, float-KV and INT8-KV
branches; ``attention_cache_kernel`` and ``attention_cache_write_kernel``
replace ``sdvar_tpu/ops/pallas/experimental.py:_cache_kernel`` (attention
over one layer of the stacked KV cache) and ``_write_kernel`` (the same,
after writing the scale's new keys and values into the cache). All three
are one attention loop in ``sdvar_tpu_torch/csrc/attention.cu`` (CUDA C++
for sm_90a, loaded with ctypes); its source note gives the bound and the
design. ``attention_plain``, ``attention_cache_plain`` and
``attention_cache_write_plain`` compute the same functions in f32 with
einsums: they are the CPU path and the yardstick on the card.

Layouts follow the JAX package: q (B, Lq, H, hd); k/v (B, Lk, H, hd), or
token-major (Lk, B, H, hd) when ``kv_token_major``; bias (Lq, Lk) or None;
``kv_scales`` (ks, vs) f32 per-token scales of int8 k/v, each (B, Lk), or
(Lk, B) when token-major. The kernel takes any batch/token strides as long
as the heads are packed in the last merged dim, so KV-cache slices, their
scale planes and views of the fused qkv projection go in without a copy.
The cache kernels take the port's stacked batch-major cache (depth, B,
L_max, H*hd) with, for int8, its (depth, B, L_max) scale planes, and a
layer index.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.utils.profiling import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _scales_bk(kv_scales, kv_token_major: bool):
    """(ks, vs) as (B, Lk) views."""
    ks, vs = kv_scales
    return (ks.t(), vs.t()) if kv_token_major else (ks, vs)


def attention_plain(q, k, v, bias: Optional[torch.Tensor], scale: float,
                    kv_token_major: bool = False,
                    kv_scales=None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v in f32, returned in q's dtype.

    Fully-masked rows give 0, as in the TPU kernel: the row max is clamped
    at -1e30 and the sum at 1e-30, and the division comes after PV (a bare
    softmax would give NaN). With ``kv_scales`` (int8 k/v), the kernel's
    order: the key scale multiplies the scaled scores before the bias, l is
    summed before the value scale folds into p, and p * vs is cast to q's
    dtype before the PV product."""
    kidx = "kbhd" if kv_token_major else "bkhd"
    s = torch.einsum(f"bqhd,{kidx}->bhqk", q.float(), k.float()) * scale
    if kv_scales is not None:
        ks, vs = (t.float()[:, None, None, :]
                  for t in _scales_bk(kv_scales, kv_token_major))
        s = s * ks
    if bias is not None:
        s = s + bias.float()[None, None]
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # (b, h, q, 1)
    if kv_scales is not None:
        p = (p * vs).to(q.dtype).float()
    o = torch.einsum(f"bhqk,{kidx}->bqhd", p, v.float())
    o = o / l.clamp(min=1e-30).permute(0, 2, 1, 3)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Launch geometry: the kernel's grid, block and shared memory, on any device
# ---------------------------------------------------------------------------

KEY_TILE = 64        # keys per ring tile
WG_ROWS = 64         # query rows per warpgroup (bf16 q)
COPY_BYTES = 16      # one cp.async copy; also the alignment every operand needs
DEFAULT_STAGES = 3   # ring depth (2..4)
DEFAULT_WARPGROUPS = 2  # the most a block takes unless asked for more
MAX_SMEM = 232448    # dynamic shared memory one block may take on Hopper
_ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def check_strides(name: str, strides, itemsize: int, ptr: int = 0) -> None:
    """Refuse an operand whose base or batch/token strides (in elements)
    are not 16-byte aligned: every copy the kernel issues is 16 bytes."""
    vec = COPY_BYTES // itemsize
    if ptr % COPY_BYTES or any(st % vec for st in strides):
        raise ValueError(f"attention_kernel: {name} must be 16-byte aligned "
                         f"with strides a multiple of {vec}")


def attention_plan(B: int, Lq: int, Lk: int, H: int, hd: int,
                   q_dtype: torch.dtype, kv_dtype: torch.dtype, *,
                   write: bool = False, stages: Optional[int] = None,
                   max_warpgroups: Optional[int] = None, q_strides=(),
                   kv_strides=()) -> dict:
    """The launch geometry of ``csrc/attention.cu`` for these shapes,
    strides and dtypes, as the C entry points derive it from the
    warpgroups and stages passed in.

    bf16 q: blocks of up to ``max_warpgroups`` warpgroups (64 query rows
    each; default 2, at most 4, 2 at hd = 128), as few blocks per (b, h) as
    that allows, the warpgroups spread evenly over them: by default K/V are
    staged once per (b, h) for Lq <= 128 and twice for the decode's last
    scales (two 2-warpgroup blocks share an SM, and measured faster than
    one of 4; the second read comes from L2); a ring of ``stages`` (2-4,
    default 3) K/V tiles of (64 keys x hd) in k/v's dtype, plus one pair
    of bf16 tiles for the conversion pass of an int8 or f32 ring. f32 q:
    the scalar kernel's 64-row blocks of 256 threads. ``kv_bytes_staged``
    counts what every block's copies read (K/V rows and int8 scales;
    ``write``: the Lq new rows in place of the cache's). Raises ValueError
    with the wrapper's message on what the kernel does not take."""
    if q_dtype not in _DTYPES:
        raise ValueError(f"attention_kernel: dtype {q_dtype} not supported")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"attention_kernel: head dim {hd} not in {_HEAD_DIMS}")
    if (q_dtype, kv_dtype) not in _CACHE_PAIRS:
        raise ValueError(f"attention_kernel: a {kv_dtype} k/v under a "
                         f"{q_dtype} q is not taken")
    if min(B, Lq, Lk, H) <= 0 or max(B, H) > 65535:
        raise ValueError(f"attention_kernel: no launch for B={B} Lq={Lq} "
                         f"Lk={Lk} H={H}")
    check_strides("q", q_strides, _ITEM[q_dtype])
    check_strides("k/v", kv_strides, _ITEM[kv_dtype])
    int8 = kv_dtype == torch.int8
    new_item = 1 if int8 else _ITEM[q_dtype]
    n_new = Lq if write else 0
    row_bytes = (2 * hd * (_ITEM[kv_dtype] * (Lk - n_new) + new_item * n_new)
                 + (8 * Lk if int8 else 0))
    if q_dtype == torch.float32:
        grid_x = -(-Lq // 64)
        return {"grid": (grid_x, H, B), "threads": 256, "warpgroups": 0,
                "stages": 0, "smem_bytes": 4 * (2 * hd * 68 + 64 * hd + 64 * 68
                                                 + 128),
                "box": (KEY_TILE, hd),
                "kv_bytes_staged": grid_x * B * H * row_bytes}
    cap = max_warpgroups or DEFAULT_WARPGROUPS
    if not 1 <= cap <= (2 if hd == 128 else 4):
        raise ValueError(f"attention_kernel: {cap} warpgroups a block not "
                         f"taken at hd={hd}")
    wg_tiles = -(-Lq // WG_ROWS)
    wg = -(-wg_tiles // -(-wg_tiles // cap))
    grid_x = -(-Lq // (WG_ROWS * wg))
    # a stage holds K and V in k/v's dtype (int8: and their scales); int8
    # and f32 add one pair of converted bf16 tiles; ring and tiles at
    # 1024-byte boundaries (the swizzle's period), with 1024 bytes to align
    # the base
    stage = 2 * KEY_TILE * hd * _ITEM[kv_dtype] + (2 * KEY_TILE * 4 if int8 else 0)
    conv = 0 if kv_dtype == torch.bfloat16 else 2 * KEY_TILE * hd * 2
    smem = lambda n: 1024 + -(-n * stage // 1024) * 1024 + conv
    if stages is None:
        stages = DEFAULT_STAGES
    if not 2 <= stages <= 4 or smem(stages) > MAX_SMEM:
        raise ValueError(f"attention_kernel: a ring of {stages} stages of "
                         f"{stage} bytes does not fit")
    return {"grid": (grid_x, H, B), "threads": 128 * wg, "warpgroups": wg,
            "stages": stages, "smem_bytes": smem(stages),
            "box": (KEY_TILE, hd),
            "kv_bytes_staged": grid_x * B * H * row_bytes}


# the wrappers' plans, once per shape: the plan is a pure function
_plan = functools.lru_cache(maxsize=1024)(attention_plan)


def _lib(int8: bool):
    lib = _build.load("attention")
    fn = lib.sdvar_attention_int8 if int8 else lib.sdvar_attention
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ptrs, strides = (7, 8) if int8 else (5, 6)
        fn.argtypes = ([P] * ptrs + [I] * 6 + [LL] * strides
                       + [ctypes.c_float, P, I, I])
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, q_dtype: torch.dtype, kv_dtype: torch.dtype,
               stages: int) -> int:
    """Dynamic shared memory of one kernel block, as the CUDA source counts
    it (``attention_plan``'s ``smem_bytes`` must agree)."""
    fn = _build.load("attention").sdvar_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return fn(hd, _DTYPES[q_dtype], _CODES[kv_dtype], stages)


def _check_operand(name: str, t: torch.Tensor, dtype, hd: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"attention_kernel: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"attention_kernel: {name} is {t.dtype}, needs {dtype}")
    if t.dim() != 4 or t.stride(-1) != 1 or t.stride(-2) != hd:
        raise ValueError(f"attention_kernel: {name} needs packed heads and a "
                         f"contiguous head dim, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    check_strides(name, t.stride()[:2], t.element_size(), t.data_ptr())


def attention_kernel(q, k, v, bias: Optional[torch.Tensor], scale: float,
                     kv_token_major: bool = False,
                     kv_scales=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does not
    take. Adds one per launch to ``attention_kernel.launches`` (float K/V)
    or ``attention_kernel.launches_int8`` (int8 K/V with ``kv_scales``)."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention_kernel: dtype {q.dtype} not supported")
    B, Lq, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"attention_kernel: head dim {hd} not in {_HEAD_DIMS}")
    int8 = kv_scales is not None
    kv_dtype = torch.int8 if int8 else q.dtype
    _check_operand("q", q, q.dtype, hd)
    for name, t in (("k", k), ("v", v)):
        _check_operand(name, t, kv_dtype, hd)
    if k.shape != v.shape:
        raise ValueError("attention_kernel: k and v must share a shape")
    b_dim, l_dim = (1, 0) if kv_token_major else (0, 1)
    Bk, Lk = k.shape[b_dim], k.shape[l_dim]
    Hk, hdk = k.shape[2:]
    if (Bk, Hk, hdk) != (B, H, hd):
        raise ValueError(f"attention_kernel: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if bias is not None:
        if (bias.dtype != torch.float32 or not bias.is_cuda
                or not bias.is_contiguous() or tuple(bias.shape) != (Lq, Lk)):
            raise ValueError("attention_kernel: bias must be a contiguous "
                             f"float32 CUDA tensor of shape {(Lq, Lk)}")
    if k.device != q.device or v.device != q.device or (
            bias is not None and bias.device != q.device):
        raise ValueError("attention_kernel: operands on different devices")
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    strides = [q.stride(0), q.stride(1), k.stride(b_dim), k.stride(l_dim),
               v.stride(b_dim), v.stride(l_dim)]
    if int8:
        ks, vs = _scales_bk(kv_scales, kv_token_major)
        for t in (ks, vs):
            if (t.dtype != torch.float32 or t.device != q.device
                    or tuple(t.shape) != (B, Lk) or t.stride() != ks.stride()):
                raise ValueError("attention_kernel: kv_scales must be two "
                                 f"float32 ({B}, {Lk}) planes on q's device "
                                 "with one pair of strides")
        ptrs += [ks.data_ptr(), vs.data_ptr()]
        strides += list(ks.stride())
    plan = _plan(B, Lq, Lk, H, hd, q.dtype, kv_dtype)
    out = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device)
    ptrs += [bias.data_ptr() if bias is not None else None, out.data_ptr()]
    with launch("sdvar.launch.attention" + ("_int8" if int8 else "")):
        err = _lib(int8)(
            *ptrs, _DTYPES[q.dtype], B, Lq, Lk, H, hd, *strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
            plan["warpgroups"], plan["stages"],
        )
    if err != 0:
        raise RuntimeError(f"attention_kernel: launch failed with cudaError {err}")
    if int8:
        attention_kernel.launches_int8 += 1
    else:
        attention_kernel.launches += 1
    return out


attention_kernel.launches = 0
attention_kernel.launches_int8 = 0


# ---------------------------------------------------------------------------
# Attention over the stacked KV cache, with and without the cache write
# ---------------------------------------------------------------------------

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (q dtype, cache dtype) pairs the cache kernels take: a float cache in q's
# dtype, an f32 cache under a bf16 q (read back rounded to bf16, as the
# unfused path casts it), or int8 with scale planes
_CACHE_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.int8), (torch.float32, torch.float32),
                (torch.float32, torch.int8)}


def _check_cache_args(name, q, cache_k, cache_v, li, kv_len, cache_scales,
                      cache_begin=None):
    """The cache kernels' contract, on either device: shapes, the dtype
    pair, the layer and, with a write, kv_len = cache_begin + Lq (the port
    has no pad query rows)."""
    B, Lq, H, hd = q.shape
    if cache_k.dim() != 4 or cache_k.shape != cache_v.shape \
            or cache_k.dtype != cache_v.dtype:
        raise ValueError(f"{name}: caches must share a (depth, B, L_max, C) "
                         f"shape and dtype, got {tuple(cache_k.shape)} "
                         f"{cache_k.dtype} and {tuple(cache_v.shape)} "
                         f"{cache_v.dtype}")
    depth, Bc, Lmax, C = cache_k.shape
    if (Bc, C) != (B, H * hd):
        raise ValueError(f"{name}: cache {tuple(cache_k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if (q.dtype, cache_k.dtype) not in _CACHE_PAIRS:
        raise ValueError(f"{name}: a {cache_k.dtype} cache under a {q.dtype} "
                         f"q is not taken (pairs: q bf16 with a bf16, f32 or "
                         f"int8 cache, q f32 with an f32 or int8 cache)")
    if (cache_k.dtype == torch.int8) != (cache_scales is not None):
        raise ValueError(f"{name}: an int8 cache comes with its scale planes, "
                         f"and only an int8 cache")
    if not 0 <= li < depth:
        raise ValueError(f"{name}: layer {li} not in [0, {depth})")
    if not 0 < kv_len <= Lmax:
        raise ValueError(f"{name}: kv_len {kv_len} not in (0, {Lmax}]")
    if cache_begin is not None and (cache_begin < 0
                                    or kv_len != cache_begin + Lq):
        raise ValueError(f"{name}: kv_len {kv_len} must be cache_begin "
                         f"{cache_begin} + Lq {Lq}")
    if cache_scales is not None:
        for t in cache_scales:
            if t.dtype != torch.float32 or tuple(t.shape) != (depth, B, Lmax):
                raise ValueError(f"{name}: cache_scales must be two float32 "
                                 f"{(depth, B, Lmax)} planes")


def _layer_kv(q, cache_k, cache_v, li, kv_len, cache_scales):
    """Layer ``li`` of the cache as (B, kv_len, H, hd) views, with the
    (B, kv_len) scale views of an int8 cache; a float cache in another
    dtype than q is cast to q's dtype, as ``models.var`` does."""
    B, _, H, hd = q.shape
    k = cache_k[li, :, :kv_len].view(B, kv_len, H, hd)
    v = cache_v[li, :, :kv_len].view(B, kv_len, H, hd)
    if cache_scales is not None:
        return k, v, tuple(s[li, :, :kv_len] for s in cache_scales)
    if k.dtype != q.dtype:
        k, v = k.to(q.dtype), v.to(q.dtype)
    return k, v, None


def attention_cache_plain(q, cache_k, cache_v, li: int, kv_len: int,
                          bias: Optional[torch.Tensor], scale: float,
                          cache_scales=None) -> torch.Tensor:
    """Attention of q (B, Lq, H, hd) over keys [0, kv_len) of layer ``li``
    of the stacked cache (depth, B, L_max, H*hd); ``cache_scales``: the
    (depth, B, L_max) f32 key and value scale planes of an int8 cache."""
    _check_cache_args("attention_cache", q, cache_k, cache_v, li, kv_len,
                      cache_scales)
    k, v, kv_scales = _layer_kv(q, cache_k, cache_v, li, kv_len, cache_scales)
    return attention_plain(q, k, v, bias, scale, kv_scales=kv_scales)


def attention_cache_write_plain(q, k_new, v_new, cache_k, cache_v, li: int,
                                cache_begin: int, kv_len: int,
                                bias: Optional[torch.Tensor], scale: float,
                                new_scales=None,
                                cache_scales=None) -> torch.Tensor:
    """Write k_new/v_new (B, Lq, H, hd) into layer ``li`` of the cache at
    rows [cache_begin, kv_len) (in place; with ``new_scales``, the (B, Lq)
    f32 scales of int8 rows, into ``cache_scales`` too), then attend over
    [0, kv_len)."""
    _check_cache_args("attention_cache_write", q, cache_k, cache_v, li,
                      kv_len, cache_scales, cache_begin)
    B, Lq, H, hd = q.shape
    cache_k[li, :, cache_begin:kv_len] = k_new.reshape(B, Lq, H * hd)
    cache_v[li, :, cache_begin:kv_len] = v_new.reshape(B, Lq, H * hd)
    if cache_scales is not None:
        for plane, new in zip(cache_scales, new_scales):
            plane[li, :, cache_begin:kv_len] = new
    return attention_cache_plain(q, cache_k, cache_v, li, kv_len, bias, scale,
                                 cache_scales)


def _cache_lib():
    fn = _build.load("attention").sdvar_attention_cache
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 11 + [I] * 9 + [LL] * 12 + [ctypes.c_float, P, I, I]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, t: torch.Tensor, dev) -> None:
    """On q's card, unit stride in the last dim, 16-byte aligned strides
    and base."""
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on q's device")
    es = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(s * es % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: last dim must be contiguous, base and "
                         f"strides 16-byte aligned, got strides {t.stride()}")


def _layer_ptr(t: torch.Tensor, li: int) -> int:
    return t.data_ptr() + li * t.stride(0) * t.element_size()


def _cache_launch(name, q, cache_k, cache_v, li, kv_len, bias, scale,
                  cache_scales, write=None):
    """Launch ``sdvar_attention_cache``; ``write`` = (k_new, v_new,
    new_scales, cache_begin) or None."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    B, Lq, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {_HEAD_DIMS}")
    _check_cache_args(name, q, cache_k, cache_v, li, kv_len, cache_scales,
                      None if write is None else write[3])
    _check_operand("q", q, q.dtype, hd)
    dev = q.device
    for n, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check_cuda(n, t, dev)
    if cache_k.stride() != cache_v.stride():
        raise ValueError(f"{name}: caches must share strides")
    int8 = cache_scales is not None
    cks = cvs = None
    s_strides = [0, 0]
    if int8:
        cks, cvs = cache_scales
        if cks.stride() != cvs.stride() or not cks.is_cuda \
                or cks.device != dev or cvs.device != dev:
            raise ValueError(f"{name}: scale planes must be on q's device "
                             "with one set of strides")
        s_strides = [cks.stride(1), cks.stride(2)]
    if bias is not None:
        if (bias.dtype != torch.float32 or not bias.is_cuda
                or bias.device != dev or not bias.is_contiguous()
                or tuple(bias.shape) != (Lq, kv_len)):
            raise ValueError(f"{name}: bias must be a contiguous float32 CUDA "
                             f"tensor of shape {(Lq, kv_len)}")
    new_ptrs, new_strides, split = [None] * 4, [0] * 6, kv_len
    if write is not None:
        k_new, v_new, new_scales, split = write
        new_dtype = torch.int8 if int8 else q.dtype
        for n, t in (("k_new", k_new), ("v_new", v_new)):
            _check_operand(n, t, new_dtype, hd)
            if tuple(t.shape) != (B, Lq, H, hd) or t.device != dev:
                raise ValueError(f"{name}: {n} must be {(B, Lq, H, hd)} on "
                                 f"q's device, got {tuple(t.shape)}")
        new_ptrs[:2] = [k_new.data_ptr(), v_new.data_ptr()]
        new_strides[:4] = [k_new.stride(0), k_new.stride(1), v_new.stride(0),
                           v_new.stride(1)]
        if int8:
            kns, vns = new_scales
            for t in (kns, vns):
                if (t.dtype != torch.float32 or tuple(t.shape) != (B, Lq)
                        or t.device != dev or t.stride() != kns.stride()):
                    raise ValueError(f"{name}: new_scales must be two float32 "
                                     f"{(B, Lq)} tensors on q's device with "
                                     "one pair of strides")
            new_ptrs[2:] = [kns.data_ptr(), vns.data_ptr()]
            new_strides[4:] = list(kns.stride())
    plan = _plan(B, Lq, kv_len, H, hd, q.dtype, cache_k.dtype,
                 write=write is not None)
    out = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=dev)
    with launch("sdvar.launch." + name.removesuffix("_kernel")):
        err = _cache_lib()(
            q.data_ptr(), _layer_ptr(cache_k, li), _layer_ptr(cache_v, li),
            _layer_ptr(cks, li) if int8 else None,
            _layer_ptr(cvs, li) if int8 else None, *new_ptrs,
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            _CODES[q.dtype], _CODES[cache_k.dtype], int(write is not None),
            B, Lq, kv_len, split, H, hd, q.stride(0), q.stride(1),
            cache_k.stride(1), cache_k.stride(2), *s_strides, *new_strides,
            float(scale), torch.cuda.current_stream(dev).cuda_stream,
            plan["warpgroups"], plan["stages"],
        )
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    return out


def attention_cache_kernel(q, cache_k, cache_v, li: int, kv_len: int,
                           bias: Optional[torch.Tensor], scale: float,
                           cache_scales=None) -> torch.Tensor:
    """``attention_cache_plain`` on the card: one launch reads layer ``li``
    of the cache in place (no slice is made). Adds one per launch to
    ``attention_cache_kernel.launches``."""
    out = _cache_launch("attention_cache_kernel", q, cache_k, cache_v, li,
                        kv_len, bias, scale, cache_scales)
    attention_cache_kernel.launches += 1
    return out


def attention_cache_write_kernel(q, k_new, v_new, cache_k, cache_v, li: int,
                                 cache_begin: int, kv_len: int,
                                 bias: Optional[torch.Tensor], scale: float,
                                 new_scales=None,
                                 cache_scales=None) -> torch.Tensor:
    """``attention_cache_write_plain`` on the card in one launch: the new
    rows go into the cache and are attended over in the same kernel. Adds
    one per launch to ``attention_cache_write_kernel.launches`` (float
    cache) or ``.launches_int8`` (int8 cache)."""
    out = _cache_launch("attention_cache_write_kernel", q, cache_k, cache_v,
                        li, kv_len, bias, scale, cache_scales,
                        (k_new, v_new, new_scales, cache_begin))
    if cache_scales is not None:
        attention_cache_write_kernel.launches_int8 += 1
    else:
        attention_cache_write_kernel.launches += 1
    return out


attention_cache_kernel.launches = 0
attention_cache_write_kernel.launches = 0
attention_cache_write_kernel.launches_int8 = 0
