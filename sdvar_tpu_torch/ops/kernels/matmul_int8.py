"""INT8-weight matmul: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/matmul_int8.py:_kernel``
(reached through ``int8_matmul`` / ``int8_matmul_blc``). The kernel lives
in ``sdvar_tpu_torch/csrc/matmul_int8.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); its source note gives the bound and the design. Its launch
geometry (tile, ring stages, grid) is planned here, in plain Python,
by ``matmul_plan``. ``int8_matmul_plain`` computes the same function,
``(x @ q) * s`` with an f32 sum and the scale applied to that sum: it is
the CPU path and the yardstick on the card. ``split_bf16x3`` is the exact
three-piece bf16 split through which the kernel multiplies an f32 x on the
tensor cores.
"""

from __future__ import annotations

import ctypes

import torch

from sdvar_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

BLOCK_K = 64          # K per ring tile
WG_ROWS = 64          # output rows per warpgroup
SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448     # dynamic shared memory one block may take on Hopper
# (warpgroups, columns) tiles, widest first
TILES = {torch.bfloat16: ((2, 128), (2, 64), (1, 128), (1, 64)),
         torch.float32: ((2, 128), (1, 128), (1, 64))}


def _smem_bytes(x_dtype: torch.dtype, warpgroups: int, block_n: int,
                stages: int) -> int:
    """What ``csrc/matmul_int8.cu:smem_bytes`` reserves: 1024 bytes of
    alignment slack, ``stages`` x (the x tile + the int8 weight tile), and
    two bf16 weight tiles for the conversion pass."""
    return (1024 + stages * _stage_bytes(x_dtype, warpgroups, block_n)
            + 2 * BLOCK_K * block_n * 2)


def _stage_bytes(x_dtype, warpgroups, block_n):
    item = 4 if x_dtype == torch.float32 else 2
    return warpgroups * WG_ROWS * BLOCK_K * item + BLOCK_K * block_n


def _reduces(x_dtype, warpgroups, block_n, stages=3):
    """Whether a split of K can add its partial tiles (f32, rows padded by
    4) in the ring they replace."""
    return (warpgroups * WG_ROWS * (block_n + 4) * 4
            <= stages * _stage_bytes(x_dtype, warpgroups, block_n))


def _cost(M, N, k_tiles, wg, bn, splits):
    """What the default plan minimises for a bf16 x: waves of blocks over
    the card times the time a block holds its SM, counted in K tiles (its
    share of the K loop, about 4 more to fill the ring and store, 4 more
    to add a split's partials), then the padded output area, then the
    split. Blocks an SM holds: by shared memory (228 KB a SM, 1 KB static a
    block) and by registers (about 96 a thread)."""
    row_blocks, col_blocks = -(-M // (wg * WG_ROWS)), -(-N // bn)
    per_sm = min(233472 // (_smem_bytes(torch.bfloat16, wg, bn, 3) + 1024),
                 65536 // (96 * 128 * wg))
    waves = -(-(row_blocks * col_blocks * splits) // (SMS * per_sm))
    hold = -(-k_tiles // splits) + 4 + (4 if splits > 1 else 0)
    return (waves * hold, row_blocks * wg * WG_ROWS * col_blocks * bn, splits)


def matmul_plan(M: int, N: int, K: int, x_dtype: torch.dtype, *,
                warpgroups: int = None, block_n: int = None,
                stages: int = None, splits: int = None) -> dict:
    """The launch geometry of ``csrc/matmul_int8.cu`` for an (M, K) x of
    ``x_dtype`` times an int8 (K, N) weight: blocks of 1 or 2 warpgroups
    (64 output rows each) by ``block_n`` (64 or 128) columns, a ring of
    ``stages`` (3 or 4) K tiles of 64, and ``splits``
    (1, 2, 4 or 8) blocks of a cluster that share K and add their partial
    sums in a fixed order. By default, for a bf16 x, the tile and split
    whose blocks take the fewest K tiles in turn on the card (``_cost``:
    at small M the loop's latency, not the tensor cores, bounds a block,
    and splitting K shortens it); for an f32 x (the logits head)
    the column tile and the split follow M alone (64 columns and 4 splits
    up to M = 256), so that a model rank's share of the vocabulary runs
    the same products, in the same order, as the whole head and gives its
    bits. Raises ValueError with the wrapper's message on what the kernel
    does not take."""
    if x_dtype not in _DTYPES:
        raise ValueError(f"int8_matmul_kernel: x {x_dtype} not supported "
                         "(float32 or bfloat16)")
    if min(M, N, K) <= 0:
        raise ValueError(f"int8_matmul_kernel: no launch for M={M} N={N} K={K}")
    if K % 8 or N % 16:
        raise ValueError(f"int8_matmul_kernel: K={K} must be a multiple of 8 "
                         f"and N={N} of 16")
    f32 = x_dtype == torch.float32
    k_tiles = -(-K // BLOCK_K)

    def blocks(wg, bn):
        return -(-M // (wg * WG_ROWS)) * -(-N // bn)

    if f32:
        if block_n is None:
            block_n = 128 if M > 256 else 64
        if warpgroups is None:
            warpgroups = (2 if (2, block_n) in TILES[x_dtype]
                          and blocks(2, block_n) >= SMS else 1)
        if splits is None:
            splits = 4 if M <= 256 and k_tiles >= 8 else 1
    else:
        fits = [t for t in TILES[x_dtype]
                if (warpgroups is None or t[0] == warpgroups)
                and (block_n is None or t[1] == block_n)]
        if not fits:
            raise ValueError(f"int8_matmul_kernel: no tile of {warpgroups} "
                             f"warpgroups x {block_n} columns")
        ways = [(wg, bn, sp) for wg, bn in fits
                for sp in ((splits,) if splits else (1, 2, 4, 8))
                if sp == 1 or (k_tiles >= 2 * sp
                               and _reduces(x_dtype, wg, bn))]
        warpgroups, block_n, splits = min(
            ways, key=lambda w: _cost(M, N, k_tiles, *w))
    if stages is None:
        stages = 3
    if ((warpgroups, block_n) not in TILES[x_dtype] or stages not in (3, 4)
            or splits not in (1, 2, 4, 8)
            or (splits > 1 and not _reduces(x_dtype, warpgroups, block_n, stages))):
        raise ValueError(f"int8_matmul_kernel: no tile of {warpgroups} "
                         f"warpgroups x {block_n} columns with {stages} "
                         f"stages and {splits} splits")
    grid = (-(-N // block_n), -(-M // (warpgroups * WG_ROWS)), splits)
    if grid[1] > 65535:
        raise ValueError(f"int8_matmul_kernel: M={M} needs {grid[1]} row "
                         "blocks (at most 65535)")
    smem = _smem_bytes(x_dtype, warpgroups, block_n, stages)
    if smem > MAX_SMEM:
        raise ValueError(f"int8_matmul_kernel: {smem} B of shared memory "
                         f"(at most {MAX_SMEM})")
    return {"grid": grid, "threads": 128 * warpgroups,
            "warpgroups": warpgroups, "block_m": warpgroups * WG_ROWS,
            "block_n": block_n, "block_k": BLOCK_K, "stages": stages,
            "splits": splits, "smem_bytes": smem}


def split_bf16x3(x: torch.Tensor):
    """An f32 tensor as three bf16 tensors (hi, mid, lo) whose f32 sum is x
    bit for bit: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
    (each difference exact in f32; exact wherever lo stays a normal bf16,
    |x| >= 2^-102, and hi does not overflow). Each piece times an int8 is
    exact in f32, so the kernel's three bf16 tensor-core products sum to
    the f32 product; this is its split, as a plain function."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def smem_bytes(x_dtype: torch.dtype, warpgroups: int, block_n: int,
               stages: int) -> int:
    """The dynamic shared memory the CUDA source reserves for this tile (0
    for one it does not take), from the built library: the plan's figure
    must equal it."""
    fn = _build.load("matmul_int8").sdvar_int8_matmul_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(_DTYPES[x_dtype], warpgroups, block_n, stages)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16/f32 @ int8 (K, N) -> (M, N) in x's dtype:
    ``(x.float() @ q.float()) * s``."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def _lib():
    fn = _build.load("matmul_int8").sdvar_int8_matmul
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_longlong, P, I, I, I, I]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_kernel(x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (output in x's dtype); raise on
    anything it does not take. Adds one to ``int8_matmul_kernel.launches``
    per launch."""
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError("int8_matmul_kernel: x, q and s must be CUDA tensors "
                         "on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_matmul_kernel: x {x.dtype} not supported "
                         "(float32 or bfloat16)")
    if x.dim() != 2 or q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"int8_matmul_kernel: needs x (M, K) and int8 q (K, N), "
                         f"got {tuple(x.shape)} and {tuple(q.shape)} {q.dtype}")
    M, K = x.shape
    N = q.shape[1]
    if q.shape[0] != K or s.shape != (N,) or s.dtype != torch.float32:
        raise ValueError(f"int8_matmul_kernel: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)} and f32 s {tuple(s.shape)} disagree")
    plan = matmul_plan(max(M, 1), N, K, x.dtype)
    vec = 16 // x.element_size()  # the kernel loads 16 bytes at a time
    if (x.stride(1) != 1 or x.stride(0) % vec or x.data_ptr() % 16
            or not q.is_contiguous() or q.data_ptr() % 16
            or not s.is_contiguous()):
        raise ValueError("int8_matmul_kernel: x needs contiguous rows, 16-byte "
                         f"aligned with a row stride a multiple of {vec}; q "
                         "and s must be contiguous and aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], M, N, K, x.stride(0),
                 torch.cuda.current_stream(x.device).cuda_stream,
                 plan["warpgroups"], plan["block_n"], plan["stages"],
                 plan["splits"])
    if err != 0:
        raise RuntimeError(f"int8_matmul_kernel: launch failed with cudaError {err}")
    int8_matmul_kernel.launches += 1
    return out


int8_matmul_kernel.launches = 0


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s)
    return int8_matmul_kernel(x, q, s)


def int8_matmul_blc(x_blc: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., K) @ int8 (K, N) -> (..., N); flattens the tokens into M."""
    K = x_blc.shape[-1]
    y = int8_matmul(x_blc.reshape(-1, K), q, s)
    return y.view(*x_blc.shape[:-1], q.shape[1])
