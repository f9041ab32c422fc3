"""INT8 3x3 convolution: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``sdvar_tpu/ops/pallas/conv_s8.py:_kernel``
(reached through ``conv3x3_s8``). The kernels live in
``sdvar_tpu_torch/csrc/conv_s8.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); its source note gives the bound and the design. Two paths, picked
by ``conv_plan`` in plain Python: C % 16 == 0 and O >= 96 (every wide site
of the pixel decoder) take TMA tiles and s8 ``wgmma`` (256 pixels by 160
channels a tile); the rest (``conv_out``'s O = 3, C not a multiple of 16)
the implicit GEMM on ``mma.sync``.

Both versions take x as contiguous int8 (B, H, W, C) and the weights as
contiguous int8 (O, 3, 3, C) ("OHWI": the kernel's K order per output
channel), and compute the NHWC stride-1 "same" convolution's exact s32
sums, then ``float(acc) * scale[o] + bias[o]`` as two separately rounded
f32 operations, cast to ``out_dtype``. ``conv3x3_s8_plain`` is the CPU path
and the yardstick on the card: the two give the same bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.utils.profiling import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_s8_plain(x8: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The exact integer sums from an f64 convolution of the int8 values
    (exact: every partial sum is an integer far below 2^53), then
    ``acc.float() * scale + bias`` cast to ``out_dtype``; (B, H, W, O)."""
    acc = F.conv2d(x8.permute(0, 3, 1, 2).double(),
                   wk.permute(0, 3, 1, 2).double(), padding=1)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    y = acc.float() * scale.float() + bias.float()
    return y.to(out_dtype).contiguous()


TMA_TILE_M, TMA_TILE_N = 256, 160   # pixels and channels a tile (wide path)
TMA_KC = 128                        # channels a main K step of the wide path
TMA_STAGES = 3                      # its ring stages
BOX_WIDTHS = (256, 128, 64, 32, 16, 8)  # pixels along W of a tile's box
SMS = 132                           # streaming multiprocessors of an H100 SXM
# what ``csrc/conv_s8.cu:TMA_SMEM`` reserves: 1024 bytes of alignment slack
# and 3 stages of a 256 x 128 x tile and a 160 x 128 weight tile
TMA_SMEM = 1024 + TMA_STAGES * (TMA_TILE_M + TMA_TILE_N) * TMA_KC


def conv_plan(B: int, H: int, W: int, C: int, O: int) -> dict:
    """The path and launch geometry of ``csrc/conv_s8.cu`` for int8 x (B, H,
    W, C) and O output channels. ``path`` "tma" (C % 16 == 0, the TMA maps'
    16-byte strides, and O >= 96): tiles of 256 output pixels, a ``box_w``
    x ``box_h`` box of one image (the box whose tiling of H x W computes the
    fewest padded pixels, the widest of those), by 160 channels; each tap's
    channels in ``C // 128`` steps of 128, then one of ``tail`` (C % 128
    widened to 32, 64 or 128; 0 when there is none) through a ring of 3
    stages; ``grid`` blocks, one an SM at most, each walking the tiles
    ``grid`` apart. Else "mma" (the implicit GEMM on
    ``mma.sync``: 128 x 160 tiles for O >= 96, 128 x 8 for conv_out's O =
    3). Raises ValueError with the wrapper's message on what neither
    takes."""
    if min(B, H, W, C, O) <= 0:
        raise ValueError(f"conv3x3_s8_kernel: no launch for (B, H, W, C, O)="
                         f"{(B, H, W, C, O)}")
    if C % 4:
        raise ValueError(f"conv3x3_s8_kernel: C={C} must be a multiple of 4")
    M = B * H * W
    if C % 16 or O < 96:
        wide = O >= 96
        bm, bn = 128, (160 if wide else 8)
        return {"path": "mma", "block_m": bm, "block_n": bn,
                "threads": 320 if wide else 128,
                "grid": (-(-M // bm), -(-O // bn))}

    def padded(bw):
        bh = TMA_TILE_M // bw
        return (-(-W // bw) * bw) * (-(-H // bh) * bh)

    box_w = min(BOX_WIDTHS, key=lambda bw: (padded(bw), -bw))
    box_h = TMA_TILE_M // box_w
    rest = C % TMA_KC
    tail = 0 if rest == 0 else next(k for k in (32, 64, 128) if rest <= k)
    tiles = (-(-O // TMA_TILE_N), -(-W // box_w), -(-H // box_h), B)
    n_tiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    return {"path": "tma", "block_m": TMA_TILE_M, "block_n": TMA_TILE_N,
            "box_w": box_w, "box_h": box_h, "k_steps": 9 * (C // TMA_KC),
            "tail": tail, "stages": TMA_STAGES, "threads": 384, "tiles": tiles,
            "n_tiles": n_tiles, "grid": min(n_tiles, SMS), "smem_bytes": TMA_SMEM}


_fns = {}


def _lib(entry: str):
    """The C entry point ``entry`` of csrc/conv_s8.cu, bound once."""
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load("conv_s8"), entry)
        P, I = ctypes.c_void_p, ctypes.c_int
        n_int = {"sdvar_conv3x3_s8": 6, "sdvar_conv3x3_s8_tma": 9}[entry]
        fn.argtypes = [P] * 5 + [I] * n_int + [P]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def smem_bytes() -> int:
    """The dynamic shared memory the source reserves for the wide path (to
    hold ``conv_plan``'s count against)."""
    fn = _build.load("conv_s8").sdvar_conv3x3_s8_tma_smem_bytes
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def conv3x3_s8_kernel(x8: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does not
    take (it never falls back to the plain version). Adds one to
    ``conv3x3_s8_kernel.launches`` per launch."""
    dev = x8.device
    if not (x8.is_cuda and all(t.device == dev for t in (wk, scale, bias))):
        raise ValueError("conv3x3_s8_kernel: x8, wk, scale and bias must be "
                         "CUDA tensors on one device")
    if out_dtype not in _DTYPES:
        raise ValueError(f"conv3x3_s8_kernel: out_dtype {out_dtype} not "
                         "supported (float32 or bfloat16)")
    if x8.dtype != torch.int8 or wk.dtype != torch.int8 or x8.dim() != 4:
        raise ValueError(f"conv3x3_s8_kernel: needs int8 x (B, H, W, C) and "
                         f"int8 wk (O, 3, 3, C), got {x8.dtype} "
                         f"{tuple(x8.shape)} and {wk.dtype} {tuple(wk.shape)}")
    B, H, W, C = x8.shape
    O = wk.shape[0]
    if tuple(wk.shape) != (O, 3, 3, C):
        raise ValueError(f"conv3x3_s8_kernel: wk {tuple(wk.shape)} is not "
                         f"(O, 3, 3, C={C})")
    if C % 4:
        raise ValueError(f"conv3x3_s8_kernel: C={C} must be a multiple of 4")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (O,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"conv3x3_s8_kernel: {name} must be contiguous "
                             f"float32 ({O},), got {t.dtype} {tuple(t.shape)}")
    if not x8.is_contiguous() or not wk.is_contiguous():
        raise ValueError("conv3x3_s8_kernel: x8 must be a contiguous (B, H, W, "
                         "C) tensor and wk a contiguous (O, 3, 3, C) one")
    if x8.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv3x3_s8_kernel: x8 and wk must be 16-byte aligned")
    out = torch.empty((B, H, W, O), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = conv_plan(B, H, W, C, O)
    args = (x8.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), _DTYPES[out_dtype], B, H, W, C, O)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with launch("sdvar.launch.conv_s8"):
        if plan["path"] == "tma":
            err = _lib("sdvar_conv3x3_s8_tma")(*args, plan["box_w"],
                                               plan["box_h"], plan["grid"],
                                               stream)
        else:
            err = _lib("sdvar_conv3x3_s8")(*args, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_s8_kernel: launch failed with cudaError {err}")
    conv3x3_s8_kernel.launches += 1
    return out


conv3x3_s8_kernel.launches = 0


def conv3x3_s8_ohwi(x8: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x8.device.type == "cpu":
        return conv3x3_s8_plain(x8, wk, scale, bias, out_dtype)
    return conv3x3_s8_kernel(x8, wk, scale, bias, out_dtype)
