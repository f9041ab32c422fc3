"""The multi-device probe kernel: the Triton kernel's wrapper and its plain
version.

Replaces the JAX package's ``kern`` (``tests/test_tp_pallas.py:194-203``),
``o = x * 2.0`` on an (8, 512) f32 array: the Pallas call that proves GSPMD
cannot partition a Mosaic kernel whose operand is split over "model", which
is why the JAX package launches its kernels per shard (``shard_map``). The
port's sharded form (``ops.partition.sharded_scale_probe``) launches this
kernel on each rank's column shard and all-gathers the shards; the result
is the unsharded launch's bits, since each element is one exact product.

Bound on this card: memory, each element read once and written once (16 KiB
each way at (8, 512): about 1e-5 ms at 3.35 TB/s, far below one launch's
cost). Design: one program per 1024 elements, vector loads and stores.
"""

from __future__ import annotations

import functools

import torch

BLOCK = 1024


def scale_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """x * 2.0, in x's dtype."""
    return x * 2.0


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """Build the Triton kernel on first use (triton is imported here, never
    at module import: it exists only on the machine with the card)."""
    import triton
    import triton.language as tl

    @triton.jit
    def scale_probe_kernel(x_ptr, o_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        valid = offs < n
        x = tl.load(x_ptr + offs, mask=valid, other=0.0)
        tl.store(o_ptr + offs, x * 2.0, mask=valid)

    return scale_probe_kernel


def scale_probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the Triton kernel on a CUDA f32 tensor (a strided view is
    packed first); adds one to ``scale_probe_kernel.launches`` per
    launch."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"scale_probe_kernel: x must be a CUDA float32 "
                         f"tensor, got {x.device} {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        _triton_kernel()[(-(-n // BLOCK),)](x, out, n, BLOCK=BLOCK,
                                            num_warps=4)
        scale_probe_kernel.launches += 1
    return out


scale_probe_kernel.launches = 0


def scale_probe(x: torch.Tensor) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return scale_probe_plain(x)
    return scale_probe_kernel(x)
