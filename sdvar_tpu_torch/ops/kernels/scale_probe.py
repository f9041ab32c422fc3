"""The multi-device probe kernel: the CUDA kernel's wrapper and its plain
version.

Replaces the JAX package's ``kern`` (``tests/test_tp_pallas.py:194-203``),
``o = x * 2.0`` on an (8, 512) f32 array: the Pallas call that proves GSPMD
cannot partition a Mosaic kernel whose operand is split over "model", which
is why the JAX package launches its kernels per shard (``shard_map``). The
port's sharded form (``ops.partition.sharded_scale_probe``) launches this
kernel on each rank's column shard and all-gathers the shards; the result
is the unsharded launch's bits, since each element is one exact product.

The kernel lives in ``sdvar_tpu_torch/csrc/scale_probe.cu`` (CUDA C++ for
sm_90a, loaded with ctypes); its source note gives the bound (bytes, far
below one launch's cost) and why it replaced a Triton kernel (the launch
path).
"""

from __future__ import annotations

import ctypes

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.utils.profiling import launch


def scale_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """x * 2.0, in x's dtype."""
    return x * 2.0


_fn = None


def _lib():
    """The C entry point, bound once: the probe's launch is its whole cost,
    so a call does no more than it must (no lock, no lookup)."""
    global _fn
    if _fn is None:
        fn = _build.load("scale_probe").sdvar_scale_probe
        P = ctypes.c_void_p
        fn.argtypes = [P, P, ctypes.c_longlong, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def scale_probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA f32 tensor (a strided view is packed
    first); adds one to ``scale_probe_kernel.launches`` per launch."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"scale_probe_kernel: x must be a CUDA float32 "
                         f"tensor, got {x.device} {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        with launch("sdvar.launch.scale_probe"):
            err = _lib()(x.data_ptr(), out.data_ptr(), n,
                         torch._C._cuda_getCurrentRawStream(x.get_device()))
        if err != 0:
            raise RuntimeError(f"scale_probe_kernel: launch failed with "
                               f"cudaError {err}")
        scale_probe_kernel.launches += 1
    return out


scale_probe_kernel.launches = 0


def scale_probe(x: torch.Tensor) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return scale_probe_plain(x)
    return scale_probe_kernel(x)
