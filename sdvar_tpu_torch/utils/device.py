"""Device resolution and the f32 numerics setting shared by the port's
entry points."""

from __future__ import annotations

import contextlib
import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise when a CUDA device is asked
    for and no card is present (an entry point never drops to the CPU on
    its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sdvar_tpu_torch: a CUDA device was requested but none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:  # "cuda" names the current card: cuda:N
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def _tf32_allowed(allow: bool):
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def full_f32():
    """Run f32 matmuls and cuDNN convolutions in full f32 (TF32 off) inside
    the block, and restore the caller's settings on exit. Used as a
    decorator on the decode and pixel-decode entry points: the head, the
    resizes, the phi convs and the pixel decoder are f32 by design (the JAX
    reference runs them at ``Precision.HIGHEST``), and cuDNN would otherwise
    run f32 convolutions in TF32."""
    return _tf32_allowed(False)


def tf32():
    """Let f32 matmuls and cuDNN convolutions take TF32 inside the block
    (the pixel decoder's ``precision="high"``), and restore the caller's
    settings on exit. No effect on the CPU."""
    return _tf32_allowed(True)


def card_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, for a CUDA device;
    "cpu" for the CPU (where a tool's times are the CPU's, never the
    card's)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def synchronize(device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
