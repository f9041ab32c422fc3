"""Whether the factored RMS's row and column means keep their bits when
taken one piece of a stacked leaf at a time (``train.trainer._pieces``:
a few layers along the depth axis) in place of over the whole leaf, at
the stacked weights' shapes of VAR-d16 and VAR-d36 512px. The mean over
the contiguous last axis reduces each output in one block whatever the
number of outputs; the mean over the strided middle axis is split over
blocks by PyTorch's CUDA reduction when the outputs are few, so a piece
may sum in another order than the whole leaf.

    python3 -m sdvar_tpu_torch.tools.probe_factored_pieces [--device cpu]

Prints one line per leaf and axis: the elements that differ from the
whole leaf's mean and the largest relative difference. Random gradients
from a seed, at 1e-3 (as ``tests/test_torch_train_gpu.py``'s). On the
card it then runs ``train.trainer.factored_rms_update`` on each leaf
alone (``peaks``) and prints the allocator's peak above what was
allocated when it started, with the op that reached it and what was
allocated before that op: where the factored RMS's added peak comes from.
"""

from __future__ import annotations

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sdvar_tpu_torch.train import trainer as T
from sdvar_tpu_torch.utils.device import card_name, resolve_device

SHAPES = {
    "d16 qkv_w": (16, 1024, 3072), "d16 fc1_w": (16, 1024, 4096),
    "d16 fc2_w": (16, 4096, 1024), "d16 ada_lin_w": (16, 1024, 6144),
    "d36-512 qkv_w": (36, 2304, 6912), "d36-512 proj_w": (36, 2304, 2304),
    "d36-512 fc1_w": (36, 2304, 9216), "d36-512 fc2_w": (36, 9216, 2304),
}


def run(device="cuda", shapes=None) -> dict:
    """{(leaf, axis): (elements differing, of, largest relative
    difference)} for each stacked shape of ``shapes`` (default
    ``SHAPES``)."""
    dev = resolve_device(device)
    print(f"[factored pieces] {card_name(dev)}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, shape in (shapes or SHAPES).items():
        x = torch.randn(shape, device=dev, generator=g) * 1e-3
        d1, d0 = T._factored_dims(shape)
        g2 = x * x
        g2.add_(T.FACTORED_EPS)
        whole = {ax: g2.mean(dim=ax) for ax in (d0, d1)}
        del g2
        parts = {d0: [], d1: []}
        pieces = T._pieces(x)
        for xs in pieces:
            g2 = xs * xs
            g2.add_(T.FACTORED_EPS)
            for ax in (d0, d1):
                parts[ax].append(g2.mean(dim=ax))
            del g2
        for ax in (d0, d1):
            got, want = torch.cat(parts[ax]), whole[ax]
            r = (int((got != want).sum()), want.numel(),
                 ((got - want).abs() / want.abs()).max().item())
            out[(name, ax)] = r
            kind = "contiguous" if ax == len(shape) - 1 else "strided"
            print(f"[factored pieces] {name} {tuple(shape)}: the mean over "
                  f"axis {ax} ({kind}) in {len(pieces)} pieces: {r[0]} of "
                  f"{r[1]} elements differ from the whole leaf's, largest "
                  f"relative difference {r[2]:.3e}", flush=True)
        del x, whole, parts
    return out


class _OpMemory(TorchDispatchMode):
    """Records, for each op, (name, MiB allocated before it, its peak MiB)
    above ``base``."""

    def __init__(self, base: int):
        super().__init__()
        self.base, self.rows = base, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = func(*args, **(kwargs or {}))
        torch.cuda.synchronize()
        self.rows.append((str(func), (before - self.base) / 2 ** 20,
                          (torch.cuda.max_memory_allocated() - self.base)
                          / 2 ** 20))
        return out


def peaks(device="cuda", shapes=None) -> dict:
    """{leaf: (leaf MiB, added peak MiB, the op at the peak, MiB allocated
    before that op)} of ``factored_rms_update`` on each leaf alone, on
    the card."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, shape in (shapes or SHAPES).items():
        p = {"w": torch.randn(shape, device=dev, generator=g) * 0.02}
        grads = {"w": torch.randn(shape, device=dev, generator=g) * 1e-3}
        state = T.init_opt_state(p, "adafactor")
        torch.cuda.synchronize()
        with _OpMemory(torch.cuda.memory_allocated()) as rec:
            T.factored_rms_update(p, grads, state, 1e-4, 0.05, {"w": True})
        op, before, top = max(rec.rows, key=lambda r: r[2])
        out[name] = (p["w"].numel() * 4 / 2 ** 20, top, op, before)
        print(f"[factored pieces] {name} {tuple(shape)}: factored_rms_update "
              f"alone adds {top:.1f} MiB at its peak, in {op} over the "
              f"{before:.1f} MiB allocated before it (the leaf: "
              f"{out[name][0]:.1f} MiB)", flush=True)
        del p, grads, state
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    run(device)
    if torch.device(device).type == "cuda":
        peaks(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
