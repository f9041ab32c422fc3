"""Per-rank kernel launches and the model's collectives under a process
mesh (the counterpart of ``sdvar_tpu/ops/partition.py``).

The JAX package wraps its Pallas kernels in ``shard_map`` because GSPMD
cannot partition a Mosaic call; here there is no GSPMD at all: every rank
holds its own shards (``parallel/mesh.py``) and launches the port's kernels
on them, and the model calls the collectives below where a value spans
ranks. What runs per rank:

  - attention: ``ops.attention.attention`` itself, on the rank's B/data
    batch rows and H/model heads, which is all the rank holds (the
    parameters are cut at load time, the KV cache is made at the local
    shape); no collective inside (softmax and the PV product contract over
    Lk and hd, which stay whole), so no wrapper either.
  - sampler: rows over "data"; the vocab-sharded logits are all-gathered
    over "model" first (top-k and top-p need whole rows), then the kernel
    samples this rank's rows with their per-row seeds, so every model rank
    draws the same ids.
  - the probe kernel (``ops/kernels/scale_probe.py``): each rank's "model"
    column shard, then an all-gather.

The TPU-only rules of the JAX wrappers stay behind (merged heads per shard
a multiple of 128 lanes, per-shard rows a multiple of 8): every shard runs
its kernel. A width that does not divide over "model" stays whole: each of
the four split widths (heads, FFN hidden, AdaLN 6C, vocab) decides for
itself (``model_split(n)``), and where one does not divide, every model
rank holds that layer's weights whole and computes it unsplit, with the
launches and collectives of the unsharded layer (where the JAX package
lets GSPMD partition the XLA composition). The batch rows must divide
over "data".

The registry (``set_tp_mesh``) is read at call time by ``models/var.py``,
``engine/decode.py`` and the KV caches. A 1x1 mesh is a no-op: the
unsharded kernels and no collective, as in the JAX package.
"""

from __future__ import annotations

import torch

from sdvar_tpu_torch.ops.kernels.sampling import (
    sample_kernel,
    sample_plain,
    sampler_takes,
)
from sdvar_tpu_torch.ops.kernels.scale_probe import scale_probe

DATA, MODEL = "data", "model"

_TP_MESH = None


def set_tp_mesh(mesh) -> None:
    """Register the mesh (``parallel.mesh.Mesh``) the model runs under;
    None unregisters it."""
    global _TP_MESH
    if mesh is not None and not (hasattr(mesh, "data") and hasattr(mesh, "model")):
        raise ValueError(f"set_tp_mesh: {mesh!r} is not a mesh")
    _TP_MESH = mesh


def get_tp_mesh():
    return _TP_MESH


def _active_mesh():
    m = _TP_MESH
    if m is None or m.data * m.model <= 1:
        return None
    return m


def tp_mesh_active() -> bool:
    """True when a mesh of more than one rank is registered."""
    return _active_mesh() is not None


def model_split(n: int) -> int:
    """The number of ranks that split a width ``n`` over "model": the
    mesh's model count where n divides it, else 1 (the width stays whole on
    every rank). 1 without a mesh."""
    m = _active_mesh()
    if m is None or n % m.model:
        return 1
    return m.model


def data_rows(n: int, what: str = "batch") -> slice:
    """This rank's contiguous slice of n rows split over "data"."""
    m = _active_mesh()
    return slice(0, n) if m is None else m.rows(n, what)


def reduce_model(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Sum or max over the ranks that split the model (in place)."""
    m = _active_mesh()
    return t if m is None else m.all_reduce(t, MODEL, op)


def reduce_data(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Sum or max over the ranks that split the batch (in place)."""
    m = _active_mesh()
    return t if m is None else m.all_reduce(t, DATA, op)


def gather_model(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' shards of t, concatenated on ``dim``."""
    m = _active_mesh()
    return t if m is None else m.all_gather(t, MODEL, dim)


def gather_data(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data ranks' rows of t, concatenated on ``dim`` in request
    order."""
    m = _active_mesh()
    return t if m is None else m.all_gather(t, DATA, dim)


def gather_vocab(t: torch.Tensor, vocab: int) -> torch.Tensor:
    """Whole rows of logits over a ``vocab``-wide head: all-gathered over
    "model" where the head's columns split (``model_split(vocab)``), else
    t itself (a whole head on every rank)."""
    if model_split(vocab) == 1:
        return t
    return gather_model(t, dim=-1)


def sharded_fused_sample(logits: torch.Tensor, seeds: torch.Tensor,
                         top_k: int, top_p: float, vocab: int) -> torch.Tensor:
    """(M, V/model) f32 logits of this rank's rows, split over "model" by
    vocab column (whole rows where a ``vocab``-wide head does not divide),
    and their (M,) int32 row seeds -> (M,) int32 ids: the vocab is
    all-gathered over "model", then the rows are sampled whole.

    This is the one place that picks the sampler. CPU tensors take its
    plain version; CUDA rows take the kernel at every width it takes
    (``sampler_takes``: a multiple of 4, so every width the TPU kernel
    takes), else ``sample_plain`` on the card (the kernel's bit reference
    on the same per-row seeds, so the stream stays one stream across
    widths), as the JAX package takes its XLA path at widths its kernel
    does not take. Those rows are counted in ``sample_kernel.plain_rows``."""
    full = gather_vocab(logits, vocab)
    if full.device.type == "cpu":
        return sample_plain(full, seeds, top_k, top_p)
    if not sampler_takes(full.shape[-1]):
        sample_kernel.plain_rows += full.shape[0]
        return sample_plain(full, seeds, top_k, top_p)
    return sample_kernel(full, seeds, top_k, top_p)


def sharded_scale_probe(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel (``o = x * 2.0``) on this rank's "model" column
    shard of the whole x, then all-gathered: the whole o on every rank."""
    m = _active_mesh()
    if m is None:
        return scale_probe(x)
    n = x.shape[-1]
    if n % m.model:
        raise ValueError(f"probe columns {n} do not divide over model="
                         f"{m.model}")
    per = n // m.model
    shard = x[..., m.model_index * per:(m.model_index + 1) * per]
    return gather_model(scale_probe(shard), dim=-1)
