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
``engine/decode.py``, the KV caches and ``train/trainer.py``. A 1x1 mesh
is a no-op: the unsharded kernels and no collective, as in the JAX
package.

Training differentiates through the model's collectives: ``copy_to_model``,
``reduce_from_model`` and ``gather_from_model`` are their autograd forms
(below), and ``mean_over_data`` averages the gradients over "data".
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
# f32 elements in one all-reduce of ``mean_over_data`` (256 MiB): d16's
# 1.2 GB of gradients go in five calls, not one a leaf.
DATA_BUCKET = 1 << 26

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


# ---------------------------------------------------------------------------
# collectives with gradients (the training forward)
# ---------------------------------------------------------------------------
#
# GSPMD gives the JAX package the gradient of every collective it inserts;
# here each is a ``torch.autograd.Function``, Megatron's pair and a gather:
#
#   copy_to_model      identity forward,   all-reduce (sum) over "model" backward
#   reduce_from_model  all-reduce forward, identity backward
#   gather_from_model  all-gather forward, this rank's slice backward
#
# Each is placed only at a layer whose width splits (``model_split(n) > 1``):
# a replicated value x that feeds a split layer goes through copy_to_model,
# so that its gradient sums every rank's share; the split partial products
# come back through reduce_from_model or gather_from_model, whose output is
# replicated, and whose incoming gradient is then the same on every model
# rank. A width held whole on every rank takes none of them (its gradient
# is whole on each rank already; an all-reduce would multiply it by the
# model count). Without gradients (inference, eval) they fall back to the
# in-place forms above, with their bits.


def _recording(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduced(g, MODEL), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduced(x, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.per = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.model_index
        return g.narrow(ctx.dim, i * ctx.per, ctx.per).contiguous(), None, None


def copy_to_model(x: torch.Tensor, n: int) -> torch.Tensor:
    """x, a value every model rank holds, entering a layer of width ``n``
    that splits over "model": itself forward; its gradient summed over the
    model ranks backward. A no-op where n does not split, without a mesh
    or without gradients."""
    if model_split(n) == 1 or not _recording(x):
        return x
    return _CopyToModel.apply(x, _active_mesh())


def reduce_from_model(x: torch.Tensor, n: int) -> torch.Tensor:
    """The sum over the model ranks of their partial products of a layer
    whose ``n`` input rows split (proj, fc2): an all-reduce into a new
    tensor forward, the gradient as it is backward. Without gradients the
    in-place ``reduce_model``; x itself where n does not split."""
    if model_split(n) == 1:
        return x
    if not _recording(x):
        return reduce_model(x)
    return _ReduceFromModel.apply(x, _active_mesh())


def gather_from_model(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """The model ranks' column shards of a width-``n`` output (AdaLN's 6C,
    the vocab), concatenated on ``dim``: forward an all-gather, backward
    this rank's slice of the gradient. Without gradients
    ``gather_model``; x itself where n does not split."""
    if model_split(n) == 1:
        return x
    if not _recording(x):
        return gather_model(x, dim)
    return _GatherFromModel.apply(x, _active_mesh(), dim % x.dim())


def data_count() -> int:
    """The number of ranks that split the batch (1 without a mesh)."""
    m = _active_mesh()
    return 1 if m is None else m.data


def mean_over_data(tensors):
    """The mean over the data ranks of each of ``tensors`` (gradients,
    metrics), new tensors of their shapes and dtypes: flattened into f32
    buckets of at most ``DATA_BUCKET`` elements, one all-reduce a bucket,
    then divided by the data count. The list itself without a data split."""
    tensors = list(tensors)
    m = _active_mesh()
    if m is None or m.data == 1:
        return tensors
    out, i = [], 0
    while i < len(tensors):
        j, size = i, 0
        while j < len(tensors) and (
                j == i or size + tensors[j].numel() <= DATA_BUCKET):
            size += tensors[j].numel()
            j += 1
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors[i:j]])
        m.all_reduce(flat, DATA)
        flat = flat / m.data
        for t, part in zip(tensors[i:j], flat.split([t.numel() for t in tensors[i:j]])):
            out.append(part.view(t.shape).to(t.dtype))
        i = j
    return out


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
