"""The process mesh and its sharding rules (the counterpart of
``sdvar_tpu/parallel/mesh.py``).

A ``Mesh`` is a (data, model) grid of ranks, one process per rank: rank r
sits at data index r // model and model index r % model. The ranks of one
data index split the model between them (their ``model_group``); the ranks
of one model index split the batch (their ``data_group``). There is no
GSPMD here: each rank holds its own shard of the parameters, of the KV
cache and of the batch, and the model calls the collectives it needs
(``ops/partition.py``).

Parameters are split Megatron-style over "model": qkv and fc1 by output
column (heads, FFN hidden), proj and fc2 by input row, AdaLN's 6C output
and the vocab head by column. qkv's columns split head-aligned within
each of q, k and v (``MODEL_QKV``), since the model views them as
(B, L, 3, H, hd); ``scale_mul``, per head, goes with its heads. Each of
the four widths splits only where it divides the model count; the
weights of a width that does not stay whole on every rank
(``var_param_specs(cfg, mesh)``), and the model computes that layer
unsplit (``ops.partition.model_split``). The KV
cache splits its batch rows over "data" and its merged heads over "model";
the batch splits over "data" in contiguous slices.

A spec is a tuple with one entry per axis: None (whole), ``DATA``,
``MODEL`` or ``MODEL_QKV``; a spec of None keeps a whole subtree. A 1x1
mesh cuts nothing. ``unshard_tree`` gathers a whole tree back from the
shards (checkpoints of a mesh run); the optimizer state takes its
parameter's spec (``train.trainer.opt_state_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from sdvar_tpu_torch.config import MeshConfig, VARConfig
from sdvar_tpu_torch.ops.partition import DATA, MODEL
from sdvar_tpu_torch.ops.quantization import QUANTIZED, W8A8Linear, as_w8a8
from sdvar_tpu_torch.parallel import distributed as D

MODEL_QKV = "model/qkv"  # split over "model" within each third (q, k, v)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a (data, model) mesh: the shape, its own
    coordinates and the groups of its two axes (None where an axis has
    one rank, so that its collectives are no-ops)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    model_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA: self.data, MODEL: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def _axis(self, axis: str):
        if axis == MODEL:
            return self.model, self.model_index, self.model_group
        if axis == DATA:
            return self.data, self.data_index, self.data_group
        raise ValueError(f"unknown mesh axis {axis!r} ({DATA} | {MODEL})")

    def all_reduce(self, t: torch.Tensor, axis: str = MODEL,
                   op: str = "sum") -> torch.Tensor:
        """Sum or max of t over the ranks of ``axis``; every rank gets the
        same bits. Returns t, reduced in place (a contiguous copy if t was
        not contiguous)."""
        n, _, group = self._axis(axis)
        if n == 1:
            return t
        t = t.contiguous()
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t

    def all_reduced(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` into a new tensor: t is left as it was, so
        the result can stand in an autograd graph (the collectives with
        gradients of ``ops/partition.py``)."""
        n, _, group = self._axis(axis)
        if n == 1:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    def all_gather(self, t: torch.Tensor, axis: str = MODEL,
                   dim: int = -1) -> torch.Tensor:
        """The ranks' t of ``axis``, concatenated on ``dim`` in rank
        order."""
        n, _, group = self._axis(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def rows(self, n: int, what: str = "batch") -> slice:
        """This rank's contiguous slice of n rows split over "data"."""
        if n % self.data:
            raise ValueError(f"{what} {n} does not divide over data="
                             f"{self.data}")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of the joined process group (``distributed.initialize``):
    ``cfg`` defaults to (1, world size), and data x model must be the world
    size. Every rank calls it, in the same order as its other meshes (the
    axis groups are made collectively)."""
    world, rank = D.get_world_size(), D.get_rank()
    cfg = cfg if cfg is not None else MeshConfig(data=1, model=world)
    if cfg.data < 1 or cfg.model < 1 or cfg.data * cfg.model != world:
        raise ValueError(f"mesh data={cfg.data} x model={cfg.model} does not "
                         f"match the {world} process(es) of the group")
    mesh = Mesh(cfg.data, cfg.model, rank)
    if world == 1:
        return mesh
    for d in range(cfg.data):  # the ranks of data index d split the model
        ranks = [d * cfg.model + m for m in range(cfg.model)]
        if cfg.model > 1:
            g = dist.new_group(ranks, timeout=D.TIMEOUT)
            if rank in ranks:
                mesh.model_group = g
    for m in range(cfg.model):  # the ranks of model index m split the batch
        ranks = [d * cfg.model + m for d in range(cfg.data)]
        if cfg.data > 1:
            g = dist.new_group(ranks, timeout=D.TIMEOUT)
            if rank in ranks:
                mesh.data_group = g
    return mesh


def single_device_mesh() -> Mesh:
    """A 1x1 mesh of this process alone: every collective a no-op."""
    return Mesh(1, 1, 0)


def var_splits(cfg: VARConfig, model: int) -> Dict[str, bool]:
    """Which of VAR's four split widths divide over ``model`` ranks (True:
    split; False: held whole on every rank)."""
    return {what: n % model == 0
            for what, n in (("heads", cfg.num_heads),
                            ("FFN hidden", cfg.mlp_hidden),
                            ("AdaLN 6C", 6 * cfg.embed_dim),
                            ("vocab", cfg.vocab_size))}


def var_param_specs(cfg: VARConfig, mesh: Mesh) -> dict:
    """The spec tree of VAR's parameters (tensor parallel over "model") on
    ``mesh``: the parameters of a width that does not divide its model
    count are whole (``var_splits``)."""
    split = var_splits(cfg, mesh.model)

    def by(what, *spec):
        return spec if split[what] else tuple(None for _ in spec)

    blocks = {
        "qkv_w": by("heads", None, None, MODEL_QKV),
        "q_bias": by("heads", None, MODEL),
        "v_bias": by("heads", None, MODEL),
        "proj_w": by("heads", None, MODEL, None),
        "proj_b": (None, None),
        "fc1_w": by("FFN hidden", None, None, MODEL),
        "fc1_b": by("FFN hidden", None, MODEL),
        "fc2_w": by("FFN hidden", None, MODEL, None),
        "fc2_b": (None, None),
    }
    if cfg.attn_l2_norm:
        blocks["scale_mul"] = by("heads", None, MODEL)  # per head
    if cfg.shared_aln:
        blocks["ada_gss"] = (None, None, None, None)
    else:
        blocks["ada_lin_w"] = by("AdaLN 6C", None, None, MODEL)
        blocks["ada_lin_b"] = by("AdaLN 6C", None, MODEL)
    specs = {
        "word_embed": {"w": (None, None), "b": (None,)},
        "class_emb": (None, None),
        "pos_start": (None, None),
        "pos_1LC": (None, None),
        "lvl_embed": (None, None),
        "blocks": blocks,
        "head_nm": {"w": (None, None), "b": (None,)},
        "head": {"w": by("vocab", None, MODEL), "b": by("vocab", MODEL)},
    }
    if cfg.shared_aln:
        specs["shared_ada_lin"] = {"w": by("AdaLN 6C", None, MODEL),
                                   "b": by("AdaLN 6C", MODEL)}
    return specs


def _cut(a: torch.Tensor, spec: tuple, mesh: Mesh, name: str) -> torch.Tensor:
    for axis, entry in enumerate(spec):
        if entry is None:
            continue
        n, i, _ = mesh._axis(DATA if entry == DATA else MODEL)
        if n == 1:
            continue
        size = a.shape[axis]
        parts = 3 if entry == MODEL_QKV else 1
        if size % (parts * n):
            raise ValueError(f"{name}: dimension {axis} ({size}) does not "
                             f"divide over {entry}={n}")
        per = size // parts // n
        a = a.unflatten(axis, (parts, size // parts))
        a = a.narrow(axis + 1, i * per, per).flatten(axis, axis + 1)
    return a.contiguous()


def _leaf(a, spec: tuple, mesh: Mesh, name: str):
    if isinstance(a, QUANTIZED):
        # q takes the weight's spec; the per-output-channel scale the spec
        # without the contraction (input) axis: split with the columns of
        # qkv/fc1/head, whole for the row-split proj/fc2
        q = _cut(a.q, spec, mesh, name)
        s = _cut(a.scale, tuple(spec[:-2]) + tuple(spec[-1:]), mesh, name)
        return as_w8a8(q, s) if isinstance(a, W8A8Linear) else type(a)(q, s)
    return _cut(a, spec, mesh, name)


def shard_tree(tree, specs, mesh: Mesh, _path: str = ""):
    """This rank's shard of a full parameter tree under a matching spec
    tree; quantized leaves as ``_leaf`` says (a ``W8A8Linear`` stays
    K-major). A spec of None keeps its whole subtree as it is (a step
    count, a replicated part). Raises ``ValueError`` naming the leaf whose
    dimension does not divide the mesh."""
    if specs is None:
        return tree
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(f"{_path or 'tree'}: the spec tree does not match "
                             f"the parameter tree")
        return {k: shard_tree(v, specs[k], mesh, f"{_path}/{k}")
                for k, v in tree.items()}
    return _leaf(tree, specs, mesh, _path)


def _uncut(a: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    for axis, entry in enumerate(spec):
        if entry is None:
            continue
        axis_name = DATA if entry == DATA else MODEL
        n = mesh._axis(axis_name)[0]
        if n == 1:
            continue
        parts = 3 if entry == MODEL_QKV else 1
        a = a.unflatten(axis, (parts, a.shape[axis] // parts))
        a = mesh.all_gather(a, axis_name, dim=axis + 1).flatten(axis, axis + 1)
    return a


def unshard_tree(tree, specs, mesh: Mesh, _path: str = ""):
    """The inverse of ``shard_tree`` for float leaves: the whole tree from
    this rank's shards, all-gathered over the axes each spec splits (every
    rank of the mesh calls it, in the same order: the gathers are
    collective). Checkpoints of a mesh run write what it returns."""
    if specs is None:
        return tree
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(f"{_path or 'tree'}: the spec tree does not match "
                             f"the parameter tree")
        return {k: unshard_tree(v, specs[k], mesh, f"{_path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, QUANTIZED):
        raise ValueError(f"{_path}: unshard_tree takes float leaves only")
    return _uncut(tree, specs, mesh)
