"""Checkpoints and auto-resume (the counterpart of
``sdvar_tpu/train/checkpoint.py``).

A checkpoint is a directory ``ckpt-<step, 8 digits>`` holding ``tree.pt``
(``torch.save`` of the state: params, optimizer state, step) and
``meta.json`` ({"step": ..., plus the caller's meta}), the JAX package's
naming and meta dict with a torch state file in place of orbax's. Only
the master process writes, into a temporary directory beside the target
that is renamed into place, so a reader never sees half a checkpoint.
``auto_resume`` loads the newest one.

On a mesh (``specs`` and ``mesh`` given: the spec tree of the state,
``train.trainer.train_state_specs``) every rank gathers the whole tree
from the shards (``parallel.mesh.unshard_tree``, collective), rank 0
writes it between two barriers, in the single-device format; a load reads
the whole tree on every rank and cuts this rank's shard
(``shard_tree``). So a mesh run resumes on one device, and back.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch

from sdvar_tpu_torch.parallel import distributed as D
from sdvar_tpu_torch.parallel.mesh import shard_tree, unshard_tree
from sdvar_tpu_torch.utils.logging import is_master


def _plain(tree: Any) -> Any:
    """A dataclass state as a dict of its fields (what is saved)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    return tree


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    meta: Optional[Dict[str, Any]] = None, specs=None,
                    mesh=None) -> str:
    """Write ``ckpt-<step>`` under ckpt_dir (master only; atomic); on a
    mesh the whole tree gathered from every rank's shard (every rank
    calls it). Returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt-{step:08d}"))
    if specs is not None and mesh is not None:
        whole = unshard_tree(_plain(tree), specs, mesh)
        D.barrier()
        try:
            return save_checkpoint(ckpt_dir, step, whole, meta)
        finally:
            D.barrier()
    if not is_master():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-", dir=ckpt_dir)
    try:
        torch.save(_plain(tree), os.path.join(tmp, "tree.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    return path


def _check_like(got: Any, want: Any, where: str = "tree") -> None:
    """Raise unless ``got`` has ``want``'s structure and tensor shapes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint {where}: keys differ from the "
                             f"template's")
        for k in want:
            _check_like(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"checkpoint {where}: length differs")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_like(g, w, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape:
            raise ValueError(f"checkpoint {where}: shape "
                             f"{tuple(getattr(got, 'shape', ()))} against "
                             f"the template's {tuple(want.shape)}")


def _device_of(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


def load_checkpoint(path: str, template: Any, specs=None,
                    mesh=None) -> Tuple[Any, Dict]:
    """Read a checkpoint into ``template``'s structure, shapes and device
    (a mismatch raises); on a mesh the template is this rank's shard and
    the whole tree read is cut by ``specs``. Returns (tree, meta); the
    tree is a dataclass of the template's class when the template is
    one."""
    want = _plain(template)
    dev = _device_of(want)
    tree = torch.load(os.path.join(path, "tree.pt"), map_location=dev,
                      weights_only=True)
    if specs is not None and mesh is not None:
        tree = shard_tree(tree, specs, mesh)  # raises on another structure
    _check_like(tree, want)
    meta = {"step": 0}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        tree = type(template)(**tree)
    return tree, meta


def auto_resume(ckpt_dir: str, template: Any, specs=None,
                mesh=None) -> Tuple[Optional[Any], Dict]:
    """The newest checkpoint under ckpt_dir (by modification time, then by
    name) that loads into ``template`` (on a mesh: cut by ``specs``);
    (None, {"step": 0}) if none does."""
    cands = glob.glob(os.path.join(ckpt_dir, "ckpt-*"))
    for path in sorted(cands, key=lambda p: (os.path.getmtime(p), p),
                       reverse=True):
        try:
            return load_checkpoint(path, template, specs, mesh)
        except Exception as e:  # keep trying older checkpoints
            print(f"[auto_resume] failed to load {path}: {e}")
    return None, {"step": 0}
