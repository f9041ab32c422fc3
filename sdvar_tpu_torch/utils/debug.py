"""NaN and anomaly debugging over trees of tensors (the counterpart of
``sdvar_tpu/utils/debug.py``).

Three levels, as in the JAX package:
  1. ``enable_debug_nans()``: autograd's anomaly mode
     (``torch.autograd.set_detect_anomaly``): a backward op that returns
     NaN raises, with the forward's stack trace of the op. Slow; for
     repros.
  2. ``checked(fn)``: ``fn`` whose outputs are checked; a NaN or inf in
     any output raises ``FloatingPointError`` with the per-leaf report.
     ``checked_grad_probe`` runs one forward and backward under anomaly
     mode and names the parameter leaves whose gradient is not finite.
  3. ``nan_report(tree)``: which leaves of a tree (parameters, gradients,
     metrics) hold NaN or inf, for triage after the fact; the training
     loop's ``dbg_nan`` mode prints it.

``rng_fingerprint`` hashes a ``torch.Generator``'s state, to chase a
reproducibility fault across runs and ranks.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def enable_debug_nans(enable: bool = True) -> None:
    """Autograd anomaly mode on (or off) for the whole process: a backward
    function that returns NaN raises ``RuntimeError`` naming it."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree: Any, path: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def nan_report(tree: Any, name: str = "tree") -> List[str]:
    """One line per floating leaf holding NaN or inf:
    ``name/path: nan=a inf=b of n``; empty when the tree is clean. Leaves
    are tensors (on any device), numpy arrays or Python floats; integer
    leaves are skipped."""
    lines: List[str] = []
    for path, leaf in _leaves(tree, name):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            x = leaf.detach()
            n_nan, n_inf = int(torch.isnan(x).sum()), int(torch.isinf(x).sum())
            size = x.numel()
        else:
            a = np.asarray(leaf)
            if not np.issubdtype(a.dtype, np.floating):
                continue
            n_nan, n_inf, size = int(np.isnan(a).sum()), int(np.isinf(a).sum()), a.size
        if n_nan or n_inf:
            lines.append(f"{path}: nan={n_nan} inf={n_inf} of {size}")
    return lines


def first_bad_leaf(tree: Any, name: str = "tree") -> Optional[str]:
    """The path of the first leaf with NaN or inf, or None."""
    lines = nan_report(tree, name)
    return lines[0].split(":")[0] if lines else None


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` with the per-leaf report when a leaf
    holds NaN or inf."""
    lines = nan_report(tree, name)
    if lines:
        raise FloatingPointError(
            f"non-finite values in {name} ({len(lines)} leaves):\n"
            + "\n".join(lines[:20]))


def checked(fn: Callable, name: str = "output") -> Callable:
    """``fn`` whose return value (a tensor or a tree of them) must be
    finite: ``checked(fn)(*args)`` returns what ``fn`` returns, or raises
    ``FloatingPointError`` with the report of the bad leaves."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name)
        return out

    return wrapped


def checked_grad_probe(loss_fn: Callable, params: Any, *args: Any
                       ) -> Tuple[Any, torch.Tensor]:
    """One forward and backward of ``loss_fn(params, *args) -> (loss,
    aux)`` under anomaly mode; ``params`` is a tree of float tensors.
    Returns (grads, loss), the gradients a tree of ``params``' structure,
    when the loss and every gradient are finite; else raises
    ``FloatingPointError`` naming the bad leaves (``grads/<path>``) or,
    for a NaN inside the backward, the function that made it."""
    leaves = [p for _, p in _leaves(params, "")]
    inputs = [p.detach().requires_grad_() for p in leaves]
    it = iter(inputs)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v) for v in tree)
        return next(it)

    probe = rebuild(params)
    with torch.autograd.set_detect_anomaly(True):
        loss, _ = loss_fn(probe, *args)
        assert_finite(loss, "loss")
        try:
            grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                        materialize_grads=True)
        except RuntimeError as e:
            raise FloatingPointError(f"backward: {e}") from e
    it = iter(grads)
    grads = rebuild(params)
    assert_finite(grads, "grads")
    return grads, loss.detach()


def rng_fingerprint(generator: torch.Generator) -> str:
    """A stable 16-hex-digit digest of a generator's state: equal for
    generators seeded alike and at the same point of their streams."""
    raw = generator.get_state().cpu().numpy().tobytes()
    return hashlib.sha1(raw).hexdigest()[:16]
