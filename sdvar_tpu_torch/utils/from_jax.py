"""Weight bridge: the JAX package's parameter trees -> the port's.

The port keeps the JAX package's parameter layout (nested dicts and lists,
per-layer tensors stacked on ``depth``, linear weights (in, out), conv
kernels OIHW), so the bridge is a structural copy that checks the tree and
moves every leaf to a tensor on the target device. It never imports JAX:
callers pass the tree as numpy arrays (``jax.tree.map(np.asarray, p)``).
bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) are carried over bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sdvar_tpu_torch.utils.device import resolve_device

_VAR_KEYS = ("word_embed", "class_emb", "pos_start", "pos_1LC", "lvl_embed",
             "blocks", "head_nm", "head")
_VQVAE_KEYS = ("encoder", "decoder", "quant_conv", "post_quant_conv", "quant")


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _to_tensor(tree, device)


def _check_keys(tree, keys, what: str) -> None:
    missing = [k for k in keys if k not in tree]
    if missing:
        raise KeyError(f"{what} parameter tree lacks {missing}")


def var_params_from_jax(tree, device="cuda"):
    """VAR parameters (``sdvar_tpu.models.var.init_var_params`` layout)."""
    _check_keys(tree, _VAR_KEYS, "VAR")
    return _convert(tree, resolve_device(device))


def vqvae_params_from_jax(tree, device="cuda"):
    """VQVAE parameters including ``quant`` (``init_vqvae_params`` layout)."""
    _check_keys(tree, _VQVAE_KEYS, "VQVAE")
    _check_keys(tree["quant"], ("codebook", "phi_w", "phi_b"), "quantizer")
    return _convert(tree, resolve_device(device))
