"""Weight bridge: the JAX package's parameter trees -> the port's.

The port keeps the JAX package's parameter layout (nested dicts and lists,
per-layer tensors stacked on ``depth``, linear weights (in, out), conv
kernels OIHW), so the bridge is a structural copy that checks the tree and
moves every leaf to a tensor on the target device. It never imports JAX:
callers pass the tree as numpy arrays (``jax.tree.map(np.asarray, p)``).
bfloat16 and float8_e4m3fn leaves (numpy's ``ml_dtypes`` types) are carried
over bit for bit, through their raw bytes. Quantized leaves of ``quantize_var_params`` reach the bridge as the
JAX package's NamedTuples of numpy arrays (``jax.tree.map`` keeps the
type); they are recognised by class name and fields, without importing the
JAX package, and become the port's class of the same meaning. Any other
tuple raises: the bridge never guesses what a tuple holds.
"""

from __future__ import annotations

import numpy as np
import torch

from sdvar_tpu_torch.ops.conv_s8 import SITE_KEYS, site_from_arrays
from sdvar_tpu_torch.ops.quantization import (
    FP8Linear,
    QuantizedLinear,
    W8A8Linear,
    as_w8a8,
)
from sdvar_tpu_torch.utils.device import resolve_device

_VAR_KEYS = ("word_embed", "class_emb", "pos_start", "pos_1LC", "lvl_embed",
             "blocks", "head_nm", "head")
_VQVAE_KEYS = ("encoder", "decoder", "quant_conv", "post_quant_conv", "quant")
_QUANTIZED = {cls.__name__: cls for cls in (QuantizedLinear, W8A8Linear, FP8Linear)}
# ml_dtypes types numpy knows only by name: (raw-byte view, torch dtype)
_RAW = {"bfloat16": (np.uint16, torch.bfloat16),
        "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    raw = _RAW.get(a.dtype.name)
    if raw is not None:
        return torch.from_numpy(a.view(raw[0])).view(raw[1]).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device) for v in tree]
    if isinstance(tree, tuple):
        name = type(tree).__name__
        cls = _QUANTIZED.get(name)
        if cls is None or getattr(tree, "_fields", None) != cls._fields:
            raise TypeError(f"weight bridge: cannot carry a {name} leaf "
                            f"(known quantized leaves: {sorted(_QUANTIZED)})")
        q, scale = (_to_tensor(a, device) for a in tree)
        want = torch.float8_e4m3fn if cls is FP8Linear else torch.int8
        if q.dtype != want:
            raise TypeError(f"weight bridge: {name}.q is {q.dtype}, not {want}")
        return as_w8a8(q, scale) if cls is W8A8Linear else cls(q, scale)
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


def pixel_sites_from_jax(sites, device="cuda"):
    """W8A8 pixel-decoder sites of the JAX package's
    ``calibrate_decoder_w8a8`` (a sequence of dicts of numpy ``wq`` int8,
    ``scale``, ``bias``, ``act_inv``, or ``None``) -> the port's tuple of
    ``ConvSite`` or ``None``, in the same order."""
    dev = resolve_device(device)
    out = []
    for i, site in enumerate(sites):
        if site is None:
            out.append(None)
            continue
        if not isinstance(site, dict) or set(site) != set(SITE_KEYS):
            raise TypeError(f"pixel site {i}: expected a dict of {SITE_KEYS} "
                            f"or None, got {type(site).__name__} "
                            f"{sorted(site) if isinstance(site, dict) else ''}")
        wq = np.asarray(site["wq"])
        if wq.dtype != np.int8 or wq.ndim != 4 or wq.shape[:2] != (3, 3):
            raise TypeError(f"pixel site {i}: wq must be int8 (3, 3, C, O), "
                            f"got {wq.dtype} {wq.shape}")
        floats = {k: np.asarray(site[k], np.float32) for k in SITE_KEYS[1:]}
        out.append(site_from_arrays({"wq": wq, **floats}, dev))
    return tuple(out)
