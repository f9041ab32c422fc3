"""Scale-block attention masks for prefill and speculative verify (the
port's own copy of ``sdvar_tpu/ops/masks.py``, which is pure numpy; the
port imports nothing of the JAX package).

One parameterized family: the block-causal mask, SDVAR's "sd masking"
(causal minus intra-block), the intra-block-only mask, the six sd_mask
handoff prefill variants, the hidden-prefix decode mask and the
speculative verify-window mask. Built in numpy from the static scale
schedule, additive convention (0 = attend, -inf = masked).

``device_bias`` keeps each mask's tensor on a device per (device, mask,
args), so a verify round or a decode step reuses it instead of copying an
(Lq, kv_len) f32 bias from the host every time.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = float("-inf")


def scale_ids(patch_nums: Sequence[int]) -> np.ndarray:
    """Token -> scale index, shape (L,)."""
    return np.concatenate(
        [np.full(pn * pn, i, dtype=np.int64) for i, pn in enumerate(patch_nums)]
    )


@functools.lru_cache(maxsize=None)
def block_causal_bias(patch_nums: Tuple[int, ...]) -> np.ndarray:
    """(L, L) bias: query scale i attends key scale j iff i >= j."""
    d = scale_ids(patch_nums)
    return np.where(d[:, None] >= d[None, :], 0.0, NEG_INF).astype(np.float32)


@functools.lru_cache(maxsize=None)
def block_causal_prefix(patch_nums: Tuple[int, ...], ed: int) -> np.ndarray:
    """The first ``ed`` tokens' (ed, ed) block of ``block_causal_bias``, a
    contiguous array of its own (the progressive-training sequence; the
    attention kernel takes a packed bias)."""
    return np.ascontiguousarray(block_causal_bias(patch_nums)[:ed, :ed])


@functools.lru_cache(maxsize=None)
def sd_masking_bias(patch_nums: Tuple[int, ...]) -> np.ndarray:
    """(L, L) bias: causal-by-token, but within one's own scale only self-
    attention (reference attn_bias_for_sdmasking, models/var.py:557-569)."""
    L = sum(pn * pn for pn in patch_nums)
    d = scale_ids(patch_nums)
    i = np.arange(L)
    causal = i[:, None] >= i[None, :]
    same_block = d[:, None] == d[None, :]
    diag = i[:, None] == i[None, :]
    allowed = causal & (~same_block | diag)
    return np.where(allowed, 0.0, NEG_INF).astype(np.float32)


@functools.lru_cache(maxsize=None)
def block_only_bias(patch_nums: Tuple[int, ...]) -> np.ndarray:
    """(L, L) bias allowing attention only within the same scale
    (reference attn_bias_for_block, models/var.py:571-578)."""
    d = scale_ids(patch_nums)
    return np.where(d[:, None] == d[None, :], 0.0, NEG_INF).astype(np.float32)


def prefill_bias(patch_nums: Tuple[int, ...], entry_num: int,
                 sd_mask: int) -> np.ndarray | None:
    """Mask for the handoff prefill over tokens [0, exit_points[entry_num]).

    Mirrors the six sd_mask ablation modes (reference: models/var.py:777-824):
      0: no mask; 1: sd-masking; 2: sd-masking with the current (being
      predicted) scale's rows unmasked; 3: block-causal; 4: block-only;
      5: block-only with current rows unmasked.
    Returns (P, P) bias or None for mode 0.
    """
    ends = np.cumsum([pn * pn for pn in patch_nums])
    starts = np.concatenate([[0], ends[:-1]])
    P = int(ends[entry_num])  # prefill covers scales [0, entry_num] inputs
    s = int(starts[entry_num])  # rows of the scale predicted at the handoff
    if sd_mask == 0:
        return None
    if sd_mask in (1, 2):
        bias = sd_masking_bias(tuple(patch_nums))[:P, :P].copy()
    elif sd_mask == 3:
        bias = block_causal_bias(tuple(patch_nums))[:P, :P].copy()
    elif sd_mask in (4, 5):
        bias = block_only_bias(tuple(patch_nums))[:P, :P].copy()
    else:
        raise ValueError(f"sd_mask must be 0..5, got {sd_mask}")
    if sd_mask in (2, 5):
        bias[s:P, :] = 0.0
    return bias.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hidden_prefix_decode_bias(patch_nums: Tuple[int, ...], si: int,
                              hide_upto: int) -> np.ndarray:
    """(pn_si^2, ed_si) decode-step bias hiding key columns [0, hide_upto).

    Emulates the committed reference sd_test3 mode-0 cache, which never
    contains the drafted prefix (the entry forward runs on the entry slice
    alone, models/var.py:817-824), so every later scale attends only keys
    from the entry scale onward."""
    ends = np.cumsum([pn * pn for pn in patch_nums])
    ed = int(ends[si])
    n = patch_nums[si] ** 2
    bias = np.zeros((n, ed), dtype=np.float32)
    bias[:, :hide_upto] = NEG_INF
    return bias


@functools.lru_cache(maxsize=None)
def verify_window_bias(patch_nums: Tuple[int, ...], start_scale: int,
                       gamma: int, kv_len: int) -> np.ndarray:
    """(Lq, kv_len) bias for batched verification of ``gamma`` scales
    starting at ``start_scale`` against a KV cache of length ``kv_len``.

    Queries are the window's tokens; keys are [accepted prefix | window].
    Prefix keys are fully visible; within the window, scale i attends scale
    j iff i >= j (block-causal), matching what the baseline decode would
    compute scale-by-scale.
    """
    window = patch_nums[start_scale : start_scale + gamma]
    Lq = sum(pn * pn for pn in window)
    prefix = kv_len - Lq
    assert prefix >= 0, (kv_len, Lq)
    d = np.concatenate(
        [np.full(pn * pn, i, dtype=np.int64) for i, pn in enumerate(window)]
    )
    bias = np.full((Lq, kv_len), NEG_INF, dtype=np.float32)
    bias[:, :prefix] = 0.0
    allowed = d[:, None] >= d[None, :]
    bias[:, prefix:] = np.where(allowed, 0.0, NEG_INF)
    return bias


@functools.lru_cache(maxsize=None)
def device_bias(device: torch.device, fn: Callable, *args
                ) -> Optional[torch.Tensor]:
    """``fn(*args)`` (one of the masks above) as a float32 tensor on
    ``device``, made once per (device, fn, args); None where ``fn`` gives
    None (sd_mask 0). The tensors are shared: callers must not write to
    them. Made outside inference mode even when a decode asks first, so
    that the training attention can save the bias for its backward."""
    a = fn(*args)
    if a is None:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
