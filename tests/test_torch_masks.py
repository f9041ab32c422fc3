"""The port's copy of the scale-block masks equals the JAX package's
(``sdvar_tpu/ops/masks.py``, pure numpy) array for array, and the device
cache hands out one tensor per (device, mask, args)."""

import numpy as np
import pytest
import torch

from sdvar_tpu.config import PATCH_NUMS_256
from sdvar_tpu.ops import masks as J
from sdvar_tpu_torch.ops import masks as T

PRESETS = [(1, 2, 3, 4), PATCH_NUMS_256]


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pns", PRESETS, ids=["pns4", "256px"])
def test_whole_sequence_masks_equal(pns):
    _equal(T.scale_ids(pns), J.scale_ids(pns))
    for name in ("block_causal_bias", "sd_masking_bias", "block_only_bias"):
        _equal(getattr(T, name)(pns), getattr(J, name)(pns))


@pytest.mark.parametrize("pns", PRESETS, ids=["pns4", "256px"])
@pytest.mark.parametrize("sd_mask", range(6))
def test_prefill_bias_equal(pns, sd_mask):
    for entry in range(len(pns)):
        _equal(T.prefill_bias(pns, entry, sd_mask),
               J.prefill_bias(pns, entry, sd_mask))
    with pytest.raises(ValueError):
        T.prefill_bias(pns, 1, 6)


@pytest.mark.parametrize("pns", PRESETS, ids=["pns4", "256px"])
def test_verify_window_bias_equal(pns):
    S = len(pns)
    ends = np.cumsum([p * p for p in pns])
    for start in range(S):
        for gamma in range(1, min(3, S - start) + 1):
            kv_len = int(ends[start + gamma - 1])
            _equal(T.verify_window_bias(pns, start, gamma, kv_len),
                   J.verify_window_bias(pns, start, gamma, kv_len))


@pytest.mark.parametrize("pns", PRESETS, ids=["pns4", "256px"])
def test_hidden_prefix_decode_bias_equal(pns):
    ends = [0, *np.cumsum([p * p for p in pns])]
    for si in range(len(pns)):
        for hide in sorted({0, 1, int(ends[si]) // 2, int(ends[si])}):
            _equal(T.hidden_prefix_decode_bias(pns, si, hide),
                   J.hidden_prefix_decode_bias(pns, si, hide))


def test_device_bias_is_made_once_per_args():
    cpu = torch.device("cpu")
    a = T.device_bias(cpu, T.verify_window_bias, (1, 2, 3, 4), 1, 2, 14)
    assert a is T.device_bias(cpu, T.verify_window_bias, (1, 2, 3, 4), 1, 2, 14)
    assert a is not T.device_bias(cpu, T.verify_window_bias, (1, 2, 3, 4), 2, 2, 30)
    assert a.dtype == torch.float32 and a.is_contiguous()
    np.testing.assert_array_equal(
        a.numpy(), J.verify_window_bias((1, 2, 3, 4), 1, 2, 14))
    assert T.device_bias(cpu, T.prefill_bias, (1, 2, 3, 4), 2, 0) is None
