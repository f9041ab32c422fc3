"""The training tools on the card (marked ``gpu``; skipped where there is
no card): ``bench_train varonly`` and one ``profile_train`` step at a
small width, with kernel row 1's launches counted. Torch only, so that
they run where JAX is absent:
    python -m pytest tests/test_torch_train_tools_gpu.py -q -m gpu -o addopts="" --noconftest
"""

import math

import pytest
import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.ops.kernels.attention import attention_kernel
from sdvar_tpu_torch.tools import adjudicate_mfu, bench_train, profile_train

pytestmark = pytest.mark.gpu
DEPTH = 2


def _small_var(depth=16, patch_nums=(1, 2, 3), shared_aln=False, **_):
    return VARConfig(depth=DEPTH, patch_nums=patch_nums, shared_aln=shared_aln,
                     vocab_size=64, Cvae=8, head_dim=64)


def _small_vae(patch_nums=(1, 2, 3), **_):
    return VQVAEConfig(patch_nums=patch_nums, vocab_size=64, z_channels=8,
                       ch=32, ch_mult=(1, 1))


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for mod in (bench_train, profile_train, adjudicate_mfu):
        monkeypatch.setattr(mod, "VARConfig", _small_var)
        monkeypatch.setattr(mod, "VQVAEConfig", _small_vae)
    return torch.device("cuda")


def test_varonly_step_on_the_card(cuda):
    """Four timed steps and one untimed: row 1 once a layer a step."""
    attention_kernel.launches = 0
    r = bench_train.bench_varonly(16, 4, iters=4)
    assert attention_kernel.launches == 5 * DEPTH
    assert math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
    assert r["ms"] > 0 and r["card"] != "cpu"


def test_profile_train_step_on_the_card(cuda, tmp_path):
    """The profiled remat step launches row 1 twice a layer; its kernel
    shows in the device categories."""
    r = profile_train.run(16, 4, logdir=str(tmp_path))
    assert r["attention_launches"] == 2 * DEPTH
    assert r["categories"].get("attention kernel (row 1)", 0) > 0
    assert r["attention_backward_ms"] > 0 and 0 < r["busy_share"]
