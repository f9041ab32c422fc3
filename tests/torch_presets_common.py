"""Shared stacks of the preset parity tests (``test_torch_presets*.py``):
a tiny VAR (depth 2, 16 per head, V=64) at the 512px preset and at the
1024px preset's first eleven scales, with shared AdaLN off or on, made by
the JAX initialiser and carried over by the weight bridge, and a VQVAE
from the port's initialiser."""

import jax
import numpy as np
import pytest
import torch

from sdvar_tpu.config import PATCH_NUMS_512 as J512
from sdvar_tpu.config import PATCH_NUMS_1024 as J1024
from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import var as JM
from sdvar_tpu_torch.config import PATCH_NUMS_512, PATCH_NUMS_1024
from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax, vqvae_params_from_jax

PRESETS = {512: PATCH_NUMS_512, 1024: PATCH_NUMS_1024[:11]}
CASES = [(512, False), (512, True), (1024, False), (1024, True)]
IDS = [f"{r}px-{'shared' if s else 'per-block'}-adaln" for r, s in CASES]


def var_kw(reso, shared):
    return dict(depth=2, num_classes=10, patch_nums=PRESETS[reso],
                vocab_size=64, Cvae=8, cond_drop_rate=0.0, drop_path_rate=0.0,
                head_dim=16, shared_aln=shared)


def vae_kw(reso):
    return dict(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1),
                patch_nums=PRESETS[reso])


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.numpy()


def build_stack(reso, shared, seed=11):
    """JAX-initialised VAR weights with the head, the biases and the AdaLN
    projection's bias drawn (so every block takes part and logits are
    distinct), the port's copy through the bridge, and a VQVAE from the
    port's initialiser with a unit-scale codebook, as numpy for JAX."""
    assert PRESETS[reso] == (J512 if reso == 512 else J1024[:11])
    jv, tv = JVARConfig(**var_kw(reso, shared)), VARConfig(**var_kw(reso, shared))
    jq, tq = JVQVAEConfig(**vae_kw(reso)), VQVAEConfig(**vae_kw(reso))
    vp = jax.tree.map(np.asarray, JM.init_var_params(jv, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(tree, name, std):
        tree[name] = rng.normal(0, std, tree[name].shape).astype(np.float32)

    draw(vp["head"], "w", 0.05)
    draw(vp["head"], "b", 0.05)
    for name in ("q_bias", "v_bias", "fc1_b"):
        draw(vp["blocks"], name, 0.05)
    if shared:
        assert "ada_lin_w" not in vp["blocks"] and "ada_gss" in vp["blocks"]
        draw(vp["shared_ada_lin"], "b", 0.3)
        draw(vp["blocks"], "ada_gss", 0.3)
    else:
        draw(vp["blocks"], "ada_lin_b", 0.3)
    qp = numpy_tree(VQ.init_vqvae_params(tq, seed=5, device="cpu", eini=1.0))
    return (jv, jq, tv, tq, vp, qp, var_params_from_jax(vp, device="cpu"),
            vqvae_params_from_jax(qp, device="cpu"))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: the shapes are tiny, and
    under the suite's parallel workers a pool of threads a process waits
    on the others (``test_torch_tools.py``: 32 s alone, 1057 s among six
    workers with the default threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
