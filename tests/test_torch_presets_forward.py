"""One teacher-forced cached forward of the W8A8 + INT8-KV stacks of
``torch_presets_common.py`` (the 512px preset and the 1024px preset's
first eleven scales, shared AdaLN off and on) against the JAX package on
the CPU: the numeric check of every scale that the greedy decodes of
``test_torch_presets_quant.py`` hold only through their ids. Measured:
scales 0-3 within 4e-7 of their size, the later ones up to 1.3e-3 where
a last-bit difference has flipped an int8 rounding step (512px with
per-block AdaLN, its last scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvar_tpu.models import var as JM
from sdvar_tpu.ops import quantization as JQ
from sdvar_tpu_torch.models import var as M
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax
from torch_presets_common import CASES, IDS, build_stack
from torch_presets_common import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("reso,shared", CASES, ids=IDS)
def test_w8a8_int8_kv_cached_forward_matches_jax(reso, shared):
    """One teacher-forced cached forward over every scale (the same seeded
    token embeddings and conditions on both sides, an INT8 KV cache): the
    logits of each scale within 5e-3 of their size, the limit of
    ``chip_smoke.py``'s card-vs-CPU check of these stacks. A rounding step
    flipped by last-bit differences moves them by up to about 1.5e-3 of
    their size (1.3e-3 here, 1.55e-3 card vs CPU); a scale or index fault
    at a later scale moves them by their own size."""
    jv, _, tv, _, vp, _, _, _ = build_stack(reso, shared)
    jvq = jax.tree.map(np.asarray, JQ.quantize_var_params(vp, mode="w8a8"))
    tvq = var_params_from_jax(jvq, device="cpu")
    rng = np.random.default_rng(5)
    B2 = 4
    cond = rng.standard_normal((B2, jv.embed_dim)).astype(np.float32)
    jc, tc = jnp.asarray(cond), torch.from_numpy(cond)
    jcache = JQ.QuantizedKVCache.create(jv, B2)
    tcache = QuantizedKVCache.create(tv, B2, device="cpu")
    jmods = JM.precompute_modulations(jv, jvq, jc)
    tmods = M.precompute_modulations(tv, tvq, tc)
    gaps = []
    for bg, ed in jv.begin_ends:
        x = rng.standard_normal((B2, ed - bg, jv.embed_dim)).astype(np.float32)
        jh, jcache = JM.apply_transformer(jv, jvq, jnp.asarray(x), jc,
                                          cache=jcache, cache_begin=bg,
                                          kv_len=ed, mods=jmods)
        th = M.apply_transformer(tv, tvq, torch.from_numpy(x), tc,
                                 cache=tcache, cache_begin=bg, kv_len=ed,
                                 mods=tmods)
        jl = np.asarray(JM.get_logits(jv, jvq, jh, jc))
        with torch.inference_mode():
            tl = M.get_logits(tv, tvq, th, tc).numpy()
        gaps.append(np.abs(tl - jl).max() / np.abs(jl).max())
    assert max(gaps) <= 5e-3, [f"{g:.2e}" for g in gaps]
