"""Mesh widths that do not divide: a small stack with 6 heads on a 1x4
(model) mesh of four gloo ranks on the CPU, once with every other width
split (FFN hidden, AdaLN 6C, vocab) and once with the vocab (66) whole
too. The heads' layers (qkv, proj, the KV cache) and a vocab that does
not divide are held whole on every rank and computed unsplit. Each rank's
greedy f32 decode must give the unsharded decode's ids, and f_hat within
1e-5 of its size; a whole layer makes no collective (one all-reduce a
layer and scale, fc2's; one all-gather of the modulations; one of the
logits a scale only where the vocab splits).

This file starts itself as the four ranks (``parallel.launch``), once.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank: python tests/test_torch_mesh_replicated.py
    sys.path.insert(0, REPO)

from sdvar_tpu_torch.config import MeshConfig, SamplingConfig, VARConfig, VQVAEConfig  # noqa: E402
from sdvar_tpu_torch.engine.decode import decode_all_scales  # noqa: E402
from sdvar_tpu_torch.models.var import init_var_params  # noqa: E402
from sdvar_tpu_torch.models.vqvae import init_vqvae_params  # noqa: E402
from sdvar_tpu_torch.ops import partition as PT  # noqa: E402
from sdvar_tpu_torch.parallel import distributed as D  # noqa: E402
from sdvar_tpu_torch.parallel import mesh as MS  # noqa: E402
from sdvar_tpu_torch.parallel.launch import launch  # noqa: E402

PNS = (1, 2, 3)
WORLD = 4
CASES = {"heads": 64, "heads+vocab": 66}  # name -> vocab size
LABELS = [3, 7, 1, 8]
SAMP = SamplingConfig(cfg=1.5, top_k=1)


def _stack(vocab):
    vc = VARConfig(depth=6, num_classes=10, patch_nums=PNS, vocab_size=vocab,
                   Cvae=8, head_dim=32)
    qc = VQVAEConfig(vocab_size=vocab, z_channels=8, ch=32, patch_nums=PNS)
    p = init_var_params(vc, seed=0, device="cpu")
    b = p["blocks"]["ada_lin_b"]
    b.copy_(torch.randn(b.shape, generator=torch.Generator().manual_seed(6)) * 0.3)
    return vc, qc, p, init_vqvae_params(qc, seed=1, device="cpu", eini=1.0)["quant"]


def _decode(vc, qc, p, q):
    return decode_all_scales(vc, qc, p, q, LABELS, seed=7, samp=SAMP,
                             dtype=torch.float32, kv_mode="f32",
                             return_ids=True, device="cpu", gather=True)


def _rank_main(out_dir: str) -> None:
    torch.set_num_threads(1)
    D.initialize()
    rank = D.get_rank()
    mesh = MS.create_mesh(MeshConfig(data=1, model=WORLD))
    counts = {"all_reduce": 0, "all_gather": 0}
    for name in counts:
        fn = getattr(mesh, name)

        def counted(t, axis=PT.MODEL, *a, _fn=fn, _name=name, **kw):
            counts[_name] += axis == PT.MODEL  # the model axis's collectives
            return _fn(t, axis, *a, **kw)

        setattr(mesh, name, counted)
    res, meta = {}, {}
    for case, vocab in CASES.items():
        vc, qc, p, q = _stack(vocab)
        specs = MS.var_param_specs(vc, mesh)
        ps = MS.shard_tree(p, specs, mesh)
        meta[case] = {"splits": MS.var_splits(vc, WORLD),
                      "qkv_cols": ps["blocks"]["qkv_w"].shape[-1],
                      "fc1_cols": ps["blocks"]["fc1_w"].shape[-1],
                      "head_cols": ps["head"]["w"].shape[-1]}
        PT.set_tp_mesh(mesh)
        for k in counts:
            counts[k] = 0
        try:
            f_hat, ids = _decode(vc, qc, ps, q)
        finally:
            PT.set_tp_mesh(None)
        meta[case]["collectives"] = dict(counts)
        res[f"{case}_fhat"], res[f"{case}_ids"] = f_hat.numpy(), ids.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    D.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
    sys.exit(0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tests.mp_common import multiprocess_launch_lock

    out = str(tmp_path_factory.mktemp("torch_mesh_replicated"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with multiprocess_launch_lock():
        launch([sys.executable, os.path.abspath(__file__), out], WORLD, 240.0,
               env=env, cwd=REPO)
    arrs = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)]
    metas = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            metas.append(json.load(f))
    return arrs, metas


@pytest.mark.parametrize("case", list(CASES))
def test_indivisible_widths_decode_like_the_unsharded_stack(ranks, case):
    arrs, metas = ranks
    vc, qc, p, q = _stack(CASES[case])
    f_want, ids_want = (t.numpy() for t in _decode(vc, qc, p, q))
    C = vc.embed_dim
    meta = metas[0][case]
    assert meta["splits"] == {"heads": False, "FFN hidden": True,
                              "AdaLN 6C": True, "vocab": case == "heads"}
    assert meta["qkv_cols"] == 3 * C  # the heads whole on every rank
    assert meta["fc1_cols"] == vc.mlp_hidden // WORLD
    assert meta["head_cols"] == (vc.vocab_size // WORLD if case == "heads"
                                 else vc.vocab_size)
    S, depth = len(PNS), vc.depth
    for r in range(WORLD):
        np.testing.assert_array_equal(arrs[r][f"{case}_ids"], ids_want)
        err = np.abs(arrs[r][f"{case}_fhat"] - f_want).max()
        assert err <= 1e-5 * np.abs(f_want).max(), (r, err)
        assert metas[r][case]["collectives"] == {
            "all_reduce": depth * S,
            "all_gather": 1 + (S if case == "heads" else 0)}
