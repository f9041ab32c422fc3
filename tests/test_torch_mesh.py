"""The port's mesh paths on two processes (gloo, CPU) against the JAX
package's unsharded decode and the port's unsharded kernels, and the mesh
module in one process.

Single process: the mesh's shape and rank coordinates, ``var_param_specs``
against the parameter tree, ``shard_tree`` on plain and W8A8 leaves (the
q / scale rule, K-major storage), the head-aligned qkv split, a shape that
does not divide, and the distributed helpers with one process.

Two processes: one module-scoped fixture starts this file as two ranks of
one group (``parallel.launch``), once. The ranks import torch and the port
only; each runs, on a 1x2 (model) mesh and on a 2x1 (data) mesh of the
same two processes, the greedy f32 decode with plain weights and with
W8A8 weights and an INT8 KV cache, the sharded attention (float and INT8
K/V), sampler and probe kernels on given inputs, a mesh server and the
speculative engine, then ``bench_serving`` mode ``mesh``; and writes what
it got. This process holds it against the JAX package's decode of the same
numpy weights and against the unsharded port. Bounds: f_hat within
rtol/atol 1e-4 of JAX's (``tests/test_sharding.py``'s bar) with greedy ids
equal; the quantized ids equal and the KV scale planes bit-equal; the
sharded kernels bit-equal to the unsharded ones.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank: python tests/test_torch_mesh.py
    sys.path.insert(0, REPO)

from sdvar_tpu_torch.config import (  # noqa: E402
    MeshConfig,
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales  # noqa: E402
from sdvar_tpu_torch.engine.serving import GenerationServer  # noqa: E402
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine  # noqa: E402
from sdvar_tpu_torch.models.vqvae import init_vqvae_params  # noqa: E402
from sdvar_tpu_torch.ops import partition as PT  # noqa: E402
from sdvar_tpu_torch.ops.attention import attention  # noqa: E402
from sdvar_tpu_torch.ops.kernels.attention import attention_plain  # noqa: E402
from sdvar_tpu_torch.ops.kernels.sampling import sample_plain  # noqa: E402
from sdvar_tpu_torch.ops.quantization import (  # noqa: E402
    W8A8Linear,
    quantize_tokens,
    quantize_var_params,
)
from sdvar_tpu_torch.parallel import distributed as D  # noqa: E402
from sdvar_tpu_torch.parallel import mesh as MS  # noqa: E402
from sdvar_tpu_torch.parallel.launch import launch  # noqa: E402
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax  # noqa: E402

PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
              head_dim=32)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)
F32 = torch.float32
LABELS = [3, 7, 1, 8]
SAMP = SamplingConfig(cfg=1.5, top_k=1)
MESHES = {"tp": MeshConfig(data=1, model=2), "dp": MeshConfig(data=2, model=1)}
ATT = dict(B=4, Lq=6, Lk=14, H=2, hd=32)  # sharded-kernel inputs
SMP = dict(M=8, V=64, top_k=8, top_p=0.9)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# one rank (this file run as a script)
# ---------------------------------------------------------------------------

def _rank_main(out_dir: str) -> None:
    torch.set_num_threads(2)
    D.initialize()
    rank = D.get_rank()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    tv, tq = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    vae = init_vqvae_params(tq, seed=5, device="cpu", eini=1.0)
    trees = {k: var_params_from_jax(_unflat(
        {n[len(k) + 1:]: a for n, a in inp.items() if n.startswith(k + "/")}),
        device="cpu") for k in ("target", "draft")}
    w8 = quantize_var_params(trees["target"], mode="w8a8")
    res, meta = {}, {"rank": rank}
    for name, mcfg in MESHES.items():
        mesh = MS.create_mesh(mcfg)
        PT.set_tp_mesh(mesh)
        meta[f"{name}_coords"] = [mesh.data_index, mesh.model_index]
        specs = MS.var_param_specs(tv, mesh)
        params = MS.shard_tree(trees["target"], specs, mesh)
        f_hat, ids = decode_all_scales(tv, tq, params, vae["quant"], LABELS, 0,
                                       SAMP, F32, return_ids=True,
                                       device="cpu", gather=True)
        res[f"{name}_fhat"], res[f"{name}_ids"] = f_hat.numpy(), ids.numpy()
        f8, ids8, cache = decode_all_scales(
            tv, tq, MS.shard_tree(w8, specs, mesh), vae["quant"], LABELS, 0,
            SAMP, F32, return_ids=True, kv_mode="int8", return_cache=True,
            device="cpu", gather=True)
        res[f"{name}_w8a8_ids"] = ids8.numpy()
        for s in ("k_s", "v_s"):  # this rank's planes, and the whole batch's
            res[f"{name}_{s}_local"] = getattr(cache, s).numpy()
            res[f"{name}_{s}"] = PT.gather_data(getattr(cache, s), dim=1).numpy()

        # the per-rank kernels on this rank's block of the same whole
        # inputs: attention as the model launches it, on the rank's rows
        # and heads (all it holds), with its rows of the scale planes
        whole = {t: torch.from_numpy(inp[f"att_{t}"])
                 for t in ("q", "k", "v", "k8", "v8")}
        q, k, v, k8, v8 = (_rank_block(mesh, t) for t in whole.values())
        rows = mesh.rows(whole["k8"].shape[0])
        scales = tuple(torch.from_numpy(inp[f"att_{t}s"])[rows] for t in "kv")
        res[f"{name}_att"] = _gather_block(attention(q, k, v, None, 1.0))
        res[f"{name}_att8"] = _gather_block(
            attention(q, k8, v8, None, 1.0, kv_scales=scales))
        logits = torch.from_numpy(inp["smp_logits"])
        seeds = torch.from_numpy(inp["smp_seeds"])
        rows, V = mesh.rows(SMP["M"]), SMP["V"] // mesh.model
        cols = slice(mesh.model_index * V, (mesh.model_index + 1) * V)
        res[f"{name}_smp"] = PT.gather_data(PT.sharded_fused_sample(
            logits[rows, cols], seeds[rows], SMP["top_k"], SMP["top_p"],
            SMP["V"])).numpy()
        res[f"{name}_probe"] = PT.sharded_scale_probe(
            torch.from_numpy(inp["probe_x"])).numpy()

        # the speculative engine (near draft: rates between 0 and 1)
        eng = SpeculativeEngine(
            tq, tv, tv, vae, MS.shard_tree(trees["draft"], specs, mesh), params,
            dtype=F32, kv_mode="f32", mesh=mesh, device="cpu")
        _, st, sids = eng.generate_speculative(
            LABELS, 5, SpeculativeConfig(gamma=2), SAMP, return_ids=True,
            gather=True)
        meta[f"{name}_match_rates"] = st.match_rates
        res[f"{name}_spec_ids"] = sids.numpy()
        PT.set_tp_mesh(None)

        # the mesh server: 4 requests, one bucket of 4
        srv = GenerationServer(tv, tq, trees["target"], vae, samp=SAMP,
                               max_batch=4, buckets=[4], max_wait_ms=2000.0,
                               dtype=F32, mesh_cfg=mcfg, deliver="u8",
                               device="cpu")
        rids = [srv.submit(label=lab, seed=100 + i)
                for i, lab in enumerate(LABELS)]
        srv.start()
        per = 4 // mcfg.data
        mine = rids[srv.mesh.data_index * per:(srv.mesh.data_index + 1) * per]
        got = {}
        for rid in mine:
            r = srv.get(rid, timeout=120)
            assert r.ok, r.error
            got[rid] = r.image
        srv.stop()
        meta[f"{name}_server"] = {"delivered": sorted(got),
                                  "completed": srv.stats["completed"],
                                  "batches": srv.stats["batches"],
                                  "left": sorted(srv._results)}
        for rid, img in got.items():
            res[f"{name}_img{rid}"] = img

    # bench_serving mode mesh on MeshConfig(1, world): the small stack
    from sdvar_tpu_torch.tools import bench_serving
    bench_serving.VARConfig = lambda depth: VARConfig(**dict(VAR_KW, num_classes=1000))
    bench_serving.VQVAEConfig = lambda: VQVAEConfig(**VAE_KW)
    out = bench_serving.run(2, 3, 2, "mesh", device="cpu")
    meta["bench_serving"] = {k: out[k] for k in ("requests", "batches", "mode")}

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    D.shutdown()


def _rank_block(mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's (B/data, L, H/model, hd) block of a whole (B, L, H, hd)."""
    per = t.shape[2] // mesh.model
    return t[mesh.rows(t.shape[0]), :,
             mesh.model_index * per:(mesh.model_index + 1) * per]


def _gather_block(t: torch.Tensor) -> np.ndarray:
    """(B/data, L, H/model, hd) blocks -> the whole (B, L, H, hd)."""
    return PT.gather_data(PT.gather_model(t, dim=2), dim=0).numpy()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# this process: the JAX references and the checks
# ---------------------------------------------------------------------------

def _jax_trees():
    """The target (JAX initialiser, head x30, AdaLN biases and the attention
    biases drawn, so the blocks take part) and a near draft (its head
    perturbed), as numpy trees."""
    import jax

    from sdvar_tpu.config import VARConfig as JVARConfig
    from sdvar_tpu.models import var as JM

    p = jax.tree.map(np.asarray, JM.init_var_params(JVARConfig(**VAR_KW),
                                                    jax.random.PRNGKey(11)))
    rng = np.random.default_rng(11)
    p["head"]["w"] = p["head"]["w"] * np.float32(30.0)
    blocks = p["blocks"]
    blocks["ada_lin_b"] = rng.normal(0, 0.3, blocks["ada_lin_b"].shape
                                     ).astype(np.float32)
    for name in ("q_bias", "v_bias", "fc1_b"):
        blocks[name] = rng.normal(0, 0.05, blocks[name].shape).astype(np.float32)
    draft = jax.tree.map(lambda a: a, p)
    w = p["head"]["w"]
    draft["head"] = {"w": w + rng.normal(0, 0.5 * w.std(), w.shape
                                         ).astype(np.float32),
                     "b": p["head"]["b"]}
    return p, draft


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks once; return (inputs, [rank 0, rank 1] arrays,
    [rank 0, rank 1] metadata)."""
    from tests.mp_common import multiprocess_launch_lock

    out = str(tmp_path_factory.mktemp("torch_mesh"))
    target, draft = _jax_trees()
    rng = np.random.default_rng(3)
    B, Lq, Lk, H, hd = (ATT[k] for k in ("B", "Lq", "Lk", "H", "hd"))
    inp = {f"target/{k}": v for k, v in _flat(target).items()}
    inp.update({f"draft/{k}": v for k, v in _flat(draft).items()})
    for t, L in (("q", Lq), ("k", Lk), ("v", Lk)):
        inp[f"att_{t}"] = rng.standard_normal((B, L, H, hd)).astype(np.float32)
    for t in "kv":
        q8, s = quantize_tokens(torch.from_numpy(
            rng.standard_normal((B, Lk, H * hd)).astype(np.float32)))
        inp[f"att_{t}8"] = q8.view(B, Lk, H, hd).numpy()
        inp[f"att_{t}s"] = s.numpy()
    inp["smp_logits"] = (rng.standard_normal((SMP["M"], SMP["V"])) * 3
                         ).astype(np.float32)
    inp["smp_seeds"] = rng.integers(-2 ** 31, 2 ** 31 - 1, SMP["M"],
                                    dtype=np.int64).astype(np.int32)
    inp["probe_x"] = rng.standard_normal((8, 512)).astype(np.float32)
    np.savez(os.path.join(out, "inputs.npz"), **inp)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SDVAR_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    with multiprocess_launch_lock():
        launch([sys.executable, os.path.abspath(__file__), out], world=2,
               timeout=300, env=env, cwd=REPO)
    arrs = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    meta = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            meta.append(json.load(f))
    return inp, arrs, meta, target


@pytest.fixture(scope="module")
def jax_ref(ranks):
    """The JAX package's unsharded greedy f32 decodes of the same weights,
    plain and W8A8 + INT8 KV, and the unsharded port's quantized cache."""
    import jax
    import jax.numpy as jnp

    from sdvar_tpu.config import SamplingConfig as JSamplingConfig
    from sdvar_tpu.config import VARConfig as JVARConfig
    from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
    from sdvar_tpu.engine import decode as JD
    from sdvar_tpu.ops import quantization as JQ

    target = ranks[3]
    jv, jq = JVARConfig(**VAR_KW), JVQVAEConfig(**VAE_KW)
    quant = {k: v.numpy() for k, v in init_vqvae_params(
        VQVAEConfig(**VAE_KW), seed=5, device="cpu", eini=1.0)["quant"].items()}
    labels = jnp.asarray(np.array(LABELS))
    samp = JSamplingConfig(cfg=1.5, top_k=1)
    f_hat, ids = JD.decode_all_scales(jv, jq, target, quant, labels,
                                      jax.random.PRNGKey(0), samp, jnp.float32,
                                      return_ids=True)
    q8 = jax.tree.map(np.asarray, JQ.quantize_var_params(target, mode="w8a8"))
    _, ids8 = JD.decode_all_scales(
        jv, jq, q8, quant, labels, jax.random.PRNGKey(0), samp, jnp.float32,
        return_ids=True, kv_mode="int8")
    # the unsharded port's cache of the same quantized decode
    tv, tq = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    _, _, cache = decode_all_scales(
        tv, tq, quantize_var_params(var_params_from_jax(target, device="cpu"),
                                    mode="w8a8"),
        {k: torch.from_numpy(v) for k, v in quant.items()}, LABELS, 0, SAMP,
        F32, return_ids=True, kv_mode="int8", return_cache=True, device="cpu")
    return {"fhat": np.asarray(f_hat), "ids": np.asarray(ids),
            "ids8": np.asarray(ids8), "k_s": cache.k_s.numpy(),
            "v_s": cache.v_s.numpy()}


def _cfg_rows(data: int) -> np.ndarray:
    """Rows of the data ranks' gathered [cond_r ‖ uncond_r] blocks in the
    unsharded [cond ‖ uncond] order."""
    B, per = len(LABELS), len(LABELS) // data
    order = []
    for half in (0, 1):
        for r in range(data):
            order += [r * 2 * per + half * per + i for i in range(per)]
    return np.array(order)


@pytest.mark.parametrize("name", ["tp", "dp"])
def test_mesh_decode_matches_jax(ranks, jax_ref, name):
    _, arrs, meta, _ = ranks
    for r in range(2):
        np.testing.assert_array_equal(arrs[r][f"{name}_ids"], jax_ref["ids"])
        np.testing.assert_allclose(arrs[r][f"{name}_fhat"], jax_ref["fhat"],
                                   rtol=1e-4, atol=1e-4)
    want = {"tp": [[0, 0], [0, 1]], "dp": [[0, 0], [1, 0]]}[name]
    assert [m[f"{name}_coords"] for m in meta] == want


@pytest.mark.parametrize("name", ["tp", "dp"])
def test_mesh_w8a8_int8kv_matches_jax(ranks, jax_ref, name):
    """Quantized ids equal JAX's. The KV scale planes, gathered over the
    data ranks and put in [cond ‖ uncond] order: on the model split, the
    unsharded port's bits, the same on both model ranks (the amax is
    all-reduced before the division; a rank's own amax would move most
    scales by far more than a bit; every product of the W8A8 stack is exact
    and the f32 ones are column slices). On the data split, a rank decodes
    half the batch, and the CPU's f32 convolutions and products of the
    scale-2 input differ in the last bit with the batch size (measured:
    16 of 224 key scales one ulp apart): scales 0 and 1 bit-equal, the rest
    within 1e-6 of their size. JAX's own planes differ from the port's in
    the last bit where their f32 keys do, so the planes are held against
    the port."""
    _, arrs, _, _ = ranks
    data = MESHES[name].data
    exact = jax_ref["k_s"].shape[2] if name == "tp" else 5  # tokens
    for r in range(2):
        np.testing.assert_array_equal(arrs[r][f"{name}_w8a8_ids"],
                                      jax_ref["ids8"])
        for s in ("k_s", "v_s"):
            got = arrs[r][f"{name}_{s}"][:, _cfg_rows(data)]
            np.testing.assert_array_equal(got[..., :exact],
                                          jax_ref[s][..., :exact])
            np.testing.assert_allclose(got, jax_ref[s], rtol=1e-6, atol=0)
    if name == "tp":
        for s in ("k_s", "v_s"):
            np.testing.assert_array_equal(arrs[0][f"tp_{s}_local"],
                                          arrs[1][f"tp_{s}_local"])


@pytest.mark.parametrize("name", ["tp", "dp"])
def test_sharded_kernels_bit_equal_unsharded(ranks, name):
    """Per-rank attention (float and INT8 K/V) on each rank's rows and
    heads, the sharded sampler and probe, gathered, are the unsharded
    port's bits (the JAX package's
    ``tests/test_tp_pallas.py`` shard_map proofs)."""
    inp, arrs, _, _ = ranks
    q, k, v = (torch.from_numpy(inp[f"att_{t}"]) for t in "qkv")
    want = attention_plain(q, k, v, None, 1.0).numpy()
    k8, v8 = (torch.from_numpy(inp[f"att_{t}8"]) for t in "kv")
    scales = tuple(torch.from_numpy(inp[f"att_{t}s"]) for t in "kv")
    want8 = attention_plain(q, k8, v8, None, 1.0, kv_scales=scales).numpy()
    ids = sample_plain(torch.from_numpy(inp["smp_logits"]),
                       torch.from_numpy(inp["smp_seeds"]), SMP["top_k"],
                       SMP["top_p"]).numpy()
    for r in range(2):
        np.testing.assert_array_equal(arrs[r][f"{name}_att"], want)
        np.testing.assert_array_equal(arrs[r][f"{name}_att8"], want8)
        np.testing.assert_array_equal(arrs[r][f"{name}_smp"], ids)
        np.testing.assert_array_equal(arrs[r][f"{name}_probe"],
                                      inp["probe_x"] * np.float32(2.0))


@pytest.mark.parametrize("name", ["tp", "dp"])
def test_mesh_server_delivers_each_slot_once(ranks, name):
    """Each rank delivers the rows it holds and nothing else: every
    request once per data group; model ranks deliver the same bits."""
    _, arrs, meta, _ = ranks
    srv = [m[f"{name}_server"] for m in meta]
    data = MESHES[name].data
    for m in srv:
        assert m["batches"] == 1 and m["left"] == []
        assert m["completed"] == len(m["delivered"]) == 4 // data
    if data == 2:
        assert srv[0]["delivered"] == [0, 1] and srv[1]["delivered"] == [2, 3]
    else:
        assert srv[0]["delivered"] == srv[1]["delivered"] == [0, 1, 2, 3]
        for rid in range(4):
            np.testing.assert_array_equal(arrs[0][f"tp_img{rid}"],
                                          arrs[1][f"tp_img{rid}"])
    for r in range(2):
        for rid in srv[r]["delivered"]:
            img = arrs[r][f"{name}_img{rid}"]
            assert img.dtype == np.uint8 and img.shape == (3, 48, 48)


@pytest.mark.parametrize("name", ["tp", "dp"])
def test_mesh_speculative_match_rates(ranks, name):
    """The match rates are batch-global: equal on every rank and equal to
    the unsharded engine's on the same weights, as are the ids."""
    _, arrs, meta, _ = ranks
    inp = ranks[0]
    tv, tq = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    vae = init_vqvae_params(tq, seed=5, device="cpu", eini=1.0)
    trees = {k: var_params_from_jax(_unflat(
        {n[len(k) + 1:]: a for n, a in inp.items() if n.startswith(k + "/")}),
        device="cpu") for k in ("target", "draft")}
    eng = SpeculativeEngine(tq, tv, tv, vae, trees["draft"], trees["target"],
                            dtype=F32, kv_mode="f32", device="cpu")
    _, st, ids = eng.generate_speculative(LABELS, 5, SpeculativeConfig(gamma=2),
                                          SAMP, return_ids=True)
    assert any(0 < r < 1 for r in st.match_rates)
    for r in range(2):
        assert meta[r][f"{name}_match_rates"] == st.match_rates
        np.testing.assert_array_equal(arrs[r][f"{name}_spec_ids"], ids.numpy())


def test_bench_serving_mesh_on_two_ranks(ranks):
    for m in ranks[2]:
        assert m["bench_serving"] == {"requests": 3, "batches": 2,
                                      "mode": "mesh"}


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_mesh_shape_and_coordinates():
    mesh = MS.create_mesh()
    assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
    assert mesh.shape == {"data": 1, "model": 1}
    for r, (d, m) in enumerate([(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]):
        grid = MS.Mesh(data=2, model=3, rank=r)
        assert (grid.data_index, grid.model_index) == (d, m)
        assert grid.rows(8) == slice(4 * d, 4 * d + 4)
    with pytest.raises(ValueError, match="does not match"):
        MS.create_mesh(MeshConfig(data=2, model=1))
    with pytest.raises(ValueError, match="does not divide"):
        MS.Mesh(data=2, model=1).rows(3)


def test_var_param_specs_cover_the_tree():
    from sdvar_tpu_torch.models.var import init_var_params

    for shared in (False, True):
        cfg = VARConfig(**VAR_KW, shared_aln=shared)
        params = init_var_params(cfg, seed=0, device="cpu")
        specs = MS.var_param_specs(cfg, MS.single_device_mesh())

        def walk(p, s):
            assert set(p) == set(s)
            for k in p:
                if isinstance(p[k], dict):
                    walk(p[k], s[k])
                else:
                    assert len(s[k]) == p[k].dim(), k

        walk(params, specs)


def _fake_rank(model: int, index: int, data: int = 1, data_index: int = 0):
    return MS.Mesh(data=data, model=model, rank=data_index * model + index)


@pytest.mark.parametrize("mode", [None, "w8a8", "w8"])
def test_shard_tree_cuts_plain_and_quantized_leaves(mode):
    """q takes the weight's split; the scale splits with the output columns
    of qkv/fc1/head and stays whole for proj/fc2; W8A8 shards stay
    K-major; concatenated, the shards are the whole leaf."""
    from sdvar_tpu_torch.models.var import init_var_params

    cfg = VARConfig(**VAR_KW)
    full = init_var_params(cfg, seed=1, device="cpu")
    if mode:
        full = quantize_var_params(full, mode=mode)
    specs = MS.var_param_specs(cfg, _fake_rank(2, 0))
    shards = [MS.shard_tree(full, specs, _fake_rank(2, i)) for i in range(2)]
    C, hidden, V = cfg.embed_dim, cfg.mlp_hidden, cfg.vocab_size
    for name, cols in (("qkv_w", 3 * C // 2), ("fc1_w", hidden // 2)):
        leaf = shards[0]["blocks"][name]
        q = leaf.q if mode else leaf
        assert q.shape[-1] == cols
        if mode:
            assert leaf.scale.shape[-1] == cols
    for name in ("proj_w", "fc2_w"):
        leaf = shards[1]["blocks"][name]
        if mode:
            torch.testing.assert_close(leaf.scale, full["blocks"][name].scale,
                                       rtol=0, atol=0)
            assert leaf.q.shape[-2] == full["blocks"][name].q.shape[-2] // 2
    if mode == "w8a8":
        for name in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
            leaf = shards[0]["blocks"][name]
            assert isinstance(leaf, W8A8Linear)
            assert leaf.q.stride(-2) == 1, name  # K-major
    head = [s["head"]["w"] for s in shards]
    whole = full["head"]["w"]
    if mode:
        torch.testing.assert_close(torch.cat([h.q for h in head], -1), whole.q,
                                   rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([h.scale for h in head], -1),
                                   whole.scale, rtol=0, atol=0)
    else:
        torch.testing.assert_close(torch.cat(head, -1), whole, rtol=0, atol=0)
        assert head[0].shape[-1] == V // 2


def test_qkv_split_is_head_aligned():
    """Each rank's qkv columns are its heads of q, of k and of v: put back
    together per third, the shards are the unsharded q, k and v."""
    cfg = VARConfig(**dict(VAR_KW, depth=4))  # 4 heads, 2 per rank
    C = cfg.embed_dim
    w = torch.arange(2 * C * 3 * C, dtype=F32).view(2, C, 3 * C)
    parts = [MS._cut(w, (None, None, MS.MODEL_QKV), _fake_rank(2, i), "qkv_w")
             for i in range(2)]
    for t in range(3):  # q, k, v
        got = torch.cat([p.view(2, C, 3, C // 2)[:, :, t] for p in parts], -1)
        torch.testing.assert_close(got, w[..., t * C:(t + 1) * C], rtol=0, atol=0)


def test_indivisible_shapes_raise():
    """A spec that splits a width which does not divide the mesh (the
    specs of a mesh where it does) raises in ``shard_tree``; the mesh's
    own specs (``var_param_specs(cfg, mesh)``) keep that width's weights
    whole and cut the others (``tests/test_torch_mesh_replicated.py``
    decodes such a stack)."""
    from sdvar_tpu_torch.models.var import init_var_params

    cfg = VARConfig(**dict(VAR_KW, depth=3))  # 3 heads
    mesh = _fake_rank(2, 0)
    assert MS.var_splits(cfg, 2) == {"heads": False, "FFN hidden": True,
                                     "AdaLN 6C": True, "vocab": True}
    p = init_var_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match=r"/blocks/.*does not divide over model=2"):
        MS.shard_tree(p, MS.var_param_specs(cfg, _fake_rank(3, 0)), mesh)
    cut = MS.shard_tree(p, MS.var_param_specs(cfg, mesh), mesh)
    C = cfg.embed_dim
    assert cut["blocks"]["qkv_w"].shape[-1] == 3 * C  # heads whole
    assert cut["blocks"]["proj_w"].shape[1] == C
    assert cut["blocks"]["fc1_w"].shape[-1] == cfg.mlp_hidden // 2
    assert cut["head"]["w"].shape[-1] == cfg.vocab_size // 2
    v63 = VARConfig(**dict(VAR_KW, vocab_size=63))
    assert not MS.var_splits(v63, 2)["vocab"]
    with pytest.raises(ValueError, match=r"/head/w: dimension 1 \(63\)"):
        MS.shard_tree(init_var_params(v63, seed=0, device="cpu"),
                      MS.var_param_specs(v63, _fake_rank(63, 0)), mesh)


def test_local_kv_cache_and_batch_rows():
    """Under a registered mesh a KV cache is made at this rank's shape,
    (depth, B/data, L, C/model), and the batch rows are its contiguous
    slice; a 1x1 mesh cuts nothing."""
    from sdvar_tpu_torch.ops.quantization import QuantizedKVCache

    cfg = VARConfig(**VAR_KW)
    PT.set_tp_mesh(_fake_rank(2, 1, data=2, data_index=1))
    try:
        cache = QuantizedKVCache.create(cfg, 4, device="cpu")
        rows = PT.data_rows(6)
    finally:
        PT.set_tp_mesh(None)
    assert cache.k.shape == (2, 2, cfg.L, cfg.embed_dim // 2)
    assert cache.k_s.shape == (2, 2, cfg.L)
    assert torch.arange(6)[rows].tolist() == [3, 4, 5]
    one = MS.single_device_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.rows(6) == slice(0, 6)


def test_distributed_helpers_with_one_process():
    """The counterpart of tests/test_sharding.py's host-helper checks: with
    one process every helper acts on this process alone."""
    D.initialize(num_processes=1)
    assert D.get_rank() == 0 and D.get_world_size() == 1
    assert D.is_master() and D.is_local_master()
    assert D.master_only(lambda: 7)() == 7
    D.barrier()
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(D.allreduce_host(x), x)
    np.testing.assert_array_equal(D.allgather_host(x), x[None])
    backend, why = D.backend_rule()
    assert backend in ("gloo", "nccl") and why
