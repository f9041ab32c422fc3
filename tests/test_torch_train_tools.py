"""The port's training tools on the CPU at tiny sizes: ``convert_checkpoint``
against the JAX package's converter, the ``pretokenize`` command line
against ``pretokenize_dataset`` (and its resume), every mode of
``bench_train`` (the ``bf16params`` and ``reso512`` + shared AdaLN steps
also against the JAX package's ``train_step`` on the same weights),
``profile_train``, ``adjudicate_mfu`` (their FLOP counts the JAX tools'
formulas, their peak the H100's) and ``calib_pixels``. ``train_pair`` is
in ``test_torch_train_pair.py``.

Each tool's module-level configuration names are swapped for small ones,
so its own code runs as it is: VAR depth 2, 32 per head, V=64, Cvae=8;
a VQVAE of 32 channels whose two levels take 6x6 (or 8x8) images for the
scales 1-2-3 (or 1-2-4 in place of the 512px preset). Times printed are
the CPU's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.models import quantizer as JQ
from sdvar_tpu.models import var as JM
from sdvar_tpu.train import trainer as JT
from sdvar_tpu.utils import torch_port as JTP
from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train import checkpoint as CK
from sdvar_tpu_torch.train import trainer as T
from sdvar_tpu_torch.train.pretokenize import (
    build_token_datasets_for_passes,
    pretokenize_dataset,
)
from sdvar_tpu_torch.tools import (
    adjudicate_mfu,
    bench_train,
    calib_pixels,
    convert_checkpoint,
    pretokenize,
    profile_train,
)
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax
from tests.test_torch_checkpoint_port import (
    _assert_trees_equal,
    _var_state_dict,
    _vqvae_state_dict,
)

TINY_VAE = dict(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1))
PRESET = {256: (1, 2, 3), 512: (1, 2, 4)}


def _tiny_var(depth=16, patch_nums=(1, 2, 3), shared_aln=False, **_):
    return VARConfig(depth=min(depth, 2), patch_nums=patch_nums,
                     shared_aln=shared_aln, vocab_size=64, Cvae=8, head_dim=32)


def _tiny_vae(patch_nums=(1, 2, 3), **_):
    return VQVAEConfig(patch_nums=patch_nums, **TINY_VAE)


@dataclasses.dataclass(frozen=True)
class _TinyTrain:
    """TrainConfig with the presets' scales cut to three."""

    depth: int = 16
    reso: int = 256
    grad_clip: float = 2.0

    @property
    def patch_nums(self):
        return PRESET[self.reso]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_tools.py's reason: tiny shapes
    under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    for mod in (bench_train, calib_pixels, adjudicate_mfu, profile_train):
        if hasattr(mod, "VARConfig"):
            monkeypatch.setattr(mod, "VARConfig", _tiny_var)
        monkeypatch.setattr(mod, "VQVAEConfig", _tiny_vae)
    monkeypatch.setattr(bench_train, "TrainConfig", _TinyTrain)


# ---------------------------------------------------------------------------
# convert_checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_aln,wrapped", [(False, False), (False, True),
                                                (True, False)])
def test_convert_checkpoint_var_matches_the_jax_converter(tmp_path, shared_aln,
                                                          wrapped):
    """A reference-layout d2 state_dict (full widths: V=4096, Cvae=32) at
    the scales 1-2-3, bare or in a training checkpoint's wrapper, through
    the port's command line; read back with a template of
    ``init_var_params``: every leaf equal to the JAX converter's."""
    kw = dict(depth=2, patch_nums=(1, 2, 3), shared_aln=shared_aln)
    cfg = VARConfig(**kw)
    p = init_var_params(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    for key in ("q_bias", "v_bias", "scale_mul"):
        p["blocks"][key] = torch.randn(p["blocks"][key].shape, generator=g)
    sd = _var_state_dict(cfg, p)
    path = str(tmp_path / "var.pth")
    torch.save({"trainer": {"var_wo_ddp": sd}} if wrapped else sd, path)
    out = str(tmp_path / "out")
    convert_checkpoint.main(["--var", path, "--depth", "2", "--patch-nums",
                             "1_2_3", "--out", out, "--device", "cpu"]
                            + (["--shared-aln"] if shared_aln else []))
    got, meta = CK.load_checkpoint(os.path.join(out, "ckpt-00000000"),
                                   init_var_params(cfg, seed=0, device="cpu"))
    assert meta == {"step": 0, "kind": "var", "depth": 2, "patch_nums": [1, 2, 3]}
    want = JTP.var_params_from_torch(JVARConfig(**kw), sd)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, p)


def test_convert_checkpoint_vqvae_matches_the_jax_converter(tmp_path, monkeypatch):
    monkeypatch.setattr(convert_checkpoint, "VQVAEConfig", _tiny_vae)
    kw = dict(TINY_VAE, patch_nums=(1, 2, 3))
    p = init_vqvae_params(VQVAEConfig(**kw), seed=5, device="cpu", eini=1.0)
    sd = _vqvae_state_dict(VQVAEConfig(**kw), p)
    path = str(tmp_path / "vae.pth")
    torch.save(sd, path)
    out = str(tmp_path / "out")
    res = convert_checkpoint.run(out, vae=path, patch_nums="1_2_3", device="cpu")
    got, meta = CK.load_checkpoint(res["vqvae"], init_vqvae_params(
        VQVAEConfig(**kw), seed=0, device="cpu"))
    assert meta["kind"] == "vqvae" and meta["patch_nums"] == [1, 2, 3]
    _assert_trees_equal(got, JTP.vqvae_params_from_torch(JVQVAEConfig(**kw), sd))


# ---------------------------------------------------------------------------
# pretokenize
# ---------------------------------------------------------------------------

def test_pretokenize_cli_matches_pretokenize_dataset_and_resumes(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(pretokenize, "VQVAEConfig", _tiny_vae)
    monkeypatch.setattr(pretokenize, "patch_nums_for_reso", lambda r: (1, 2, 3))
    out = str(tmp_path / "cli")
    argv = ["--out", out, "--reso", "6", "--passes", "2", "--batch", "4",
            "--shard-size", "8", "--synthetic-len", "12", "--seed", "3",
            "--device", "cpu"]
    pretokenize.main(argv)
    assert "seed-initialized VQVAE" in capsys.readouterr().out
    cfg = _tiny_vae()
    ref = str(tmp_path / "ref")
    m = pretokenize_dataset(
        cfg, init_vqvae_params(cfg, seed=3, device="cpu"),
        build_token_datasets_for_passes(None, 6, 2, seed=3, synthetic_len=12),
        ref, batch=4, shard_size=8, log_every=0)
    assert m["num_shards"] == 2 and m["passes"] == 2
    names = sorted(f for f in os.listdir(ref) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    for f in names:
        np.testing.assert_array_equal(np.load(os.path.join(out, f)),
                                      np.load(os.path.join(ref, f)), err_msg=f)
    # a second run: the finished shard 0 is skipped, shard 1 made again
    stamps = {f: os.path.getmtime(os.path.join(out, f)) for f in names}
    os.remove(os.path.join(out, "tokens_00001.npy"))
    pretokenize.main(argv)
    for f in ("tokens_00000.npy", "labels_00000.npy"):
        assert os.path.getmtime(os.path.join(out, f)) == stamps[f], f
    np.testing.assert_array_equal(np.load(os.path.join(out, "tokens_00001.npy")),
                                  np.load(os.path.join(ref, "tokens_00001.npy")))


# ---------------------------------------------------------------------------
# bench_train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [], ["remat", "sgd"], ["bf16params", "tok16"], ["reso512", "remat"],
    ["adafactor", "tokens"]])
def test_bench_train_step_runs_on_the_cpu(tiny, flags):
    r = bench_train.run(["step", "16", "2", "1"] + flags, device="cpu")
    assert r["card"] == "cpu" and r["ms"] > 0 and np.isfinite(r["losses"]).all()
    assert r["L"] == (21 if "reso512" in flags else 14)
    assert r["mfu"] == 6.0 * r["params"] * 2 * r["L"] / (r["ms"] / 1e3) / 989e12


def test_bench_train_other_modes_run_on_the_cpu(tiny, capsys):
    rows = bench_train.run(["accum", "16", "4"], device="cpu")
    assert len(rows) == 3 and all(r["ms"] > 0 for r in rows)
    for enc in (["bf16"], ["nhwc"], []):
        assert bench_train.run(["tokenize", "2"] + enc, device="cpu")["ms"] > 0
    r = bench_train.run(["varonly", "16", "2", "remat"], device="cpu")
    assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
    r = bench_train.run(["loader", "8"])
    assert r["python_img_per_s"] > 0
    assert "native_img_per_s" in r or r["native_error"]
    mfu_lines = [x for x in capsys.readouterr().out.splitlines() if "MFU" in x]
    assert len(mfu_lines) == 4  # accum's three steps and varonly
    assert all("989 TFLOP/s" in x and "197e12" not in x for x in mfu_lines)
    assert bench_train.H100_BF16_PEAK == 989e12
    with pytest.raises(ValueError, match="unknown mode"):
        bench_train.run(["train"], device="cpu")


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _jax_stack(shared: bool, pns):
    kw = dict(depth=2, num_classes=10, patch_nums=pns, vocab_size=64, Cvae=8,
              head_dim=32, cond_drop_rate=0.0, drop_path_rate=0.0,
              shared_aln=shared)
    p = jax.tree.map(np.asarray, jax.jit(JM.init_var_params, static_argnums=0)(
        JVARConfig(**kw), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    for name in ("q_bias", "v_bias", "proj_b", "fc2_b"):
        p["blocks"][name] = rng.normal(0, 0.05, p["blocks"][name].shape
                                       ).astype(np.float32)
    return JVARConfig(**kw), VARConfig(**kw), p


@pytest.mark.parametrize("case", ["bf16params", "reso512_shared_aln"])
def test_bench_train_steps_match_jax(case):
    """One train_step of the port and of the JAX package on the same weights
    (carried across by ``utils/from_jax.py``), the same ids (the token
    path) and a deterministic forward (no cond drop, no drop path: no
    draws on either side): the loss within 1e-5 relative
    (``tests/test_torch_trainer.py``'s bound), the grad norm too for f32
    leaves. ``bf16params``: the parameters, their gradients and Adam's
    moments in bf16 (the forward in f32, so that only the leaves' dtype
    differs from the f32 case), the step keeping the leaves bf16; the
    gradients are bf16 on both sides, so each leaf is held within one bf16
    step of its size and the norm within one bf16 step;
    ``reso512_shared_aln``: shared AdaLN at the 512px preset's first scales
    (1-2-4)."""
    bf16 = case == "bf16params"
    pns = (1, 2, 3) if bf16 else (1, 2, 4)
    jcfg, cfg, p = _jax_stack(shared=not bf16, pns=pns)
    if bf16:
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), p)
    jvae = JVQVAEConfig(patch_nums=pns, **TINY_VAE)
    vae_cfg = VQVAEConfig(patch_nums=pns, **TINY_VAE)
    vp = init_vqvae_params(vae_cfg, seed=0, device="cpu", eini=1.0)
    jvp = jax.tree.map(lambda t: t.numpy(), vp)
    gt = np.random.default_rng(3).integers(0, 64, (4, cfg.L)).astype(np.int32)
    label = np.array([0, 3, 5, 9], np.int32)
    jst = JT.init_train_state(jax.tree.map(jnp.asarray, p))
    jst, jm = JT.train_step(jcfg, jvae, jst, jvp, jnp.asarray(gt),
                            jnp.asarray(label), jnp.asarray(1e-4, jnp.float32),
                            jnp.asarray(0.05, jnp.float32), jax.random.PRNGKey(0),
                            label_smooth=0.1, dtype=jnp.float32,
                            pretokenized=True)
    state = T.init_train_state(var_params_from_jax(p, device="cpu"))
    state, m = T.train_step(cfg, vae_cfg, state, vp, torch.from_numpy(gt),
                            torch.from_numpy(label), 1e-4, 0.05, None,
                            label_smooth=0.1, dtype=torch.float32,
                            pretokenized=True)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    if bf16:
        # the gradients are bf16 on both sides, each element rounded once
        # from f32 sums taken in another order: each leaf within one bf16
        # step (eps, 2^-7) of its size of JAX's, and the norm, which JAX
        # reports in bf16, within one step of it
        eps = torch.finfo(torch.bfloat16).eps
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            eps * float(jm["grad_norm"])
        ids = [jnp.asarray(gt[:, bg:ed]) for bg, ed in jcfg.begin_ends]
        x_in = JQ.idx_to_var_input(jvae, jvp["quant"], ids)
        jg = jax.jit(jax.grad(lambda q: JT.loss_and_metrics(
            jcfg, q, jnp.asarray(label), x_in, jnp.asarray(gt), None, 0.1,
            dtype=jnp.float32)[0]))(jax.tree.map(jnp.asarray, p))
        assert {str(a.dtype) for a in jax.tree.leaves(jg)} == {"bfloat16"}
        jflat = _flat_np(jg)
        leaves = T.tree_map(lambda t: t.detach().requires_grad_(),
                            var_params_from_jax(p, device="cpu"))
        _, tgt, tx = T.tokenize(cfg, vae_cfg, vp, torch.from_numpy(gt),
                                pretokenized=True)
        loss, _ = T.loss_and_metrics(cfg, leaves, torch.from_numpy(label), tx,
                                     tgt, None, 0.1, dtype=torch.float32)
        grads = torch.autograd.grad(loss, [t for _, t in T.tree_leaves(leaves)])
        for (path, _), g in zip(T.tree_leaves(leaves), grads):
            assert g.dtype == torch.bfloat16, path
            w = jflat[path]
            err = np.abs(g.float().numpy().astype(np.float64) - w).max()
            assert err <= eps * np.abs(w).max(), (path, err, np.abs(w).max())
    else:
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    want = torch.bfloat16 if bf16 else torch.float32
    assert {t.dtype for _, t in T.tree_leaves(state.params)} == {want}
    assert {t.dtype for _, t in T.tree_leaves(state.opt_state["mu"])} == {want}
    assert all(torch.isfinite(t.float()).all() for _, t in T.tree_leaves(state.params))
    if not bf16:
        assert "ada_gss" in state.params["blocks"] and "shared_ada_lin" in state.params


# ---------------------------------------------------------------------------
# profile_train, adjudicate_mfu, calib_pixels
# ---------------------------------------------------------------------------

def _jax_flops(cfg, B):
    """tools/adjudicate_mfu.py's count, as written there."""
    w, V, d, L = cfg.embed_dim, cfg.vocab_size, cfg.depth, cfg.L
    M = B * L
    return (3 * 2 * M * (12 * w * w * d + w * V + cfg.Cvae * w),
            3 * 2 * 2 * B * L * L * w)


def test_adjudicate_mfu_runs_on_the_cpu(tiny, capsys):
    r = adjudicate_mfu.run(depth=16, bs=2, iters=1, device="cpu")
    cfg = _tiny_var()
    assert (r["gemm_flops"], r["attn_flops"]) == _jax_flops(cfg, 2)
    assert adjudicate_mfu.step_flops(VARConfig(depth=16), 32) == _jax_flops(
        VARConfig(depth=16), 32)
    assert r["mfu"] == sum(_jax_flops(cfg, 2)) / (r["step_ms"] / 1e3) / 989e12
    assert adjudicate_mfu.PEAK_BF16 == 989e12
    assert [g["name"] for g in r["gemms"]] == ["qkv", "proj", "fc1", "fc2", "head"]
    assert r["attn_fwd_bwd_ms"] > 0 and r["gemm_floor_ms"] > 0
    out = capsys.readouterr().out
    assert "[mfu] verdict:" in out and "989 TFLOP/s" in out


def test_profile_train_runs_on_the_cpu(tiny, tmp_path):
    r = profile_train.run(depth=16, batch=2, logdir=str(tmp_path), device="cpu")
    assert os.path.exists(tmp_path / "trace.json")
    assert r["mfu"] == sum(_jax_flops(_tiny_var(), 2)) / (r["step_ms"] / 1e3) / 989e12
    assert profile_train.PEAK_BF16 == 989e12
    assert r["attention_launches"] == 0  # the plain attention on the CPU
    assert r["attention_backward_ms"] > 0 and r["total_ms"] > 0
    assert r["categories"].get("GEMM (cuBLAS / CUTLASS)", 0) > 0
    assert set(r["categories"]) <= {c for c, _ in profile_train.CATEGORIES} | {"other"}


def test_profile_train_sorts_cuda_kernel_names():
    cat = profile_train.category
    assert cat("void attention_mma_kernel<64, 2>(...)") == "attention kernel (row 1)"
    assert cat("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NNN") == "GEMM (cuBLAS / CUTLASS)"
    assert cat("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == "GEMM (cuBLAS / CUTLASS)"
    assert cat("void at::native::reduce_kernel<512, 1>(...)") == "reduce / softmax"
    assert cat("void at::native::(anonymous)::cunn_SoftMaxForward<4>") == \
        "reduce / softmax"
    assert cat("void at::native::direct_copy_kernel_cuda(...)") == "copy / transpose"
    assert cat("void at::native::vectorized_elementwise_kernel<4, GeluCUDA>") == "other"


def test_calib_pixels_runs_on_the_cpu(tiny, capsys):
    calib_pixels.main(["--train-vae", "2", "--vae-bs", "2", "--batch", "2",
                       "--iters", "1", "--cal-batches", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[vae] 2 steps" in out
    verdict = [x for x in out.splitlines() if x.startswith("[verdict] ")]
    assert len(verdict) == 1 and verdict[0].split()[1] in ("PASS:", "NEGATIVE:")
    assert out.count("[pixels] calib a=") == 6
