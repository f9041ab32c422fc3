"""The port's entry points and measuring tools against the JAX package's,
at a small size on the CPU: the FID sampler (``sample_fid``,
``utils/fid``), the benchmark CLI's five modes, ``bench.bench_decode`` and
its one-line output, and ``tools/bench_serving.run``. The card-only
figures (times, rates) come from ``chip_smoke.py``; here the paths run and
their outputs are compared."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdvar_tpu import sample_fid as JS
from sdvar_tpu.config import SamplingConfig as JSamplingConfig
from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.engine.speculative import SpecStats as JSpecStats
from sdvar_tpu.utils import fid as JF
from sdvar_tpu_torch import bench, benchmark_cli, sample_fid
from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.tools import bench_serving
from sdvar_tpu_torch.utils import fid
from sdvar_tpu_torch.utils.from_jax import var_params_from_jax, vqvae_params_from_jax

REPO = Path(__file__).resolve().parents[1]
PNS = (1, 2, 3)
VAR_KW = dict(depth=2, num_classes=10, patch_nums=PNS, vocab_size=64, Cvae=8,
              attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
              head_dim=32)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS)


def _tiny_var(depth=2, patch_nums=PNS, **_):
    return VARConfig(depth=min(depth, 2), patch_nums=PNS, vocab_size=64, Cvae=8,
                     head_dim=32)


def _tiny_vae(patch_nums=PNS, **_):
    return VQVAEConfig(**VAE_KW)


@pytest.fixture
def tiny_configs(monkeypatch):
    """The entry points' model configurations cut to the small stack
    (depth as asked up to 2, widths 32 per head, 3 scales, V=64, the 1000
    classes kept): the modules' own config names are replaced, so their
    code runs as it is."""
    for mod in (bench, bench_serving, benchmark_cli):
        monkeypatch.setattr(mod, "VARConfig", _tiny_var)
        monkeypatch.setattr(mod, "VQVAEConfig", _tiny_vae)


@pytest.mark.parametrize("num,classes", [(50_000, 1000), (2_500, 1000),
                                         (1_234, 1000), (37, 10)])
def test_balanced_labels_equal_jax(num, classes):
    np.testing.assert_array_equal(sample_fid.balanced_labels(num, classes),
                                  JS.balanced_labels(num, classes))


def test_images01_to_uint8_equal_jax():
    """Out-of-range values clip, half steps round to even, NCHW -> NHWC."""
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (3, 3, 8, 5)).astype(np.float32)
    x[0, 0, 0, :3] = np.array([0.5, 1.5, 2.5]) / 255.0
    got = fid.images01_to_uint8(x)
    assert got.dtype == np.uint8 and got.shape == (3, 8, 5, 3)
    np.testing.assert_array_equal(got, JF.images01_to_uint8(x))


def test_npz_round_trip(tmp_path):
    """Batches in, exactly ``num`` uint8 images out under ``arr_0``, the
    same bytes as the JAX package's writer; fewer images than asked
    raise; PNGs written and packed again give the same array."""
    rng = np.random.default_rng(1)
    batches = [rng.uniform(0, 1, (4, 3, 16, 16)).astype(np.float32) for _ in range(3)]
    ours = fid.create_npz_from_arrays(iter(batches), str(tmp_path / "a.npz"), num=10)
    theirs = JF.create_npz_from_arrays(iter(batches), str(tmp_path / "b.npz"), num=10)
    a, b = np.load(ours)["arr_0"], np.load(theirs)["arr_0"]
    assert a.shape == (10, 16, 16, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, fid.images01_to_uint8(np.concatenate(batches))[:10])
    with pytest.raises(ValueError, match="12 images, 13"):
        fid.create_npz_from_arrays(iter(batches), str(tmp_path / "c.npz"), num=13)
    fid.save_sample_pngs(batches[0], str(tmp_path / "png"), start_idx=0)
    fid.save_sample_pngs(batches[1], str(tmp_path / "png"), start_idx=4)
    packed = fid.create_npz_from_sample_folder(str(tmp_path / "png"), num=8)
    np.testing.assert_array_equal(np.load(packed)["arr_0"], a[:8])


@pytest.fixture(scope="module")
def stack():
    """Small stack from the port's initialisers (a real head, a unit-scale
    codebook), as numpy for JAX and through the bridge for the port."""
    vp = jax.tree.map(lambda t: t.numpy(), init_var_params(
        VARConfig(**VAR_KW), seed=12, device="cpu"))
    vp["head"]["w"] = np.random.default_rng(12).normal(
        0, 0.05, vp["head"]["w"].shape).astype(np.float32)
    qp = jax.tree.map(lambda t: t.numpy(), init_vqvae_params(
        VQVAEConfig(**VAE_KW), seed=6, device="cpu", eini=1.0))
    return vp, qp, var_params_from_jax(vp, device="cpu"), vqvae_params_from_jax(
        qp, device="cpu")


def test_sample_batches_greedy_matches_jax(stack):
    """Greedy f32 with the golden pixel decoder: five labels in batches of
    two (the last one padded and cut) give images within 1e-3 of the JAX
    package's ``sample_batches`` on the same weights, in the same order."""
    vp, qp, tvp, tqp = stack
    labels = np.array([3, 7, 1, 0, 9], np.int32)
    want = list(JS.sample_batches(JVARConfig(**VAR_KW), JVQVAEConfig(**VAE_KW),
                                  vp, qp, labels, 2, JSamplingConfig(cfg=1.5, top_k=1),
                                  dtype=jnp.float32, log_every=0))
    got = list(sample_fid.sample_batches(
        VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW), tvp, tqp, labels, 2,
        SamplingConfig(cfg=1.5, top_k=1), dtype=torch.float32, log_every=0,
        device="cpu"))
    assert [b.shape for b in got] == [(2, 3, 48, 48)] * 2 + [(1, 3, 48, 48)]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=1e-3, atol=1e-3)


def test_sample_batches_seeds_and_worker_errors(stack, tmp_path):
    """Sample i runs with seed seed0 + i, so a sample does not depend on
    its batch (its tokens are the same; the f32 pixel convolutions may
    pick another algorithm for another batch size, hence 1e-5); the npz
    gets every sample; an exception in the dispatcher thread reaches the
    consumer."""
    _, _, tvp, tqp = stack
    vc, qc = VARConfig(**VAR_KW), VQVAEConfig(**VAE_KW)
    samp = SamplingConfig(cfg=1.5, top_k=8, top_p=0.9)
    labels = np.arange(6, dtype=np.int32) % 10

    def run(batch, pixels="f32", kv_mode="bf16"):
        return np.concatenate(list(sample_fid.sample_batches(
            vc, qc, tvp, tqp, labels, batch, samp, dtype=torch.float32,
            kv_mode=kv_mode, seed0=5, log_every=0, pixels=pixels,
            device="cpu")))

    a = run(2)
    np.testing.assert_allclose(a, run(3), rtol=0, atol=1e-5)
    assert run(4, pixels="bf16", kv_mode="int8").shape == a.shape
    out = fid.create_npz_from_arrays(iter([a]), str(tmp_path / "s.npz"), num=6)
    assert np.load(out)["arr_0"].shape == (6, 48, 48, 3)
    with pytest.raises(KeyError):
        list(sample_fid.sample_batches(vc, qc, tvp, {"no_quant": None}, labels,
                                       2, samp, log_every=0, device="cpu"))


def _jax_row_keys():
    """The keys of the JSON rows each mode of ``sdvar_tpu/benchmark_cli.py``
    prints, read from its source: the string keys of the dict literals in
    the mode's function, plus ``SpecStats.as_dict()``'s where the row
    spreads it."""
    tree = ast.parse((REPO / "sdvar_tpu" / "benchmark_cli.py").read_text())
    spec_keys = set(JSpecStats().as_dict())
    keys = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("mode_"):
            ks = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    for k in node.keys:
                        if k is None:
                            ks |= spec_keys
                        elif isinstance(k, ast.Constant):
                            ks.add(k.value)
            keys[fn.name] = ks
    return keys


@pytest.fixture(scope="module")
def cli_engine():
    """The CLI's engine, d1 draft -> d2 target at the small stack's widths,
    on the CPU (one per module: the modes share it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(benchmark_cli, "VARConfig", _tiny_var)
        mp.setattr(benchmark_cli, "VQVAEConfig", _tiny_vae)
        args = benchmark_cli.parse_args([
            "--depth-draft", "1", "--depth-target", "2", "--patch-nums", "1_2_3",
            "--batch", "2", "--iters", "1", "--labels", "3", "7",
            "--entry-num", "2"])
        return benchmark_cli.build_engine(args, device="cpu"), args


@pytest.mark.parametrize("mode", ["gamma", "seqspec", "quality", "quant", "handoff"])
def test_benchmark_cli_mode_rows_have_jax_keys(cli_engine, mode, capsys):
    """Each mode runs on the small engine and prints JSON rows with exactly
    the JAX package's keys (fp8 among the quant rows)."""
    eng, args = cli_engine
    out = benchmark_cli.MODES[mode](eng, args)
    rows = out if isinstance(out, list) else [out]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == json.loads(json.dumps(rows))
    want = _jax_row_keys()[benchmark_cli.MODES[mode].__name__]
    assert all(set(r) == want for r in rows), (rows[0].keys(), want)
    if mode == "quant":
        assert [r["quant"] for r in rows] == ["w8", "fp8", "w8a8", "w8a8+int8kv"]
        assert all(len(r["per_scale_agreement"]) == len(PNS) for r in rows)
    if mode == "gamma":
        assert [r["gamma"] for r in rows] == [1, 2, 3]


def test_benchmark_cli_refuses_quantized_quant_mode():
    with pytest.raises(SystemExit):
        benchmark_cli.parse_args(["--mode", "quant", "--quant", "w8"])


@pytest.mark.parametrize("w8a8,kv_mode", [(False, "bf16"), (True, "int8")])
def test_bench_decode_runs_on_the_cpu(tiny_configs, w8a8, kv_mode):
    ips = bench.bench_decode(1, 2, iters=1, w8a8=w8a8, kv_mode=kv_mode,
                             device="cpu")
    assert ips > 0


def test_bench_main_prints_one_json_line(monkeypatch, capsys):
    """stdout holds exactly one JSON line with the four keys; the headline
    is the W8A8 + INT8-KV decode at B=32, the bf16 B=16 decode and the card
    go to stderr."""
    calls = []

    def fake_decode(depth, batch, w8a8=False, kv_mode="bf16", **_):
        calls.append((depth, batch, w8a8, kv_mode))
        return 10.0 if w8a8 else 20.0

    class Smi:
        stdout = "a card, 700.00 W\n"

    monkeypatch.setattr(bench, "bench_decode", fake_decode)
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: Smi())
    bench.main()
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["value"] == 10.0 and row["vs_baseline"] == 5.0
    assert "estimated, not measured" in row["metric"]
    assert calls == [(30, 32, True, "int8"), (30, 16, False, "bf16")]
    assert "a card, 700.00 W" in err


@pytest.mark.parametrize("mode", ["bf16", "w8a8-int8kv-u8", "spec", "pixq-u8"])
def test_bench_serving_runs_on_the_cpu(tiny_configs, mode):
    out = bench_serving.run(1, 3, 2, mode, device="cpu")
    assert out["requests"] == 3 and out["batches"] == 2
    assert out["img_per_s"] > 0 and out["p50_ms"] <= out["p95_ms"] <= out["max_ms"]
    assert out["deliver"] == ("u8" if mode.endswith("-u8") else "f32")
    assert ("spec_target_calls_per_batch" in out) == mode.startswith("spec")


def test_bench_serving_mesh_and_unknown_modes_raise():
    with pytest.raises(NotImplementedError, match="mesh"):
        bench_serving.run(1, 1, 1, "mesh", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        bench_serving.run(1, 1, 1, "fp16", device="cpu")
