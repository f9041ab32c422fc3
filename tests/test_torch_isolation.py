"""The port stands alone: no JAX and nothing of the JAX package in
``sdvar_tpu_torch`` or ``chip_smoke.py``, and its entry points never drop
to the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "sdvar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "sdvar_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


PACKAGE_FILES = sorted((REPO / "sdvar_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", PACKAGE_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_triton_imports_in_the_package(path):
    """Every kernel of the port is CUDA C++ loaded with ctypes: no module
    imports triton, at its top or inside a function."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] == "triton"]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_jax_out():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import sdvar_tpu_torch.engine.decode, sdvar_tpu_torch.utils.from_jax;"
        "import sdvar_tpu_torch.models.vqvae, sdvar_tpu_torch.ops.kernels._build;"
        "import sdvar_tpu_torch.engine.serving, sdvar_tpu_torch.ops.conv_s8;"
        "import sdvar_tpu_torch.engine.speculative, sdvar_tpu_torch.engine.probes;"
        "import sdvar_tpu_torch.ops.masks;"
        "import sdvar_tpu_torch.bench, sdvar_tpu_torch.benchmark_cli;"
        "import sdvar_tpu_torch.sample_fid, sdvar_tpu_torch.utils.fid;"
        "import sdvar_tpu_torch.utils.torch_port, sdvar_tpu_torch.ops.kernels.w8a8_fused;"
        "import sdvar_tpu_torch.tools.bench_serving;"
        "import sdvar_tpu_torch.tools.microbench_int8_matmul;"
        "import sdvar_tpu_torch.tools.bench_512, sdvar_tpu_torch.tools.bench_1024;"
        "import sdvar_tpu_torch.tools.bench_attention_impl;"
        "import sdvar_tpu_torch.tools.bench_quant, sdvar_tpu_torch.tools.bench_pixels;"
        "import sdvar_tpu_torch.tools.bench_latency;"
        "import sdvar_tpu_torch.tools.ab_cache_write;"
        "import sdvar_tpu_torch.tools.microbench_matmul;"
        "import sdvar_tpu_torch.tools.retest_negatives;"
        "import sdvar_tpu_torch.tools.convert_checkpoint, sdvar_tpu_torch.tools.pretokenize;"
        "import sdvar_tpu_torch.tools.bench_train, sdvar_tpu_torch.tools.profile_train;"
        "import sdvar_tpu_torch.tools.adjudicate_mfu, sdvar_tpu_torch.tools.calib_pixels;"
        "import sdvar_tpu_torch.tools.train_pair, sdvar_tpu_torch.tools.probe_train_determinism;"
        "import sdvar_tpu_torch.tools.probe_factored_pieces;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sdvar_tpu')];"
        "assert not bad, bad"
    )
    # -I: ignore PYTHONPATH and user site, so no site hook can pull JAX in
    res = subprocess.run([sys.executable, "-I", "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
    from sdvar_tpu_torch.engine.decode import generate_images
    from sdvar_tpu_torch.models.var import init_var_params
    from sdvar_tpu_torch.models.vqvae import init_vqvae_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VARConfig(depth=1, patch_nums=(1, 2), vocab_size=64, Cvae=8,
                    head_dim=32)
    vae_cfg = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_var_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_vqvae_params(vae_cfg)
    params = init_var_params(cfg, device="cpu")
    vae = init_vqvae_params(vae_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_images(cfg, vae_cfg, params, vae, [0])


def test_server_raises_without_a_card(monkeypatch):
    from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
    from sdvar_tpu_torch.engine.serving import GenerationServer
    from sdvar_tpu_torch.models.var import init_var_params
    from sdvar_tpu_torch.models.vqvae import init_vqvae_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VARConfig(depth=1, patch_nums=(1, 2), vocab_size=64, Cvae=8,
                    head_dim=32)
    vae_cfg = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2))
    params = init_var_params(cfg, device="cpu")
    vae = init_vqvae_params(vae_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationServer(cfg, vae_cfg, params, vae)
    GenerationServer(cfg, vae_cfg, params, vae, device="cpu")


def test_speculative_engine_raises_without_a_card(monkeypatch):
    """Built on parameters of the default device, the engine asks for the
    card, as ``generate_images`` does; ``device="cpu"`` runs the plain
    path."""
    from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
    from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
    from sdvar_tpu_torch.models.var import init_var_params
    from sdvar_tpu_torch.models.vqvae import init_vqvae_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VARConfig(depth=1, patch_nums=(1, 2), vocab_size=64, Cvae=8,
                    head_dim=32)
    vae_cfg = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2))
    params = init_var_params(cfg, device="cpu")
    vae = init_vqvae_params(vae_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeEngine(vae_cfg, cfg, cfg, vae, params, params)
    eng = SpeculativeEngine(vae_cfg, cfg, cfg, vae, params, params,
                            device="cpu")
    f_hat, stats = eng.generate_speculative([0], 0)
    assert f_hat.shape == (1, 8, 2, 2) and stats.accept_count == 2


def test_measuring_entry_points_raise_without_a_card(monkeypatch):
    """The bench, the FID sampler, the benchmark CLI's engine, the serving
    bench, the microbenchmarks and the decode measuring tools ask for the
    card by default and raise without one; none of them drops to the CPU
    on its own."""
    import numpy as np

    from sdvar_tpu_torch import bench, benchmark_cli, sample_fid
    from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
    from sdvar_tpu_torch.tools import (
        ab_cache_write,
        bench_512,
        bench_1024,
        bench_attention_impl,
        bench_latency,
        bench_pixels,
        bench_quant,
        bench_serving,
        microbench_int8_matmul,
        microbench_matmul,
        retest_negatives,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VARConfig(depth=1, patch_nums=(1, 2), vocab_size=64, Cvae=8,
                    head_dim=32)
    vae_cfg = VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2))
    calls = [
        lambda: bench.bench_decode(1, 1),
        lambda: next(sample_fid.sample_batches(cfg, vae_cfg, {}, {}, np.zeros(1),
                                               1, SamplingConfig())),
        lambda: benchmark_cli.build_engine(benchmark_cli.parse_args(
            ["--depth-draft", "1", "--depth-target", "1"])),
        lambda: bench_serving.run(1, 1, 1, "bf16"),
        lambda: microbench_int8_matmul.run(),
        lambda: bench_512.run(),
        lambda: bench_1024.run(),
        lambda: bench_attention_impl.run("auto"),
        lambda: bench_quant.run(),
        lambda: bench_pixels.run(),
        lambda: bench_latency.run(),
        lambda: ab_cache_write.run(),
        lambda: microbench_matmul.run(),
        lambda: retest_negatives.run(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
