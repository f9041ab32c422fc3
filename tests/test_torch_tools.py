"""The port's decode measuring tools on the CPU at tiny sizes (each tool's
``run`` with ``device="cpu"``, its model configurations swapped for small
ones: the modules' own config names are replaced, so their code runs as
it is), the attention backend switch and the pixel decoder's precision
argument.

The tools' configurations keep their schedules (the 512 preset, the
1024 preset's first twelve scales, 256px elsewhere) and shared AdaLN
where they set it; the widths are cut to 2 layers of 32 per head, V=64, and a
two-level VQVAE of 32 channels. Times printed here are the CPU's.
"""

import pytest
import torch

from sdvar_tpu_torch.config import PATCH_NUMS_1024, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.ops import attention as A
from sdvar_tpu_torch.ops.attention import get_attention_impl, set_attention_impl
from sdvar_tpu_torch.ops.kernels.attention import attention_plain
from sdvar_tpu_torch.tools import (
    ab_cache_write,
    bench_512,
    bench_1024,
    bench_attention_impl,
    bench_latency,
    bench_pixels,
    bench_quant,
    microbench_matmul,
    retest_negatives,
)

TOOLS = (bench_512, bench_1024, bench_attention_impl, bench_quant,
         bench_pixels, bench_latency, ab_cache_write)


def _tiny_var(depth=16, patch_nums=(1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
              shared_aln=False, **_):
    return VARConfig(depth=min(depth, 2), patch_nums=patch_nums,
                     shared_aln=shared_aln, vocab_size=64, Cvae=8, head_dim=32)


def _tiny_vae(patch_nums=(1, 2, 3, 4, 5, 6, 8, 10, 13, 16), **_):
    return VQVAEConfig(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1),
                       patch_nums=patch_nums)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes are tiny, and under the suite's
    parallel workers a pool of threads a process waits on the others'
    (measured: this file 32 s alone, 1057 s among six workers with the
    default threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    for mod in TOOLS:
        if hasattr(mod, "VARConfig"):
            monkeypatch.setattr(mod, "VARConfig", _tiny_var)
        monkeypatch.setattr(mod, "VQVAEConfig", _tiny_vae)


def test_bench_512_runs_on_the_cpu(tiny):
    out = bench_512.run(2, ("w8a8", "bf16"), repeats=2, device="cpu")
    assert list(out) == ["w8a8", "bf16"]
    for row in out.values():
        assert row["decodes"] == 5 and len(row["times_ms"]) == 2
        assert row["same_seed_ids_equal"] and row["entry_equals_f32"]
        assert 0 < row["other_seed_ids_differ"] <= 1
        assert row["ids"].shape == (2, 2240) and row["image"].shape == (2, 3, 64, 64)
        assert set(row["pixels"]) == {"f32", "nhwc-bf16", "nhwc-int8"}
        for pix in row["pixels"].values():
            img = pix["image"]
            assert img.shape == (2, 3, 64, 64) and torch.isfinite(img).all()
            assert 0 <= img.min() and img.max() <= 1
        assert row["pixels"]["f32"]["mean_abs_diff"] == 0.0
        # 64 pixels wide: every site is under min_w (256), so bf16; the
        # 512px sites are held in test_torch_presets_pixels.py
        assert row["pixels"]["nhwc-int8"]["sites_quantized"] == 0
        assert row["pixels"]["nhwc-int8"]["sites"] > 0
    with pytest.raises(ValueError, match="unknown mode"):
        bench_512.run(1, ("int4",), device="cpu")


def test_bench_1024_runs_on_the_cpu(tiny, monkeypatch):
    """The preset's first twelve scales (to 36x36, L=3051): the whole
    schedule's last scale (4096 queries over 9451 keys) takes this width
    about 11 s a decode on one CPU thread; the 14 scales run on the card
    (``chip_smoke.py``'s ``[d16-1024]`` and ``[reference 1024]``)."""
    monkeypatch.setattr(bench_1024, "PATCH_NUMS_1024", PATCH_NUMS_1024[:12])
    out = bench_1024.run(16, 1, ("w8a8-int8kv",), repeats=1, device="cpu")
    row = out["w8a8-int8kv"]
    assert row["decodes"] == 3 and row["same_seed_ids_equal"]
    assert row["ids"].shape == (1, 3051) and row["image"] is None
    assert list(row["pixels"]) == ["nhwc-bf16"]
    img = row["pixels"]["nhwc-bf16"]["image"]
    assert img.shape == (1, 3, 72, 72) and torch.isfinite(img).all()


def test_bench_attention_impl_runs_on_the_cpu(tiny):
    for impl in ("auto", "plain"):
        out = bench_attention_impl.run(impl, 2, 2, iters=1, device="cpu")
        assert out["ms"] > 0 and out["kernel_launches_per_decode"] == 0
        assert get_attention_impl() == "auto"
    with pytest.raises(ValueError, match="CUDA tensor"):
        bench_attention_impl.run("kernel", 2, 2, iters=1, device="cpu")
    assert get_attention_impl() == "auto"


def test_bench_quant_runs_every_mode_on_the_cpu(tiny):
    modes = ("bf16", "w8", "w8a8", "w8a8_head", "w8+kv8", "w8a8_head+kv8")
    out = bench_quant.run(2, 2, modes, iters=1, device="cpu")
    assert list(out) == list(modes) and all(r["ms"] > 0 for r in out.values())
    with pytest.raises(ValueError, match="unknown mode"):
        bench_quant.run(2, 2, ("w4",), device="cpu")


def test_bench_pixels_runs_its_seven_variants_on_the_cpu(tiny):
    out = bench_pixels.run(2, 1, device="cpu")
    assert list(out) == ["nchw-f32 (golden)", "nchw-bf16", "nhwc-f32",
                         "nhwc-f32-3x", "nhwc-bf16", "nhwc-w8a8",
                         "nhwc-w8a8-calib"]
    assert out["nchw-f32 (golden)"]["max_abs_diff"] == 0.0
    # on the CPU "high" is full f32, as "highest"
    assert out["nhwc-f32-3x"]["mean_abs_diff"] == out["nhwc-f32"]["mean_abs_diff"]
    assert out["nhwc-f32"]["max_abs_diff"] < 1e-4
    assert 0 < out["nhwc-bf16"]["mean_abs_diff"] < 0.05


def test_bench_latency_runs_on_the_cpu(tiny):
    out = bench_latency.run(2, 1, "int8", batches=(1, 2), device="cpu")
    for B in (1, 2):
        for name in ("seq", "spec-floor", "spec-ceil"):
            r = out[(B, name)]
            assert r["min_ms"] <= r["p50_ms"] <= r["p90_ms"]
        assert out[(B, "speedup")]["ceiling"] > 0
    with pytest.raises(ValueError, match="unknown quant"):
        bench_latency.run(2, 1, "fp4", device="cpu")


@pytest.mark.parametrize("args", [
    ["--kv", "int8", "--w8a8", "--cache-kernel", "1", "--depth", "2",
     "--batch", "2", "--iters", "1"],
    ["--weights", "fp8", "--depth", "2", "--batch", "2", "--iters", "1",
     "--reso", "512"],
])
def test_ab_cache_write_runs_on_the_cpu(tiny, monkeypatch, args):
    monkeypatch.setattr(ab_cache_write, "run", _cpu(ab_cache_write.run))
    out = ab_cache_write.main(args)
    assert out["ms"] > 0 and out["card"] == "cpu"
    assert ("cache_kernel=True" in out["tag"]) == ("--cache-kernel" in args)
    assert not A.use_cache_kernel()  # set back after the run


def _cpu(fn):
    return lambda *a, **k: fn(*a, **{**k, "device": "cpu"})


def test_microbench_matmul_runs_on_the_cpu():
    out = microbench_matmul.run((5, 7), b=2, k=16, n=8, iters=2, device="cpu")
    assert set(out) == {5, 7} and all(r["ms"] > 0 for r in out.values())


def test_retest_negatives_runs_on_the_cpu(tiny, capsys):
    out = retest_negatives.run(2, 2, iters=1, pixel_batch=2, device="cpu")
    assert set(out["cache_kernel"]) == {0, 1}
    assert set(out["pixels"]) == set(retest_negatives.PIXEL_VARIANTS)
    assert out["min_fused_rows"] is None
    assert "min_fused_rows: no counterpart" in capsys.readouterr().out


def _qkv(Lq=5, Lk=7):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, L, 2, 32, generator=g) for L in (Lq, Lk, Lk)]


def test_attention_impl_auto_plain_kernel_and_unknown():
    """"auto" (the default) takes the plain version on CPU tensors; an
    explicit name is honoured ("kernel" launches the CUDA kernel, which
    refuses CPU tensors); an unknown name raises and leaves the setting."""
    q, k, v = _qkv()
    want = attention_plain(q, k, v, None, 0.25)
    assert get_attention_impl() == "auto"
    assert torch.equal(A.attention(q, k, v, None, 0.25), want)
    try:
        set_attention_impl("plain")
        assert torch.equal(A.attention(q, k, v, None, 0.25), want)
        set_attention_impl("kernel")
        for call in (lambda: A.attention(q, k, v, None, 0.25),
                     lambda: A.attention_cache(
                         q, torch.zeros(1, 2, 7, 64), torch.zeros(1, 2, 7, 64),
                         0, 7, None, 0.25)):
            with pytest.raises(ValueError, match="CUDA"):
                call()
        with pytest.raises(ValueError, match="unknown attention impl"):
            set_attention_impl("xla")
        assert get_attention_impl() == "kernel"
    finally:
        set_attention_impl("auto")


def test_fhat_to_img_nhwc_precision():
    """"highest" is bit-equal to the f32 decode without the argument, "high"
    equals it on the CPU (no TF32 there) and sets the caller's TF32 flags
    back, and a name the JAX function refuses raises."""
    cfg = _tiny_vae((1, 2, 3))
    p = VQ.init_vqvae_params(cfg, seed=0, device="cpu")
    f_hat = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(1))
    base = VQ.fhat_to_img_nhwc(cfg, p, f_hat, dtype=torch.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for prec in ("highest", "high"):
        got = VQ.fhat_to_img_nhwc(cfg, p, f_hat, dtype=torch.float32,
                                  precision=prec)
        assert torch.equal(got, base)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="precision"):
            VQ.fhat_to_img_nhwc(cfg, p, f_hat, dtype=dtype, precision="bf16_3x")
