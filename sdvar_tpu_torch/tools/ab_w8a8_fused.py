"""A/B of two versions of the fused W8A8 matmul (kernel row 10) on one
card, in turns.

    mkdir -p build/parent
    git archive <commit> sdvar_tpu_torch | tar -x -C build/parent
    python3 -m sdvar_tpu_torch.tools.ab_w8a8_fused build/parent [--ablate]

Builds ``OTHER_ROOT/sdvar_tpu_torch/csrc/w8a8_fused.cu`` (another checkout
of this repository, e.g. a parent commit unpacked as above into a
directory under ``build/``) beside this checkout's, loads each version's
wrapper (``ops/kernels/w8a8_fused.py``) by its path with its own library,
and calls both through ``w8a8_fused_kernel``.

Shapes: the microbenchmark's six (``tools/microbench_int8_matmul.py``:
the d30 decode's fc1, fc2 and qkv at scale 9, fc2 at scale 8, fc1 at scale
5 and the head at scale 9, B=32 requests, CFG doubled) and the ragged fc1
at scale 4 (M=800), each in both forms (s8 and bf16). Each runs in the
order other, this, this, other, three times over; each time is the mean
device time of 20 launches queued behind a spin kernel. Beside them, on
the same operands: ``torch._int_mm`` (the exact int8 product alone, on
x already in int8) and the port's three-launch ``w8a8_matmul`` (the
act-quant kernel, ``torch._int_mm``, the epilogue). It prints each
shape's best of each version, the speedup (other / this), the bound
(``chip_smoke.py:w8a8_fused_bound``) and this version's agreement with
``w8a8_fused_plain`` (bit-equal in the s8 form; the bf16 form within
2^-7 of max|y| on at most 1e-3 of the outputs). The last line is one
JSON object with every number and the card's name and power limit.

``--ablate`` also times copies of each version with one part taken out
(the parent: the amax prologue, the in-loop quantization, the products;
a version on wgmma: the quantization phase, the products, the epilogue's
stores) at fc1 s9 and fc2 s9 in the s8 form: an ablated kernel computes a
wrong result, and its time only says what the part it lacks costs. Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.w8a8_fused import w8a8_fused_plain
from sdvar_tpu_torch.ops.quantization import as_w8a8, w8a8_matmul
from sdvar_tpu_torch.tools import microbench_int8_matmul as mb
from sdvar_tpu_torch.tools.ab_act_quant import (
    _Libs,
    edited,
    load_module,
    nvcc_finish,
    nvcc_start,
)
from sdvar_tpu_torch.tools.ab_attention import _ms

HBM_BPS, INT8_OPS, BF16_FLOPS = 3.35e12, 1979e12, 989e12  # H100 SXM data sheet
SHAPES = mb.SHAPES + ((25, 1920, 7680, "fc1 s4"),)
MODULE = Path("sdvar_tpu_torch") / "ops" / "kernels" / "w8a8_fused.py"
SOURCE = Path("sdvar_tpu_torch") / "csrc" / "w8a8_fused.cu"
ITERS = 20

# design -> {name: [(text, replacement, occurrences)]}: edits that take one
# part of the kernel out; the first version's products are mma.sync
# (``mma_s8``), a later version's wgmma
ABLATIONS = {
    "mma.sync": {
        "no amax prologue": [("      for (int k = lane * VEC; k < K; k += 32 * VEC) {",
                              "      for (int k = lane * VEC; k < 0; k += 32 * VEC) {", 1)],
        "no in-loop quantization": [
            ("        q[i * VEC + j] = (int8_t)__float2int_rn(rintf(__fdiv_rn(f[j], a_scale)));",
             "        q[i * VEC + j] = (int8_t)__float_as_uint(f[j]);", 1)],
        "no products": [
            ("        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);",
             "        for (int j = 0; j < NT; ++j) acc[i][j][0] += a[i][0] ^ b[j][0];", 1),
            ("          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);",
             "          for (int j = 0; j < NT; ++j) acc[i][j][0] += __uint_as_float(a[i][0] ^ b[j][0]);", 1)],
    },
    "wgmma": {
        "no quantization": [("      quantize_rows<XT, S8>(", "      if (false) quantize_rows<XT, S8>(", 1)],
        "no products": [("        stage_products<S8>(acc, arrived(), wg, step == first);",
                         "        if (step < 0) stage_products<S8>(acc, arrived(), wg, step == first);\n"
                         "        else arrived();", 1)],
        "no stores": [("            store_row(out + m * N, n, v0, v1, N);",
                       "            if (v0 == 12345.f) store_row(out + m * N, n, v0, v1, N);", 1)],
    },
}


def design(src: Path) -> str:
    return "mma.sync" if "mma_s8(acc" in src.read_text() else "wgmma"


def _versions(root: Path, ablate: bool):
    """{tag: module}: other, this and, with ``ablate``, the ablated copies
    of each, every source built by its own nvcc, all started together."""
    build = _build.BUILD_ROOT.parent / "ab_w8a8_fused"
    jobs = {}
    for tag, base in (("other", root), ("this", _build.CSRC.parents[1])):
        src, py = base / SOURCE, base / MODULE
        variants = {tag: src}
        if ablate:
            for name, edits in ABLATIONS[design(src)].items():
                d = build / f"{tag}_{name.replace(' ', '_')}"
                d.mkdir(parents=True, exist_ok=True)
                (d / "w8a8_fused.cu").write_text(
                    edited(src.read_text(), edits, str(src)))
                variants[f"{tag} {name}"] = d / "w8a8_fused.cu"
        for vt, s in variants.items():
            so = build / vt.replace(" ", "_") / "libw8a8_fused.so"
            jobs[vt] = (nvcc_start(s, so), so, py)
    out = {}
    for vt, (proc, so, py) in jobs.items():
        nvcc_finish(proc, vt, "w8a8")
        mod = load_module(py, "ab_w8a8_" + vt.replace(" ", "_").replace("-", "_"))
        mod._build = _Libs({"w8a8_fused": ctypes.CDLL(str(so))})
        out[vt] = mod
    return out


def bound_ms(M, K, N, s8):
    """``chip_smoke.py:w8a8_fused_bound``."""
    t_bytes = (M * K * 2 + K * N + N * 4 + M * N * 2) / HBM_BPS * 1e3
    t_ops = 2 * M * K * N / (INT8_OPS if s8 else BF16_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def agreement(mod, x, wq, ws, s8) -> dict:
    got = mod.w8a8_fused_kernel(x, wq, ws, s8)
    want = w8a8_fused_plain(x, wq, ws, s8)
    d = (got.float() - want.float()).abs()
    frac = (d != 0).float().mean().item()
    if s8:
        ok = torch.equal(got, want)
    else:
        ok = (d.max().item() <= 2 ** -7 * want.float().abs().max().item()
              and frac <= 1e-3)
    return {"max_abs_err": d.max().item(), "differ": frac, "ok": bool(ok)}


def main(argv) -> int:
    ablate = "--ablate" in argv
    roots = [a for a in argv if a != "--ablate"]
    if len(roots) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    vers = _versions(Path(roots[0]), ablate)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    print(f"other: {design(Path(roots[0]) / SOURCE)}, this: "
          f"{design(_build.CSRC / 'w8a8_fused.cu')}", flush=True)
    result = {"card": card, "shapes": []}
    for L, K, N, tag in SHAPES:
        x, wq, ws, _ = mb.operands(L, K, N, "cuda", seed=11)
        M = x.shape[0] * L
        x8 = x.reshape(-1, K).to(torch.int8)
        qw = as_w8a8(wq, ws)
        row = {"shape": tag, "M": M, "K": K, "N": N,
               "int_mm_ms": min(_ms(lambda: torch._int_mm(x8, wq), ITERS)
                                for _ in range(2)),
               "w8a8_matmul_ms": min(_ms(lambda: w8a8_matmul(x, qw, torch.bfloat16),
                                         ITERS) for _ in range(2))}
        for s8 in (True, False):
            form = "s8" if s8 else "bf16"
            runs = {v: (lambda m=vers[v]: m.w8a8_fused_kernel(x, wq, ws, s8))
                    for v in ("other", "this")}
            ms = {"other": [], "this": []}
            for _ in range(3):
                for v in ("other", "this", "this", "other"):
                    ms[v].append(_ms(runs[v], ITERS))
            best = {v: min(t) for v, t in ms.items()}
            bnd, by = bound_ms(M, K, N, s8)
            check = agreement(vers["this"], x, wq, ws, s8)
            row[form] = {"other_ms": best["other"], "this_ms": best["this"],
                         "bound_ms": bnd, "bound_by": by, "check": check}
            print(f"{tag} M={M} K={K} N={N} {form}: other {best['other']:.4f} ms,"
                  f" this {best['this']:.4f} ms; speedup "
                  f"{best['other'] / best['this']:.3f}x; bound {bnd:.4f} ms ({by};"
                  f" this at {bnd / best['this'] * 100:.1f}%); _int_mm "
                  f"{row['int_mm_ms']:.4f} ms, w8a8_matmul "
                  f"{row['w8a8_matmul_ms']:.4f} ms; {check}", flush=True)
        result["shapes"].append(row)
        del x, wq, ws, x8, qw
    if ablate:
        result["ablate"] = {}
        for L, K, N, tag in SHAPES[:2]:
            x, wq, ws, _ = mb.operands(L, K, N, "cuda", seed=11)
            for base in ("other", "this"):
                names = [v for v in vers if v == base or v.startswith(base + " ")]
                ms = {v: [] for v in names}
                for _ in range(2):
                    for v in names:
                        ms[v].append(_ms(lambda m=vers[v]: m.w8a8_fused_kernel(
                            x, wq, ws, True), ITERS))
                res = {("whole" if v == base else v[len(base) + 1:]): min(t)
                       for v, t in ms.items()}
                result["ablate"][f"{base} {tag}"] = res
                print(f"ablate {base} {tag} s8: " + ", ".join(
                    f"{k} {t:.4f} ms" for k, t in res.items()), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
