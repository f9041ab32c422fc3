"""A/B of two versions of the INT8 3x3 convolution kernel (kernel row 6) on
one card, in turns.

    mkdir -p build/parent
    git archive <commit> sdvar_tpu_torch | tar -x -C build/parent
    python3 -m sdvar_tpu_torch.tools.ab_conv_s8 build/parent [--ablate]

Builds ``OTHER_ROOT/sdvar_tpu_torch/csrc/conv_s8.cu`` (another checkout of
this repository, e.g. a parent commit unpacked as above into a directory
under ``build/``) beside this checkout's, and calls each through its own
wrapper (``ops/kernels/conv_s8.py`` of that checkout, loaded by its path
and handed its library), so each version picks its own path and tile.

Shapes (B=16, 256px, the default VQVAE's decoder): the all-int8 server's
pixel decode (``calibrate_decoder_w8a8(min_w=256)``: eight sites at 256^2,
seven 160 -> 160 convs (six resblock convs and the upsample conv) and
``conv_out``, 160 -> 3), and the other sites of the dynamic W8A8 decoder
(``conv2d_nhwc_w8a8``, 29 sites: 640 and 320 channels at 32^2, 320 at
64^2 and 128^2, 160 at 128^2). Each shape runs in the order other, this,
this, other, three times over; each time is the mean device time of a run
of launches queued behind a spin kernel. It prints each shape's best of
each version, the speedup (other / this), the bound (the larger of the
bytes over 3.35 TB/s and the int8 operations over 1979 TOP/s) and this
version's share of it, whether this version is bit-equal to
``conv3x3_s8_plain``, and the channels-last bf16 cuDNN convolution of the
same shape (``F.conv2d``, the conv a site replaces) timed in the same turns;
then the conv time of one all-int8 pixel decode (8 launches) and of one
dynamic W8A8 pixel decode (29) for each version.

``--ablate`` also times copies of each version with one part of its wide
path's loop taken out (the tensor-core products, the refills of the
operand tiles, the epilogue's stores) at the top level (16, 256, 256, 160
-> 160): an ablated kernel computes a wrong result, and its time only says
what the part it lacks costs. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.conv_s8 import conv3x3_s8_plain
from sdvar_tpu_torch.tools.ab_act_quant import (
    edited,
    load_module,
    nvcc_finish,
    nvcc_start,
)
from sdvar_tpu_torch.tools.ab_attention import _ms

HBM_BPS = 3.35e12  # H100 SXM data sheet: memory rate
INT8_OPS = 1979e12  # and dense int8 tensor-core rate
MODULE = Path("sdvar_tpu_torch") / "ops" / "kernels" / "conv_s8.py"
SOURCE = Path("sdvar_tpu_torch") / "csrc" / "conv_s8.cu"
B = 16
# (H=W, C, O, launches per all-int8 pixel decode, per dynamic W8A8 decode)
SHAPES = ((256, 160, 160, 7, 7), (256, 160, 3, 1, 1),
          (32, 640, 640, 0, 1), (32, 640, 320, 0, 1), (32, 320, 320, 0, 5),
          (64, 320, 320, 0, 7), (128, 320, 320, 0, 1), (128, 320, 160, 0, 1),
          (128, 160, 160, 0, 5))
TOP = (B, 256, 256, 160, 160)

# route -> {name: [(text, replacement, occurrences)]}: edits that take one
# part of the wide path's loop out. "mma": the mma.sync kernel alone (the
# wide path before the TMA kernel); "tma": the TMA + wgmma kernel.
ABLATIONS = {
    "mma": {
        "no products": [("      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);",
                         "      for (int j = 0; j < NT; ++j) if (ks < 0) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);", 1)],
        "no refills": [("    if (ks + 1 < ksteps) stage(buf ^ 1, ks + 1);",
                        "    if (ks < 0) stage(buf ^ 1, ks + 1);", 1)],
        # nothing is stored unless a sum hits a value it never takes, so
        # the products stay live
        "no epilogue": [("        if (m >= M) continue;",
                         "        if (m >= M || acc[i][j][0] != 0x7ffffff0) continue;", 1)],
    },
    "tma": {
        "no products": [("      wgmma_s8_n160(acc[i], gmma_desc(",
                         "      if (kk < 0) wgmma_s8_n160(acc[i], gmma_desc(", 1)],
        # the pipeline's barriers as they are, the copies gone: each stage
        # is signalled full with no bytes to wait for
        "no refills": [("          mbar_expect_tx(&full[s], SB);",
                        "          mbar_expect_tx(&full[s], 0);", 1),
                       ("          mbar_expect_tx(&full[s], (TILE_M + TILE_N) * KT);",
                        "          mbar_expect_tx(&full[s], 0);", 1),
                       ("          tma_load_4d(ring + s * SB, &tx, ", "          if (s < 0) tma_load_4d(ring + s * SB, &tx, ", 1),
                       ("          tma_load_2d(ring + s * SB + XB, &tw, ", "          if (s < 0) tma_load_2d(ring + s * SB + XB, &tw, ", 1),
                       ("          tma_load_4d(ring + s * SB, &txt, ", "          if (s < 0) tma_load_4d(ring + s * SB, &txt, ", 1),
                       ("          tma_load_2d(ring + s * SB + XB, &twt, ", "          if (s < 0) tma_load_2d(ring + s * SB + XB, &twt, ", 1)],
        "no epilogue": [("          if (!ok) continue;",
                         "          if (!ok || acc[i][0][0] != 0x7ffffff0) continue;", 1)],
    },
}


def _route(src: Path) -> str:
    return "tma" if "conv3x3_s8_tma_kernel" in src.read_text() else "mma"


def _versions(root: Path, ablate: bool):
    """{tag: wrapper module}: other, this and, with ``ablate``, the
    ablated copies of each, their sources built together."""
    build = _build.BUILD_ROOT.parent / "ab_conv_s8"
    jobs = {}
    for tag, base in (("other", root), ("this", _build.CSRC.parents[1])):
        src = base / SOURCE
        jobs[tag] = (src, base / MODULE)
        if ablate:
            for name, edits in ABLATIONS[_route(src)].items():
                d = build / f"{tag}_{name.replace(' ', '_')}"
                d.mkdir(parents=True, exist_ok=True)
                (d / "conv_s8.cu").write_text(edited(src.read_text(), edits, str(src)))
                jobs[f"{tag} {name}"] = (d / "conv_s8.cu", base / MODULE)
    procs = {}
    for vt, (src, py) in jobs.items():
        so = build / vt.replace(" ", "_") / "libconv_s8.so"
        procs[vt] = (nvcc_start(src, so), so, py)
    out = {}
    for vt, (proc, so, py) in procs.items():
        nvcc_finish(proc, vt, "conv3x3_s8")
        out[vt] = load_module(py, "ab_conv_s8_" + vt.replace(" ", "_"),
                              {"conv_s8": ctypes.CDLL(str(so))})
    return out


def bound_ms(Bc, H, W, C, O, out_itemsize=2):
    nbytes = Bc * H * W * (C + O * out_itemsize) + 9 * C * O + 8 * O
    return max(nbytes / HBM_BPS, 2 * Bc * H * W * 9 * C * O / INT8_OPS) * 1e3


def operands(shape, g):
    Bc, H, W, C, O = shape
    x8 = torch.randint(-127, 128, (Bc, H, W, C), device="cuda", generator=g,
                       dtype=torch.int8)
    wk = torch.randint(-127, 128, (O, 3, 3, C), device="cuda", generator=g,
                       dtype=torch.int8)
    scale = torch.rand(O, device="cuda", generator=g) * 2e-3
    bias = torch.randn(O, device="cuda", generator=g)
    return x8, wk, scale, bias


def main(argv) -> int:
    ablate = "--ablate" in argv
    roots = [a for a in argv if a != "--ablate"]
    if len(roots) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    vers = _versions(Path(roots[0]), ablate)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.benchmark = False
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = {"int8 server": {"other": 0.0, "this": 0.0, "cudnn": 0.0},
              "dynamic": {"other": 0.0, "this": 0.0, "cudnn": 0.0}}
    for HW, C, O, per_server, per_dynamic in SHAPES:
        shape = (B, HW, HW, C, O)
        x8, wk, scale, bias = operands(shape, g)
        xb = x8.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wb = wk.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        runs = {v: (lambda m=vers[v]: m.conv3x3_s8_kernel(x8, wk, scale, bias))
                for v in ("other", "this")}
        runs["cudnn"] = lambda: F.conv2d(xb, wb, bb, padding=1)
        same = torch.equal(runs["this"](), conv3x3_s8_plain(x8, wk, scale, bias))
        plan = getattr(vers["this"], "conv_plan", None)
        path = plan(*shape)["path"] if plan else "mma"
        ms = {v: [] for v in runs}
        for _ in range(3):
            for v in ("other", "this", "cudnn", "cudnn", "this", "other"):
                ms[v].append(_ms(runs[v], 10))
        best = {v: min(t) for v, t in ms.items()}
        for key, n in (("int8 server", per_server), ("dynamic", per_dynamic)):
            for v in best:
                totals[key][v] += best[v] * n
        bd = bound_ms(*shape)
        print(f"(B,H,W,C,O)={shape} ({path} path): other {best['other']:.4f} ms,"
              f" this {best['this']:.4f} ms; speedup "
              f"{best['other'] / best['this']:.3f}x; bound {bd:.4f} ms (this at "
              f"{bd / best['this'] * 100:.1f}%); bf16 cuDNN conv "
              f"{best['cudnn']:.4f} ms; this bit-equal to the plain version "
              f"{same}", flush=True)
        del x8, wk, xb, wb, runs
        torch.cuda.empty_cache()
    for key, what in (("int8 server", "one all-int8 pixel decode (8 launches)"),
                      ("dynamic", "one dynamic W8A8 pixel decode (29 launches)")):
        t = totals[key]
        print(f"conv time of {what}, device time, best of each: other "
              f"{t['other']:.3f} ms, this {t['this']:.3f} ms (speedup "
              f"{t['other'] / t['this']:.3f}x); the bf16 cuDNN convs of the "
              f"same shapes {t['cudnn']:.3f} ms", flush=True)
    if ablate:
        x8, wk, scale, bias = operands(TOP, g)
        for base in ("other", "this"):
            names = [v for v in vers if v == base or v.startswith(base + " ")]
            ms = {v: [] for v in names}
            for _ in range(2):
                for v in names:
                    ms[v].append(_ms(lambda m=vers[v]: m.conv3x3_s8_kernel(
                        x8, wk, scale, bias), 10))
            print(f"ablate {base} (B,H,W,C,O)={TOP}: " + ", ".join(
                f"{'whole' if v == base else v[len(base) + 1:]} {min(t):.4f} ms"
                for v, t in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
