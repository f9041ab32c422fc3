"""A/B of two versions of the activation-quantization kernel (kernel row 4)
on one card, in turns.

    mkdir -p build/parent
    git archive <commit> sdvar_tpu_torch | tar -x -C build/parent
    python3 -m sdvar_tpu_torch.tools.ab_act_quant build/parent [--ablate]

Loads ``OTHER_ROOT/sdvar_tpu_torch/ops/kernels/quantize.py`` (another
checkout of this repository, e.g. a parent commit unpacked as above into a
directory under ``build/``) by its path beside this checkout's module. A
version whose kernel is CUDA C++ (``csrc/act_quant.cu`` beside it) is
built from its own source with nvcc and its wrapper is handed that
library; a Triton version builds itself. Both are called through their
wrappers (``act_quantize_kernel``, ``act_scale_kernel``), so each pays its
own host path.

Shapes: every one the VAR-d30 256px decodes launch at B=16 (M = 32 pn^2
rows over the ten scales): per layer the qkv, proj and fc1 inputs (K=1920,
no bias, no GELU) and the fc2 input (K=7680, bf16 bias + tanh-GELU), 1200
launches per W8A8 + INT8-KV decode; and the 1x2 mesh rank's split rows,
the proj input (K=960) and the fc2 input (K=3840, bias + GELU), each as a
scale-only pass and a given-scale pass (with the rank's K=1920 qkv and fc1
inputs, 1800 launches a rank). Each shape runs in the order other, this,
this, other, three times over; each time is the mean device time of a run
of launches queued behind a spin kernel (not at the host's pace). It
prints each shape's best of each version, the speedup (other / this) and
this version's agreement with ``act_quantize_plain`` (bits without GELU;
with GELU |dq| <= 1 on fewer than 1e-3 of the elements and scales within
1e-6 relative), then each version's act-quant time of one W8A8 decode and
of one 1x2 rank's decode (each shape weighted by its launches), and the
host-paced time per call at scale 0 (M=32: the host's clock over 500
calls, which is what a decode's small scales pay).

``--ablate`` also times copies of each version with one part taken out
(the x loads, the row's amax reduction, the per-element arithmetic, the
int8 stores) at scale 9 (M=8192, K=7680 with GELU and K=1920 without): an
ablated kernel computes a wrong result, and its time only says what the
part it lacks costs. Needs a CUDA card (and nvcc for a CUDA version).
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize_plain, act_scale_plain
from sdvar_tpu_torch.tools.ab_attention import _ms

PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)  # the decode's ten scales
DEPTH = 30  # VAR-d30's blocks
C = 1920
HBM_BPS = 3.35e12  # the H100 SXM's memory rate (data sheet)
MODULE = Path("sdvar_tpu_torch") / "ops" / "kernels" / "quantize.py"
SOURCE = Path("sdvar_tpu_torch") / "csrc" / "act_quant.cu"

# route -> {name: [(text, replacement, occurrences)]}: edits that take one
# part of the kernel out
ABLATIONS = {
    "triton": {
        "no loads": [("        h = tl.load(x_ptr + row * x_stride + cols, mask=valid,\n"
                      "                    other=0.0).to(tl.float32)",
                      "        h = (cols + row).to(tl.float32)", 1)],
        "no reduction": [("            amax = tl.max(tl.where(valid, tl.abs(h), 0.0), axis=0)",
                          "            amax = tl.full((), 127.0, tl.float32)", 1)],
        "no arithmetic": [("            z = 0.7978845608028654 * (h + 0.044715 * h * h * h)\n"
                           "            h = 0.5 * h * (1.0 + libdevice.tanh(z))",
                           "            h = h * 1.5", 1),
                          ("            q = libdevice.rint(tl.div_rn(h, s))",
                           "            q = h * s", 1)],
        "no stores": [("            tl.store(q_ptr + row * K + cols, q.to(tl.int8), mask=valid)",
                       "            pass", 1)],
    },
    "cuda": {
        "no loads": [("    fetch_row<XT, VW, NV, LAST>(x + (ll)min(next, M - 1) * xs, lane, G,\n"
                      "                                next < M ? nvec_row : 0, raw);",
                      "#pragma unroll\n    for (int v = 0; v < NV; ++v)\n"
                      "      raw[v] = make_uint4(next, v, lane, 0x3f803f80u);", 1)],
        "no reduction": [("      const float amax = group_max(own, lane, G, red[it & 1]);",
                          "      const float amax = own;", 1)],
        "no arithmetic": [("    to_h<GELU>(h, own);",
                           "#pragma unroll\n    for (int v = 0; v < NV; ++v)\n#pragma unroll\n"
                           "      for (int e = 0; e < VW; ++e) own = fmaxf(own, fabsf(h[v][e]));", 1),
                          ("          const bool near = quantize_vec<VW>(h[v], r, w);",
                           "          const bool near = false;\n#pragma unroll\n"
                           "          for (int j = 0; j < (VW + 3) / 4; ++j) w[j] = __float_as_uint(h[v][j]);", 1)],
        "no stores": [("            store_q<VW>(qr + (ll)i * VW, w);",
                       "            if (false) store_q<VW>(qr + (ll)i * VW, w);", 1)],
    },
}


class _Libs:
    """Stands in for ``_build`` in a module loaded by its path: ``load``
    returns the library built from that version's own source."""

    def __init__(self, libs):
        self._libs = libs

    def load(self, name):
        return self._libs[name]


def nvcc_start(src: Path, so: Path) -> subprocess.Popen:
    """Start nvcc on ``src`` (the package's flags; its own directory and
    this checkout's csrc/ on the include path) into ``so``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS,
                             f"-I{src.parent}", f"-I{_build.CSRC}", "-o",
                             str(so), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def nvcc_finish(proc: subprocess.Popen, tag: str, key: str = "") -> str:
    """Wait for nvcc; raise with its output on failure; print the ptxas
    lines (registers, spills) of the kernels whose names hold ``key``."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and key in line:
            near = lines[i + 1:i + 4]
            used = next((x for x in near if "Used" in x), "")
            spill = next((x for x in near if "spill" in x), "")
            print(f"[{tag}] {line.split(chr(39))[1]}: "
                  f"{used.split(':', 1)[-1].strip()}; {spill.strip()}")
    return log


def load_module(path: Path, name: str, libs=None):
    """The module at ``path`` under ``name``; with ``libs`` ({source name:
    ctypes library}) its ``_build`` is replaced so that it launches those
    libraries."""
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if libs is not None:
        mod._build = _Libs(libs)
    return mod


def route(mod) -> str:
    return "triton" if hasattr(mod, "_triton_kernel") else "cuda"


def edited(text: str, edits, where: str) -> str:
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"{old!r} is not in {where} {count} time(s)")
        text = text.replace(old, new)
    return text


def shapes():
    """(tag, M, K, gelu, mode, launches per W8A8 decode, per 1x2 rank
    decode); mode: quantize, scale (the scales alone) or given (the values
    under a given scale)."""
    out = []
    for i, pn in enumerate(PNS):
        M = 32 * pn * pn
        out += [(f"s{i} K={C}", M, C, False, "quantize", 3 * DEPTH, 2 * DEPTH),
                (f"s{i} K={4 * C} gelu", M, 4 * C, True, "quantize", DEPTH, 0),
                (f"s{i} 1x2 K={C // 2} scale", M, C // 2, False, "scale", 0, DEPTH),
                (f"s{i} 1x2 K={C // 2} given", M, C // 2, False, "given", 0, DEPTH),
                (f"s{i} 1x2 K={2 * C} gelu scale", M, 2 * C, True, "scale", 0, DEPTH),
                (f"s{i} 1x2 K={2 * C} gelu given", M, 2 * C, True, "given", 0, DEPTH)]
    return out


def operands(M, K, gelu, g):
    x = (torch.randn(M, K, device="cuda", generator=g) * 3).to(torch.bfloat16)
    b = (torch.randn(K, device="cuda", generator=g).to(torch.bfloat16)
         if gelu else None)
    return x, b, act_scale_plain(x, b, gelu)


def caller(mod, mode, x, b, gelu, s):
    if mode == "quantize":
        return lambda: mod.act_quantize_kernel(x, b, gelu)
    if mode == "scale":
        return lambda: mod.act_scale_kernel(x, b, gelu)
    return lambda: mod.act_quantize_kernel(x, b, gelu, scale=s)


def agreement(mod, mode, x, b, gelu, s) -> str:
    """This version against the plain one: bits without GELU, the
    tolerance with it."""
    if mode == "scale":
        got, want = mod.act_scale_kernel(x, b, gelu), act_scale_plain(x, b, gelu)
        rel = ((got - want).abs() / want).max().item()
        ok = torch.equal(got, want) if not gelu else rel <= 1e-6
        return f"scales max rel {rel:.2e} {'ok' if ok else 'FAIL'}"
    given = s if mode == "given" else None
    q, sq = mod.act_quantize_kernel(x, b, gelu, scale=given)
    qp, sp = act_quantize_plain(x, b, gelu, scale=given)
    d = (q.int() - qp.int()).abs()
    frac = (d != 0).float().mean().item()
    rel = ((sq - sp).abs() / sp).max().item()
    if gelu:
        ok = d.max().item() <= 1 and frac < 1e-3 and rel <= 1e-6
    else:
        ok = torch.equal(q, qp) and torch.equal(sq, sp)
    return (f"dq != 0 on {frac:.2e}, max |dq| {d.max().item()}, scales max "
            f"rel {rel:.2e} {'ok' if ok else 'FAIL'}")


def host_ms(launch, n=500) -> float:
    """Host-paced ms per call: the host's clock over ``n`` calls between
    synchronisations (small launches wait for the host, not the card)."""
    for _ in range(20):
        launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _versions(root: Path, ablate: bool):
    """{tag: module}: other, this and, with ``ablate``, the ablated copies
    of each; CUDA sources built together."""
    build = _build.BUILD_ROOT.parent / "ab_act_quant"
    mods, jobs = {}, {}
    for tag, base in (("other", root), ("this", _build.CSRC.parents[1])):
        src, py = base / SOURCE, base / MODULE
        variants = {tag: (src, py)}
        if ablate:
            rt = "cuda" if src.exists() else "triton"
            for name, edits in ABLATIONS[rt].items():
                d = build / f"{tag}_{name.replace(' ', '_')}"
                d.mkdir(parents=True, exist_ok=True)
                if rt == "cuda":
                    (d / "act_quant.cu").write_text(
                        edited(src.read_text(), edits, str(src)))
                    variants[f"{tag} {name}"] = (d / "act_quant.cu", py)
                else:
                    (d / "quantize.py").write_text(
                        edited(py.read_text(), edits, str(py)))
                    variants[f"{tag} {name}"] = (src, d / "quantize.py")
        for vt, (s, p) in variants.items():
            if s.exists():
                so = build / vt.replace(" ", "_") / "libact_quant.so"
                jobs[vt] = (nvcc_start(s, so), so, p)
            else:
                mods[vt] = p
    for vt, (proc, so, p) in jobs.items():
        nvcc_finish(proc, vt, "act_quantize_kernel")
        mods[vt] = (p, ctypes.CDLL(str(so)))
    out = {}
    for vt, spec in mods.items():
        name = "ab_act_quant_" + vt.replace(" ", "_")
        if isinstance(spec, tuple):
            out[vt] = load_module(spec[0], name, {"act_quant": spec[1]})
        else:
            out[vt] = load_module(spec, name)
    return out


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
    print(f"other: {route(vers['other'])}, this: {route(vers['this'])}",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    total = {"w8a8": {"other": 0.0, "this": 0.0},
             "1x2": {"other": 0.0, "this": 0.0}}
    for tag, M, K, gelu, mode, per_w8a8, per_1x2 in shapes():
        x, b, s = operands(M, K, gelu, g)
        runs = {v: caller(vers[v], mode, x, b, gelu, s) for v in ("other", "this")}
        check = agreement(vers["this"], mode, x, b, gelu, s)
        ms = {"other": [], "this": []}
        for _ in range(3):
            for v in ("other", "this", "this", "other"):
                ms[v].append(_ms(runs[v], 50))
        best = {v: min(t) for v, t in ms.items()}
        for v in best:
            total["w8a8"][v] += best[v] * per_w8a8
            total["1x2"][v] += best[v] * per_1x2
        nbytes = M * K * 2 + (K * 2 if gelu else 0) + M * 4
        if mode != "scale":
            nbytes += M * K
        bound = nbytes / HBM_BPS * 1e3
        print(f"{tag} M={M} {mode}: other {best['other']:.4f} ms, this "
              f"{best['this']:.4f} ms; speedup {best['other'] / best['this']:.3f}x;"
              f" bound {bound:.4f} ms (bytes; this at "
              f"{bound / best['this'] * 100:.1f}%); {check}", flush=True)
        del x, b, s, runs
    for key, what in (("w8a8", "one W8A8 + INT8-KV decode (1200 launches)"),
                      ("1x2", "one 1x2 rank's decode (1800 launches)")):
        t = total[key]
        print(f"act-quant per {what}, device time, best of each: other "
              f"{t['other']:.3f} ms, this {t['this']:.3f} ms; speedup "
              f"{t['other'] / t['this']:.3f}x", flush=True)
    for K, gelu in ((C, False), (4 * C, True)):
        x, b, s = operands(32, K, gelu, g)
        hp = {"other": [], "this": []}
        for _ in range(2):
            for v in ("other", "this", "this", "other"):
                hp[v].append(host_ms(caller(vers[v], "quantize", x, b, gelu, s)))
        print(f"host-paced act_quantize_kernel at scale 0 (M=32, K={K}"
              f"{', gelu' if gelu else ''}): other {min(hp['other']):.4f} ms, "
              f"this {min(hp['this']):.4f} ms per call", flush=True)
    if ablate:
        for M, K, gelu in ((8192, 4 * C, True), (8192, C, False)):
            x, b, s = operands(M, K, gelu, g)
            for base in ("other", "this"):
                names = [v for v in vers if v == base or v.startswith(base + " ")]
                ms = {v: [] for v in names}
                for _ in range(2):
                    for v in names:
                        ms[v].append(_ms(caller(vers[v], "quantize", x, b,
                                                gelu, s), 50))
                print(f"ablate {base} ({route(vers[base])}) M={M} K={K}"
                      f"{' gelu' if gelu else ''}: " + ", ".join(
                          f"{'whole' if v == base else v[len(base) + 1:]} "
                          f"{min(t):.4f} ms" for v, t in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
