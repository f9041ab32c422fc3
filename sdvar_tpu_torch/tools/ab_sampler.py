"""A/B of two versions of the fused sampler (kernel row 3) on one card, in
turns.

    mkdir -p build/parent
    git archive <commit> sdvar_tpu_torch | tar -x -C build/parent
    python3 -m sdvar_tpu_torch.tools.ab_sampler build/parent [--ablate]

Loads ``OTHER_ROOT/sdvar_tpu_torch/ops/kernels/sampling.py`` (another
checkout of this repository, e.g. a parent commit unpacked as above into a
directory under ``build/``) by its path beside this checkout's module. A
version whose kernel is CUDA C++ (``csrc/sampler.cu`` beside it) is built
from its own source with nvcc and its wrapper is handed that library; a
Triton version builds itself. Both are called through ``sample_kernel``,
so each pays its own host path.

Shapes: the ten scales of a VAR-d30 256px decode at B=8 requests, CFG
doubled (M = 16 pn^2 rows, V = 4096, top_k = 900, top_p = 0.96, one row
seed a row), one launch a scale. Each scale runs in the order other, this,
this, other, three times over; each time is the mean device time of a run
of launches queued behind a spin kernel (not at the host's pace). It
prints each scale's best of each version, the speedup (other / this), the
bound (``chip_smoke.py:sampler_bound``) and this version's agreement with
``sample_plain`` (ids on the row-hash path; masks and ids with explicit
noise, bit-equal with top_p = 0), the sampler's device time of one decode
(the ten scales summed) and the host-paced time per call at scale 0 (the
host's clock over 500 calls: what the small scales pay). The last line is
one JSON object with every number and the card's name and power limit.

``--ablate`` also times copies of each version with one part taken out
(the top-k threshold, the nucleus threshold, the row hash and Gumbel
noise) at scale 9: an ablated kernel computes a wrong result, and its
time only says what the part it lacks costs. Needs a CUDA card (and nvcc
for a CUDA version).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.tools.ab_act_quant import (
    _Libs,
    edited,
    host_ms,
    load_module,
    nvcc_finish,
    nvcc_start,
)
from sdvar_tpu_torch.tools.ab_attention import _ms

PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)  # the decode's ten scales
V, TOP_K, TOP_P = 4096, 900, 0.96
HBM_BPS = 3.35e12  # H100 SXM data sheet
INT32_OPS = 64 * 132 * 1.98e9  # 64 int32 lanes an SM a clock, 132 SMs, boost
MODULE = Path("sdvar_tpu_torch") / "ops" / "kernels" / "sampling.py"
SOURCE = Path("sdvar_tpu_torch") / "csrc" / "sampler.cu"

# route -> {name: [(text, replacement, occurrences)]}: edits that take one
# part of the kernel out
ABLATIONS = {
    "triton": {
        "no top-k": [("            for _ in range(32):\n"
                      "                mid = (lo & hi) + ((lo ^ hi) >> 1)\n"
                      "                cnt = tl.sum(((u >= mid) & valid).to(tl.int32), axis=0)\n"
                      "                ge = cnt >= top_k\n"
                      "                lo = tl.where(ge, mid, lo)\n"
                      "                hi = tl.where(ge, hi, mid)\n",
                      "            lo = lo + top_k\n", 1)],
        "no nucleus": [("            for _ in range(32):\n"
                        "                mid = (lo & hi) + ((lo ^ hi) >> 1)\n"
                        "                mass = tl.sum(tl.where(u > mid, e, 0.0), axis=0)\n"
                        "                ge = mass >= pZ\n"
                        "                lo = tl.where(ge, mid, lo)\n"
                        "                hi = tl.where(ge, hi, mid)\n",
                        "            lo = lo + (pZ > 0).to(tl.int32)\n", 1)],
        "no noise": [("            seed = tl.load(seed_ptr + row).to(tl.uint32, bitcast=True)\n"
                      "            h = seed + cols.to(tl.uint32) * 0x9E3779B9\n"
                      "            h = h ^ (h >> 16)\n"
                      "            h = h * 0x85EBCA6B\n"
                      "            h = h ^ (h >> 13)\n"
                      "            h = h * 0xC2B2AE35\n"
                      "            h = h ^ (h >> 16)\n"
                      "            b24 = ((h >> 8) & 0xFFFFFF).to(tl.float32)\n"
                      "            u01 = b24 * 5.9604644775390625e-08 + 2.9802322387695312e-08\n"
                      "            g = -libdevice.log(-libdevice.log(u01))\n",
                      "            g = cols.to(tl.float32) * 1e-9\n", 1)],
    },
    "cuda": {
        "no top-k": [("    kth = select_key<int, false>(L.row, V, one, top_k, 0.f, kmin, kmax, L, sh);",
                      "    kth = kmin + (uint32_t)top_k;", 1)],
        "no nucleus": [("    kappa = select_key<u64, true>(kept, n, mass, 0ull, top_p, max(kth, kmin), kmax,\n"
                        "                                  L, sh);",
                        "    kappa = (uint32_t)mass(kept[0]) + kth + n;", 1)],
        "no noise": [("        const float g = noise_at(noise, seed, row, col, V);",
                      "        const float g = col * 1e-9f;", 1)],
    },
}


def route(mod) -> str:
    return "triton" if hasattr(mod, "_triton_kernel") else "cuda"


def _versions(root: Path, ablate: bool):
    """{tag: module}: other, this and, with ``ablate``, the ablated copies
    of each; CUDA sources built together."""
    build = _build.BUILD_ROOT.parent / "ab_sampler"
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
                    (d / "sampler.cu").write_text(
                        edited(src.read_text(), edits, str(src)))
                    variants[f"{tag} {name}"] = (d / "sampler.cu", py)
                else:
                    (d / "sampling.py").write_text(
                        edited(py.read_text(), edits, str(py)))
                    variants[f"{tag} {name}"] = (src, d / "sampling.py")
        for vt, (s, p) in variants.items():
            if s.exists():
                so = build / vt.replace(" ", "_") / "libsampler.so"
                jobs[vt] = (nvcc_start(s, so), so, p)
            else:
                mods[vt] = p
    for vt, (proc, so, p) in jobs.items():
        nvcc_finish(proc, vt, "sample")
        mods[vt] = (p, ctypes.CDLL(str(so)))
    out = {}
    for vt, spec in mods.items():
        name = "ab_sampler_" + vt.replace(" ", "_").replace("-", "_")
        if isinstance(spec, tuple):
            mod = load_module(spec[0], name)
            mod._build = _Libs({"sampler": spec[1]})
            out[vt] = mod
        else:
            out[vt] = load_module(spec, name)
    return out


def bound_ms(M, n_topk):
    """``chip_smoke.py:sampler_bound``: logits and seeds read once, ids
    written once, against 4 int32 operations a logit and 25 a logit that
    top-k keeps."""
    t_bytes = (M * V * 4 + M * 8) / HBM_BPS * 1e3
    t_ops = (M * V * 4 + n_topk * 25) / INT32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def agreement(mod, plain, logits, seeds, noise) -> dict:
    """Shares of rows on which this version equals ``sample_plain``."""
    out = {}
    for k, p in ((TOP_K, TOP_P), (TOP_K, 0.0)):
        ids, mask = mod.sample_kernel(logits, None, k, p, noise=noise,
                                      return_mask=True)
        ids_p, mask_p = plain(logits, None, k, p, noise=noise, return_mask=True)
        rows = ((mask == mask_p).all(-1) & (ids == ids_p)).float().mean().item()
        hashed = (mod.sample_kernel(logits, seeds, k, p)
                  == plain(logits, seeds, k, p)).float().mean().item()
        out[f"{k}/{p}"] = {"rows_equal_noise": rows, "ids_equal_hash": hashed}
    return out


def main(argv) -> int:
    ablate = "--ablate" in argv
    roots = [a for a in argv if a != "--ablate"]
    if len(roots) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from sdvar_tpu_torch.ops.kernels.sampling import sample_plain

    vers = _versions(Path(roots[0]), ablate)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    print(f"other: {route(vers['other'])}, this: {route(vers['this'])}",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    Mmax = 16 * PNS[-1] ** 2
    logits = torch.randn(Mmax, V, device="cuda", generator=g) * 4
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (Mmax,), device="cuda",
                          generator=g, dtype=torch.int32)
    noise = -torch.log(-torch.log(torch.rand(
        Mmax, V, device="cuda", generator=g).clamp_(1e-7, 1 - 1e-7)))
    result = {"card": card, "routes": {v: route(vers[v]) for v in ("other", "this")},
              "scales": [], "agreement": agreement(vers["this"], sample_plain,
                                                   logits, seeds, noise)}
    print(f"this against sample_plain at M={Mmax}: {result['agreement']}",
          flush=True)
    total = {"other": 0.0, "this": 0.0}
    for si, pn in enumerate(PNS):
        M = 16 * pn * pn
        lg, sd = logits[:M], seeds[:M]
        runs = {v: (lambda m=vers[v]: m.sample_kernel(lg, sd, TOP_K, TOP_P))
                for v in ("other", "this")}
        ms = {"other": [], "this": []}
        for _ in range(3):
            for v in ("other", "this", "this", "other"):
                ms[v].append(_ms(runs[v], 50 if M < 4096 else 20))
        best = {v: min(t) for v, t in ms.items()}
        for v in best:
            total[v] += best[v]
        n_topk = int(sample_plain(lg, sd, TOP_K, 0.0, return_mask=True)[1].sum())
        bnd, by = bound_ms(M, n_topk)
        result["scales"].append({"scale": si, "M": M, "other_ms": best["other"],
                                 "this_ms": best["this"], "bound_ms": bnd,
                                 "bound_by": by})
        print(f"scale {si} M={M}: other {best['other']:.4f} ms, this "
              f"{best['this']:.4f} ms; speedup {best['other'] / best['this']:.3f}x; "
              f"bound {bnd:.4f} ms ({by}; this at {bnd / best['this'] * 100:.1f}%)",
              flush=True)
    result["decode_ms"] = total
    print(f"sampler per decode (10 scales, device time, best of each): other "
          f"{total['other']:.4f} ms, this {total['this']:.4f} ms; speedup "
          f"{total['other'] / total['this']:.3f}x", flush=True)
    lg, sd = logits[:16], seeds[:16]
    hp = {"other": [], "this": []}
    for _ in range(2):
        for v in ("other", "this", "this", "other"):
            hp[v].append(host_ms(lambda m=vers[v]: m.sample_kernel(
                lg, sd, TOP_K, TOP_P)))
    result["host_paced_s0_ms"] = {v: min(t) for v, t in hp.items()}
    print(f"host-paced sample_kernel at scale 0 (M=16): other "
          f"{min(hp['other']):.4f} ms, this {min(hp['this']):.4f} ms per call",
          flush=True)
    if ablate:
        result["ablate"] = {}
        for base in ("other", "this"):
            names = [v for v in vers if v == base or v.startswith(base + " ")]
            ms = {v: [] for v in names}
            for _ in range(2):
                for v in names:
                    ms[v].append(_ms(lambda m=vers[v]: m.sample_kernel(
                        logits, seeds, TOP_K, TOP_P), 20))
            result["ablate"][base] = {
                ("whole" if v == base else v[len(base) + 1:]): min(t)
                for v, t in ms.items()}
            print(f"ablate {base} ({route(vers[base])}) M={Mmax}: " + ", ".join(
                f"{k} {t:.4f} ms" for k, t in result["ablate"][base].items()),
                flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
