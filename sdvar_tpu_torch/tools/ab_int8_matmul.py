"""A/B of two versions of the INT8-weight matmul kernel on one card, in turns.

    mkdir -p build/parent
    git archive <commit> sdvar_tpu_torch/csrc | tar -x -C build/parent
    python3 -m sdvar_tpu_torch.tools.ab_int8_matmul build/parent [--ablate]

Builds ``OTHER_ROOT/sdvar_tpu_torch/csrc/matmul_int8.cu`` (another checkout
of this repository, e.g. a parent commit unpacked as above into a directory
under ``build/``) beside this checkout's, and times both versions'
``sdvar_int8_matmul`` at every shape of VAR-d30's 256px decodes: the ``w8``
decode at B=16 (M = 32 pn^2 over the ten scales; the block GEMMs qkv (K=1920,
N=5760), proj (1920, 1920), fc1 (1920, 7680) and fc2 (7680, 1920) in bf16,
and the f32 head (1920, 4096)), the W8A8 head at B=32 (M = 64 pn^2) and the
1x2 mesh rank's head (N = 2048). Each shape runs in the order other, this,
this, other, three times over; each time is the mean device time of 20
launches queued behind a spin kernel (not at the host's pace). It prints
each shape's best of each version and the speedup (other / this), this
version's error against ``int8_matmul_plain`` (as a share of the limit
``chip_smoke.py`` holds it to), then the int8-matmul time of one whole
``w8`` decode for each version: each shape weighted by its launches (30
per block GEMM and scale, one head per scale). This version launches with
``matmul_plan``'s tile; at the largest shapes it is also timed at every
tile, ring depth and split of K the kernel takes. ``--ablate`` also builds copies of
this version with one part of the K loop taken out (the int8 -> bf16
conversion, the tensor-core products, the ring's refills) and times them at
the swept shapes: an ablated kernel computes a
wrong result, and its time only says what the part it lacks costs. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.matmul_int8 import (
    TILES,
    _DTYPES,
    int8_matmul_plain,
    matmul_plan,
)
from sdvar_tpu_torch.tools.ab_attention import _ms

PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)  # the decode's ten scales
DEPTH = 30  # VAR-d30's blocks: one launch of each block GEMM per scale
C, V = 1920, 4096
BLOCK_GEMMS = (("qkv", C, 3 * C), ("proj", C, C), ("fc1", C, 4 * C),
               ("fc2", 4 * C, C))
BF16, F32 = torch.bfloat16, torch.float32
ITERS = 20


def shapes():
    """(tag, M, K, N, x dtype, launches per w8 decode)."""
    out = []
    for i, pn in enumerate(PNS):
        M = 2 * 16 * pn * pn
        out += [(f"w8 s{i} {name}", M, K, N, BF16, DEPTH)
                for name, K, N in BLOCK_GEMMS]
        out.append((f"w8 s{i} head", M, C, V, F32, 1))
    out += [(f"w8a8 B=32 s{i} head", 4 * 16 * pn * pn, C, V, F32, 0)
            for i, pn in enumerate(PNS)]
    out += [(f"1x2 rank s{i} head", 2 * 16 * pn * pn, C, V // 2, F32, 0)
            for i, pn in enumerate(PNS)]
    return out


# name -> (text, replacement, occurrences) edits that take one part out
ABLATIONS = {
    "no conversion": [("        convert(it + 1);", "", 2)],
    "no products": [("wgmma_ss<BN>(", "if (false) wgmma_ss<BN>(", 1),
                    ("wgmma_rs<BN>(", "if (false) wgmma_rs<BN>(", 3)],
    # without refills only the first stages - 1 tiles ever land: waiting
    # for a later one would never end
    "no refills": [("      if (tid == 0 && it + stages - 1 < nk) issue(it + stages - 1);",
                    "      if (false) issue(it + stages - 1);", 2),
                   ("        arrived(it + 1);",
                    "        if (it + 1 < stages - 1) arrived(it + 1);", 2)],
}


def _nvcc(src: Path, so: Path):
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS,
                             f"-I{_build.CSRC}", "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _load(proc, so: Path, tag: str) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[{tag}] {line.strip()}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.sdvar_int8_matmul
    fn.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_longlong, P]
    if hasattr(lib, "sdvar_int8_matmul_smem_bytes"):  # takes the tile
        fn.argtypes += [I] * 4
    fn.restype = ctypes.c_int
    return lib


def _ablated_sources():
    """{name: path} of this version's source with one part taken out."""
    text = (_build.CSRC / "matmul_int8.cu").read_text()
    out = {}
    for name, edits in ABLATIONS.items():
        src = text
        for old, new, count in edits:
            if src.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} is not in matmul_int8.cu "
                                   f"{count} time(s)")
            src = src.replace(old, new)
        path = _build.BUILD_ROOT.parent / "ab_int8" / name.replace(" ", "_") / "matmul_int8.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        out[name] = path
    return out


def _launcher(fn, x, q, s, tile=None):
    """A launch of ``fn`` (either version's entry point) on these operands;
    ``tile``: (warpgroups, block_n, stages, splits) for a version that
    takes it."""
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], M, N, K, x.stride(0),
            torch.cuda.current_stream().cuda_stream, *(tile or ()))

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")
        return out
    return launch


def _operands(M, K, N, dtype, g):
    x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    q = torch.randint(-127, 128, (K, N), device="cuda", generator=g,
                      dtype=torch.int8)
    s = torch.rand(N, device="cuda", generator=g) * 1e-2 + 1e-3
    return x, q, s


def _tile(plan):
    return plan["warpgroups"], plan["block_n"], plan["stages"], plan["splits"]


def main(argv) -> int:
    ablate = "--ablate" in argv
    roots = [a for a in argv if a != "--ablate"]
    if len(roots) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build = _build.BUILD_ROOT.parent / "ab_int8"
    jobs = {"other": (_nvcc(Path(roots[0]) / "sdvar_tpu_torch" / "csrc" / "matmul_int8.cu",
                            build / "other" / "libmatmul_int8.so"),
                      build / "other" / "libmatmul_int8.so")}
    if ablate:
        for name, src in _ablated_sources().items():
            so = src.parent / "libmatmul_int8.so"
            jobs[name] = (_nvcc(src, so), so)
    _build.build(["matmul_int8"])
    libs = {name: _load(proc, so, name) for name, (proc, so) in jobs.items()}
    this = _build.load("matmul_int8").sdvar_int8_matmul
    this.argtypes = libs["other"].sdvar_int8_matmul.argtypes[:10] + [ctypes.c_int] * 4
    this.restype = ctypes.c_int
    for line in _build.build_log("matmul_int8").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[this] {line.strip()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other = libs["other"].sdvar_int8_matmul
    other_tile = len(other.argtypes) == 13
    g = torch.Generator(device="cuda").manual_seed(0)
    total = {"other": 0.0, "this": 0.0}
    for tag, M, K, N, dtype, per_decode in shapes():
        x, q, s = _operands(M, K, N, dtype, g)
        plan = matmul_plan(M, N, K, dtype)
        runs = {"other": _launcher(other, x, q, s,
                                   _tile(plan) if other_tile else None),
                "this": _launcher(this, x, q, s, _tile(plan))}
        want = int8_matmul_plain(x.float(), q, s)
        got = runs["this"]().float()
        lim = (1e-5 if dtype == F32 else 2 ** -7) * want.abs().max().item()
        share = (got - want).abs().max().item() / lim
        ms = {"other": [], "this": []}
        for _ in range(3):
            for name in ("other", "this", "this", "other"):
                ms[name].append(_ms(runs[name], ITERS))
        best = {k: min(v) for k, v in ms.items()}
        for k in total:
            total[k] += best[k] * per_decode
        print(f"{tag} M={M} K={K} N={N} {str(dtype)[6:]} (tile "
              f"{plan['block_m']}x{plan['block_n']}, {plan['stages']} "
              f"stages, {plan['splits']} split(s) of K): other {best['other']:.4f} ms, this "
              f"{best['this']:.4f} ms; speedup "
              f"{best['other'] / best['this']:.3f}x; error {share:.3f} of "
              f"the limit", flush=True)
        del x, q, s, want, got, runs
    print(f"int8 matmul per w8 decode (10 scales: 30 x 4 block GEMMs and the "
          f"head each, device time, best of each): other {total['other']:.3f} "
          f"ms, this {total['this']:.3f} ms; speedup "
          f"{total['other'] / total['this']:.3f}x", flush=True)

    sweep = (("fc1 s9", 8192, C, 4 * C, BF16), ("fc2 s9", 8192, 4 * C, C, BF16),
             ("head s9", 8192, C, V, F32), ("proj s4", 800, C, C, BF16),
             ("qkv s2", 288, C, 3 * C, BF16), ("fc2 s0", 32, 4 * C, C, BF16),
             ("head s0", 32, C, V, F32))
    for tag, M, K, N, dtype in sweep:
        x, q, s = _operands(M, K, N, dtype, g)
        row = []
        for wg, bn in TILES[dtype]:
            for st in (3, 4):
                for sp in (1, 2, 4, 8):
                    try:
                        matmul_plan(M, N, K, dtype, warpgroups=wg, block_n=bn,
                                    stages=st, splits=sp)
                    except ValueError:
                        continue
                    t = min(_ms(_launcher(this, x, q, s, (wg, bn, st, sp)),
                                ITERS) for _ in range(2))
                    row.append(f"{64 * wg}x{bn} s{st}/{sp} {t:.4f}")
        wd = q.to(dtype)  # for the library call, untimed
        lib = min(_ms(lambda: torch.matmul(x, wd), ITERS) for _ in range(2))
        print(f"sweep {tag} M={M} K={K} N={N} {str(dtype)[6:]} (rows x "
              f"columns, stages / splits of K: ms): {', '.join(row)}; torch.matmul on the "
              f"{str(dtype)[6:]} weight {lib:.4f}", flush=True)
        if ablate:
            tile = _tile(matmul_plan(M, N, K, dtype))
            runs = {"whole": _launcher(this, x, q, s, tile)}
            for name in ABLATIONS:
                fn = libs[name].sdvar_int8_matmul
                fn.argtypes = this.argtypes
                runs[name] = _launcher(fn, x, q, s, tile)
            ms = {name: [] for name in runs}
            for _ in range(2):
                for name, launch in runs.items():
                    ms[name].append(_ms(launch, ITERS))
            print(f"ablate {tag}: " + ", ".join(
                f"{name} {min(t):.4f} ms" for name, t in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
