"""Which part of the attention loop costs what: ablated copies, on one card.

    python3 -m sdvar_tpu_torch.tools.ablate_attention

Writes copies of ``sdvar_tpu_torch/csrc/attention.cu`` under
``build/ablate/`` with one part of the bf16-q loop taken out (the online
softmax, the tensor-core products, the ring's refills), builds them beside
the whole loop (one nvcc each, all started together) and times each at
VAR-d30's scale 9 (2B=32, Lq=256, Lk=680, H=30, hd=64, bf16 q; bf16 and
int8 K/V) with ``attention_plan``'s geometry, in turns, twice. An ablated
kernel computes a wrong result: its time only says what the part it lacks
costs. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.attention import attention_plan
from sdvar_tpu_torch.tools.ab_attention import _caller, _ms

# name -> the edits that take the part out (each text occurs once)
ABLATIONS = {
    "no softmax": [("  for (int hf = 0; hf < 2; ++hf) {\n    const int r = r0 + g + 8 * hf;\n"
                    "    const bool biased",
                    "  for (int hf = 0; hf < 0; ++hf) {\n    const int r = r0 + g + 8 * hf;\n"
                    "    const bool biased")],
    "no products": [("  for (int kk = 0; kk < KS; ++kk)\n    wgmma_n64<0>",
                     "  for (int kk = 0; kk < 0; ++kk)\n    wgmma_n64<0>"),
                    ("  for (int j = 0; j < MK / 16; ++j) {\n    if constexpr (HD == 32) {",
                     "  for (int j = 0; j < 0; ++j) {\n    if constexpr (HD == 32) {")],
    "no refills": [("    if (nt < ntiles)\n      issue_tile",
                    "    if (false)\n      issue_tile")],
}


def _sources():
    """{name: path} of the whole loop and each ablated copy."""
    whole = _build.CSRC / "attention.cu"
    text = whole.read_text()
    out = {"whole": whole}
    for name, edits in ABLATIONS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to ablate is not in "
                                   f"attention.cu once: {old!r}")
            src = src.replace(old, new)
        path = _build.BUILD_ROOT.parent / "ablate" / name.replace(" ", "_") / "attention.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        out[name] = path
    return out


def _build_all(sources):
    """Build every source (one nvcc each, all together); {name: CDLL}."""
    jobs = {}
    for name, src in sources.items():
        so = src.parent / f"lib{name.replace(' ', '_')}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
               str(so), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, strides in ((lib.sdvar_attention, 5, 6),
                                  (lib.sdvar_attention_int8, 7, 8)):
            fn.argtypes = ([P] * ptrs + [I] * 6 + [LL] * strides
                           + [ctypes.c_float, P, I, I])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv) -> int:
    if argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    libs = _build_all(_sources())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    Bq, H, hd, Lq, Lk = 32, 30, 64, 256, 680
    q = torch.randn(Bq, Lq, H, hd, device="cuda", generator=g).to(torch.bfloat16)
    cache = torch.randn(2, Bq, Lk, H * hd, device="cuda", generator=g).to(torch.bfloat16)
    vals = torch.randint(-127, 128, (2, Bq, Lk, H * hd), device="cuda",
                         generator=g, dtype=torch.int8)
    planes = torch.rand(2, Bq, Lk, device="cuda", generator=g) + 0.5
    for int8 in (False, True):
        src = vals if int8 else cache
        k, v = (src[i].view(Bq, Lk, H, hd) for i in range(2))
        scales = (planes[0], planes[1]) if int8 else None
        plan = attention_plan(Bq, Lq, Lk, H, hd, torch.bfloat16,
                              torch.int8 if int8 else torch.bfloat16)
        geometry = (plan["warpgroups"], plan["stages"])
        runs = {name: _caller(lib.sdvar_attention_int8 if int8 else lib.sdvar_attention,
                              q, k, v, scales, geometry)
                for name, lib in libs.items()}
        ms = {name: [] for name in runs}
        for _ in range(2):
            for name, launch in runs.items():
                ms[name].append(_ms(launch))
        print(f"{'int8' if int8 else 'bf16'} scale 9 (grid {plan['grid']}, "
              f"{plan['warpgroups']} warpgroups, {plan['stages']} stages): " +
              ", ".join(f"{name} {min(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
                        for name, t in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
