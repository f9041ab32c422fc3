"""A/B of two versions of the attention kernel on one card, in turns.

    python3 -m sdvar_tpu_torch.tools.ab_attention OTHER_ROOT

Builds ``OTHER_ROOT/sdvar_tpu_torch/csrc/attention.cu`` (another checkout
of this repository, e.g. the parent commit unpacked with ``git archive``
into a directory under ``build/``) beside this checkout's, and times both
versions' ``sdvar_attention`` and ``sdvar_attention_int8`` (a C interface
both versions share) at VAR-d30's decode shapes (2B=32, H=30, hd=64, bf16
q; float or int8 K/V slices of a batch-major cache), and, where the other
version has it, ``sdvar_attention_cache``'s fused cache write at scale 9
(cache_begin 424, 256 new rows), in the order other, this, this, other,
three times over; prints each time and the best of each. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.attention import _cache_lib, _layer_ptr, _lib

SHAPES = ((100, 255), (169, 424), (256, 680))  # (Lq, Lk) of scales 7-9


def _other_lib(root: Path) -> ctypes.CDLL:
    out = _build.BUILD_ROOT.parent / "ab" / "libattention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = root / "sdvar_tpu_torch" / "csrc" / "attention.cu"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src)], check=True, capture_output=True, text=True)
    _print_regs("other", res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, ptrs, strides in ((lib.sdvar_attention, 5, 6),
                              (lib.sdvar_attention_int8, 7, 8)):
        fn.argtypes = [P] * ptrs + [I] * 6 + [LL] * strides + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    if hasattr(lib, "sdvar_attention_cache"):
        lib.sdvar_attention_cache.argtypes = _cache_lib().argtypes
        lib.sdvar_attention_cache.restype = ctypes.c_int
    return lib


def _print_regs(tag: str, log: str) -> None:
    """The ptxas register and spill report of the hd=64 bf16 tensor-core
    kernels of one build."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "attention_mma_kernelILi64E" in line:
            name = line.split("'")[1]
            near = lines[i + 1: i + 4]
            used = next((x for x in near if "Used" in x), "")
            spill = next((x for x in near if "spill" in x), "")
            print(f"[{tag}] {name}: {used.split(':', 1)[-1].strip()}; "
                  f"{spill.strip()}")


def _caller(fn, q, k, v, scales):
    """A launch of ``fn`` (either version's entry point) on these operands."""
    B, Lq, H, hd = q.shape
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    strides = [q.stride(0), q.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1)]
    if scales is not None:
        ptrs += [s.data_ptr() for s in scales]
        strides += list(scales[0].stride())
    args = (*ptrs, None, out.data_ptr(), 1, B, Lq, k.shape[1], H, hd, *strides,
            1.0, torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")
    return launch


def _write_caller(fn, q, ck, cv, cs, kn, vn, ns, begin):
    """A fused cache-write launch of ``fn`` into layer 0 of ck/cv."""
    B, Lq, H, hd = q.shape
    out = torch.empty_like(q)
    int8 = cs is not None
    code = 2 if int8 else 1
    args = (q.data_ptr(), _layer_ptr(ck, 0), _layer_ptr(cv, 0),
            cs[0].data_ptr() if int8 else None, cs[1].data_ptr() if int8 else None,
            kn.data_ptr(), vn.data_ptr(), ns[0].data_ptr() if int8 else None,
            ns[1].data_ptr() if int8 else None, None, out.data_ptr(), 1, code, 1,
            B, Lq, begin + Lq, begin, H, hd, q.stride(0), q.stride(1),
            ck.stride(1), ck.stride(2), *(cs[0].stride()[1:] if int8 else (0, 0)),
            kn.stride(0), kn.stride(1), vn.stride(0), vn.stride(1),
            *(ns[0].stride() if int8 else (0, 0)), 1.0,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")
    return launch


def _ab(runs):
    """Best and all times of the two launches, in turns."""
    ms = {"other": [], "this": []}
    for name, launch in runs.items():
        launch()
        torch.cuda.synchronize()
    for _ in range(3):
        for name in ("other", "this", "this", "other"):
            ms[name].append(_ms(runs[name]))
    return (f"other {min(ms['other']):.4f} ms "
            f"({' '.join(f'{t:.4f}' for t in ms['other'])}), this "
            f"{min(ms['this']):.4f} ms ({' '.join(f'{t:.4f}' for t in ms['this'])})")


def _ms(launch, iters=50):
    for _ in range(3):
        launch()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = _other_lib(Path(argv[0]))
    _build.build(["attention"])
    _print_regs("this", _build.build_log("attention"))
    g = torch.Generator(device="cuda").manual_seed(0)
    Bq, H, hd, Lmax = 32, 30, 64, 680
    cache = torch.randn(2, Bq, Lmax, H * hd, device="cuda", generator=g).to(torch.bfloat16)
    vals = torch.randint(-127, 128, (2, Bq, Lmax, H * hd), device="cuda",
                         generator=g, dtype=torch.int8)
    planes = torch.rand(2, Bq, Lmax, device="cuda", generator=g) + 0.5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for int8 in (False, True):
        for Lq, Lk in SHAPES:
            q = torch.randn(Bq, Lq, H, hd, device="cuda", generator=g).to(torch.bfloat16)
            src = vals if int8 else cache
            k = src[0, :, :Lk].view(Bq, Lk, H, hd)
            v = src[1, :, :Lk].view(Bq, Lk, H, hd)
            scales = (planes[0, :, :Lk], planes[1, :, :Lk]) if int8 else None
            fns = {"other": (other.sdvar_attention_int8 if int8
                             else other.sdvar_attention),
                   "this": _lib(int8)}
            runs = {name: _caller(fn, q, k, v, scales) for name, fn in fns.items()}
            print(f"{'int8' if int8 else 'bf16'} Lq={Lq} Lk={Lk}: {_ab(runs)}",
                  flush=True)
    if hasattr(other, "sdvar_attention_cache"):
        Lq, begin = 256, 424
        q = torch.randn(Bq, Lq, H, hd, device="cuda", generator=g).to(torch.bfloat16)
        for int8 in (False, True):
            if int8:
                ck, cv = vals[:1].clone(), vals[1:].clone()
                cs = (planes[:1].clone(), planes[1:].clone())
                kn, vn = (torch.randint(-127, 128, (Bq, Lq, H, hd), device="cuda",
                                        generator=g, dtype=torch.int8) for _ in range(2))
                ns = (torch.rand(Bq, Lq, device="cuda", generator=g),
                      torch.rand(Bq, Lq, device="cuda", generator=g))
            else:
                ck, cv, cs, ns = cache[:1].clone(), cache[1:].clone(), None, None
                kn, vn = (torch.randn(Bq, Lq, H, hd, device="cuda", generator=g)
                          .to(torch.bfloat16) for _ in range(2))
            runs = {name: _write_caller(fn, q, ck, cv, cs, kn, vn, ns, begin)
                    for name, fn in (("other", other.sdvar_attention_cache),
                                     ("this", _cache_lib()))}
            print(f"cache write {'int8' if int8 else 'bf16'} Lq={Lq} "
                  f"cache_begin={begin}: {_ab(runs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
