"""A/B of two versions of the attention kernel on one card, in turns.

    git archive <commit> sdvar_tpu_torch/csrc | tar -x -C build/parent
    python3 -m sdvar_tpu_torch.tools.ab_attention build/parent

Builds ``OTHER_ROOT/sdvar_tpu_torch/csrc/attention.cu`` (another checkout
of this repository, e.g. a parent commit unpacked as above into a
directory under ``build/``) beside this checkout's, and times both
versions' ``sdvar_attention`` and ``sdvar_attention_int8`` at VAR-d30's
decode scales 7-9 (2B=32, H=30, hd=64, bf16 q; float or int8 K/V slices of
a batch-major cache) and, where the other version has it,
``sdvar_attention_cache`` at the same shapes: the full-cache attention
(kernel row 7) and the fused cache write (row 8, cache_begin = Lk - Lq),
bf16 and int8, in the order other, this, this, other, three times over;
prints each time, the best of each and the speedup (other / this), after
the attention of one whole decode (all ten scales x 30 layers, each
version's device time summed over two turns each). Launches are timed on
the device: queued behind a spin kernel, not at the host's pace. This
version launches with ``attention_plan``'s geometry (the C interface
takes two more arguments, warpgroups and stages, than earlier versions);
at scale 9 it is also timed at every ring depth and warpgroup cap the
plan allows, and the K/V bytes its copies stage are printed beside the
bound's count. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from sdvar_tpu_torch.ops.kernels import _build
from sdvar_tpu_torch.ops.kernels.attention import (
    _cache_lib,
    _layer_ptr,
    _lib,
    attention_plan,
)

SHAPES = ((100, 255), (169, 424), (256, 680))  # (Lq, Lk) of scales 7-9
PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)  # the decode's ten scales
DEPTH = 30  # VAR-d30's layers: one launch each per scale
HBM_BPS = 3.35e12  # the H100 SXM's memory rate (data sheet)


def _start_other(root: Path):
    """Start nvcc on the other version's attention.cu; returns (proc, out)."""
    out = _build.BUILD_ROOT.parent / "ab" / "libattention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = root / "sdvar_tpu_torch" / "csrc" / "attention.cu"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def _other_lib(proc, out: Path) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the other version:\n{log}")
    _print_regs("other", log)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, ptrs, strides in ((lib.sdvar_attention, 5, 6),
                              (lib.sdvar_attention_int8, 7, 8)):
        fn.argtypes = [P] * ptrs + [I] * 6 + [LL] * strides + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    if hasattr(lib, "sdvar_attention_cache"):  # without warpgroups, stages
        lib.sdvar_attention_cache.argtypes = _cache_lib().argtypes[:-2]
        lib.sdvar_attention_cache.restype = ctypes.c_int
    return lib


def _print_regs(tag: str, log: str) -> None:
    """The ptxas register, shared memory and spill report of the hd=64 bf16
    tensor-core kernels of one build."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "attention_mma_kernelILi64E" in line:
            name = line.split("'")[1]
            near = lines[i + 1: i + 4]
            used = next((x for x in near if "Used" in x), "")
            spill = next((x for x in near if "spill" in x), "")
            print(f"[{tag}] {name}: {used.split(':', 1)[-1].strip()}; "
                  f"{spill.strip()}")


def _launcher(fn, args):
    def launch():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")
    return launch


def _caller(fn, q, k, v, scales, geometry=()):
    """A launch of ``fn`` (either version's entry point) on these operands;
    ``geometry``: this version's (warpgroups, stages)."""
    B, Lq, H, hd = q.shape
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    strides = [q.stride(0), q.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1)]
    if scales is not None:
        ptrs += [s.data_ptr() for s in scales]
        strides += list(scales[0].stride())
    return _launcher(fn, (*ptrs, None, out.data_ptr(), 1, B, Lq, k.shape[1], H,
                          hd, *strides, 1.0,
                          torch.cuda.current_stream().cuda_stream, *geometry))


def _cache_caller(fn, q, ck, cv, cs, kv_len, new=None, geometry=()):
    """A launch of ``fn``'s ``sdvar_attention_cache`` over layer 0 of ck/cv,
    keys [0, kv_len): the full-cache attention, or with ``new`` = (kn, vn,
    new scales) the fused write of the Lq new rows at kv_len - Lq."""
    B, Lq, H, hd = q.shape
    out = torch.empty_like(q)
    int8 = cs is not None
    kn, vn, ns = new if new is not None else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    st = lambda t: tuple(t.stride()[:2]) if t is not None else (0, 0)
    args = (q.data_ptr(), _layer_ptr(ck, 0), _layer_ptr(cv, 0),
            cs[0].data_ptr() if int8 else None, cs[1].data_ptr() if int8 else None,
            ptr(kn), ptr(vn), ptr(ns[0]) if ns else None,
            ptr(ns[1]) if ns else None, None, out.data_ptr(), 1,
            2 if int8 else 1, int(new is not None), B, Lq, kv_len,
            kv_len - Lq if new is not None else kv_len, H, hd, q.stride(0),
            q.stride(1), ck.stride(1), ck.stride(2),
            *(cs[0].stride()[1:] if int8 else (0, 0)), *st(kn), *st(vn),
            *(ns[0].stride() if ns else (0, 0)), 1.0,
            torch.cuda.current_stream().cuda_stream, *geometry)
    return _launcher(fn, args)


def _ab(runs):
    """Best and all times of the two launches, in turns, and the speedup
    of this over other (best over best)."""
    ms = {"other": [], "this": []}
    for launch in runs.values():
        launch()
        torch.cuda.synchronize()
    for _ in range(3):
        for name in ("other", "this", "this", "other"):
            ms[name].append(_ms(runs[name]))
    return (f"other {min(ms['other']):.4f} ms "
            f"({' '.join(f'{t:.4f}' for t in ms['other'])}), this "
            f"{min(ms['this']):.4f} ms ({' '.join(f'{t:.4f}' for t in ms['this'])}); "
            f"speedup {min(ms['other']) / min(ms['this']):.3f}x")


def _ms(launch, iters=50):
    """Mean device time of a launch: the launches are queued behind a spin
    kernel (about 10 ms), so the card runs them back to back, not at the
    host's pace."""
    for _ in range(3):
        launch()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _geometry(plan):
    return plan["warpgroups"], plan["stages"]


def _bound_bytes(Bq, Lq, Lk, H, hd, int8):
    """K/V bytes the bound counts (each row read once), and the bound's
    total (q, k, v, o and int8 scales once)."""
    kv = Bq * H * hd * 2 * Lk * (1 if int8 else 2) + (Bq * Lk * 8 if int8 else 0)
    return kv, kv + Bq * H * hd * Lq * 2 * 2


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    proc, out = _start_other(Path(argv[0]))
    _build.build(["attention"])
    other = _other_lib(proc, out)
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
    for int8 in (False, True):  # attention over one decode: 10 scales x 30
        kind = "int8" if int8 else "bf16"
        kv_dtype = torch.int8 if int8 else torch.bfloat16
        tot = {"other": 0.0, "this": 0.0}
        Lk = 0
        for pn in PNS:
            Lq, Lk = pn * pn, Lk + pn * pn
            q = torch.randn(Bq, Lq, H, hd, device="cuda", generator=g).to(torch.bfloat16)
            src = vals if int8 else cache
            k, v = (src[i, :, :Lk].view(Bq, Lk, H, hd) for i in range(2))
            scales = (planes[0, :, :Lk], planes[1, :, :Lk]) if int8 else None
            plan = attention_plan(Bq, Lq, Lk, H, hd, torch.bfloat16, kv_dtype)
            runs = {"other": _caller(other.sdvar_attention_int8 if int8
                                     else other.sdvar_attention, q, k, v, scales),
                    "this": _caller(_lib(int8), q, k, v, scales, _geometry(plan))}
            for name in ("other", "this", "this", "other"):
                tot[name] += _ms(runs[name], 20) * DEPTH / 2
        print(f"attention {kind} per decode (10 scales x {DEPTH} layers, device "
              f"time): other {tot['other']:.3f} ms, this {tot['this']:.3f} ms; "
              f"speedup {tot['other'] / tot['this']:.3f}x", flush=True)
    for int8 in (False, True):
        kind = "int8" if int8 else "bf16"
        kv_dtype = torch.int8 if int8 else torch.bfloat16
        for Lq, Lk in SHAPES:
            q = torch.randn(Bq, Lq, H, hd, device="cuda", generator=g).to(torch.bfloat16)
            src = vals if int8 else cache
            k = src[0, :, :Lk].view(Bq, Lk, H, hd)
            v = src[1, :, :Lk].view(Bq, Lk, H, hd)
            scales = (planes[0, :, :Lk], planes[1, :, :Lk]) if int8 else None
            plan = attention_plan(Bq, Lq, Lk, H, hd, torch.bfloat16, kv_dtype)
            kv_b, all_b = _bound_bytes(Bq, Lq, Lk, H, hd, int8)
            print(f"{kind} Lq={Lq} Lk={Lk}: plan grid {plan['grid']} "
                  f"warpgroups {plan['warpgroups']} stages {plan['stages']} "
                  f"smem {plan['smem_bytes']} B; K/V bytes staged "
                  f"{plan['kv_bytes_staged']} (bound counts {kv_b}; bound "
                  f"{all_b / HBM_BPS * 1e3:.4f} ms)", flush=True)
            runs = {"other": _caller(other.sdvar_attention_int8 if int8
                                     else other.sdvar_attention, q, k, v, scales),
                    "this": _caller(_lib(int8), q, k, v, scales, _geometry(plan))}
            print(f"  attention {kind} Lq={Lq} Lk={Lk}: {_ab(runs)}", flush=True)
            if (Lq, Lk) == SHAPES[-1]:  # every ring depth and warpgroup cap
                for cap in (2, 4):
                    for stages in (2, 3, 4):
                        p = attention_plan(Bq, Lq, Lk, H, hd, torch.bfloat16,
                                           kv_dtype, stages=stages,
                                           max_warpgroups=cap)
                        t = _ms(_caller(_lib(int8), q, k, v, scales, _geometry(p)))
                        print(f"  sweep {kind} scale 9: warpgroups "
                              f"{p['warpgroups']} (grid x {p['grid'][0]}) stages "
                              f"{stages}: {t:.4f} ms", flush=True)
            if not hasattr(other, "sdvar_attention_cache"):
                continue
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
            for new in (None, (kn, vn, ns)):
                plan = attention_plan(Bq, Lq, Lk, H, hd, torch.bfloat16, kv_dtype,
                                      write=new is not None)
                runs = {"other": _cache_caller(other.sdvar_attention_cache, q, ck,
                                               cv, cs, Lk, new),
                        "this": _cache_caller(_cache_lib(), q, ck, cv, cs, Lk, new,
                                              _geometry(plan))}
                what = ("cache write (row 8)" if new is not None
                        else "full cache (row 7)")
                print(f"  {what} {kind} Lq={Lq} kv_len={Lk}: {_ab(runs)}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
