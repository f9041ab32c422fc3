"""The fused W8A8 kernel's geometry on the CPU (``w8a8_plan``, the CUDA
source ``csrc/w8a8_fused.cu``): tiles, grid, shared memory and scratch at
the microbenchmark's shapes, and the persistent work list: every block
quantizes its units before it multiplies, each strip is quantized once,
and the flag waits always end."""

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.ops.kernels.w8a8_fused import (
    ALIGN,
    STAGES,
    TILE_M,
    TILE_N,
    UNIT,
    w8a8_fused,
    w8a8_fused_plain,
    w8a8_plan,
)
from sdvar_tpu_torch.ops.quantization import k_major
from sdvar_tpu_torch.tools.microbench_int8_matmul import B, SHAPES

FUSED_SHAPES = SHAPES + ((25, 1920, 7680, "fc1 s4"),)
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on an H100


def work_lists(plan, M, N, s8):
    """Each block's work in order: ("unit", flag, rows or columns), then
    ("tile", strip, column tile), gridDim.x apart as the kernel walks
    them."""
    ux = -(-M // UNIT)
    uw = 0 if s8 else -(-N // UNIT)
    lists = []
    for b in range(plan["grid"]):
        work = []
        for u in range(b, ux + uw, plan["grid"]):
            if u < ux:
                work.append(("unit", u * UNIT // TILE_M, range(u * UNIT, min(M, (u + 1) * UNIT))))
            else:
                n0 = (u - ux) * UNIT
                work.append(("unit", plan["tiles_m"] + n0 // TILE_N,
                             range(n0, min(N, n0 + UNIT))))
        for t in range(b, plan["tiles"], plan["grid"]):
            work.append(("tile", t // plan["tiles_n"], t % plan["tiles_n"]))
        lists.append(work)
    return lists


def units_in(total, start, tile):
    return -(-min(tile, total - start) // UNIT)


def run_schedule(plan, M, N, s8):
    """Step every block through its list; a tile waits until its strip's
    (and weight tile's) flag counts all units. Returns the rows each
    strip's units quantized, or raises if the waits never end."""
    lists = work_lists(plan, M, N, s8)
    pos = [0] * len(lists)
    flags = np.zeros(plan["flags"], np.int64)
    rows = {}
    while any(p < len(w) for p, w in zip(pos, lists)):
        moved = False
        for b, work in enumerate(lists):
            if pos[b] == len(work):
                continue
            kind, a, c = work[pos[b]]
            if kind == "unit":
                flags[a] += 1
                if a < plan["tiles_m"]:
                    rows.setdefault(a, []).extend(c)
            else:
                need = [(a, units_in(M, a * TILE_M, TILE_M))]
                if not s8:
                    need.append((plan["tiles_m"] + c, units_in(N, c * TILE_N, TILE_N)))
                if any(flags[f] < n for f, n in need):
                    continue
            pos[b] += 1
            moved = True
        assert moved, "every block waits: the flags never fill"
    return rows, lists


@pytest.mark.parametrize("s8", [True, False])
@pytest.mark.parametrize("L,K,N,tag", FUSED_SHAPES)
def test_plan_at_the_microbenchmark_shapes(L, K, N, tag, s8):
    M = B * L  # the microbenchmark's x is (B, L, K)
    p = w8a8_plan(M, K, N, s8)
    assert p["tiles_m"] == -(-M // TILE_M) and p["tiles_n"] == -(-N // TILE_N)
    assert p["grid"] == min(132, max(p["tiles"], p["units"])) and p["grid"] <= 132
    assert p["smem_bytes"] == 1024 + STAGES * (TILE_M + TILE_N) * 128 <= SMEM_LIMIT
    assert K % (32 if s8 else 16) == 0 and N % 8 == 0
    xq = M * K * (1 if s8 else 2)
    assert p["scratch_bytes"] >= xq + M * 4 + p["flags"] * 4
    if s8 and K == 1920:  # the quantized x and wq fit the 50 MB L2 together
        assert p["scratch_bytes"] + K * N < 50e6


@pytest.mark.parametrize("s8", [True, False])
@pytest.mark.parametrize("M,K,N", [(8192, 1920, 7680), (800, 1920, 7680),
                                   (6144, 7680, 1920), (8192, 1920, 4096),
                                   (100, 1920, 200), (8, 64, 64)])
def test_each_strip_is_quantized_once_and_the_waits_end(M, K, N, s8):
    """Every row is quantized by exactly one unit (the first version
    re-read each strip once per 128-column tile: N / 128 times), every
    block's units precede its tiles, and a schedule in which blocks only
    move when their flags allow reaches the end."""
    p = w8a8_plan(M, K, N, s8)
    rows, lists = run_schedule(p, M, N, s8)
    assert sorted(r for rs in rows.values() for r in rs) == list(range(M))
    for work in lists:
        kinds = [w[0] for w in work]
        assert kinds == sorted(kinds, key=lambda k: k != "unit")
    assert sum(w[0] == "tile" for work in lists for w in work) == p["tiles"]


def test_scratch_parts_are_aligned():
    p = w8a8_plan(800, 1920, 7680, False)
    xq, xs, wb = 800 * 1920 * 2, 800 * 4, 7680 * 1920 * 2
    up = lambda v: -(-v // ALIGN) * ALIGN  # noqa: E731
    assert p["scratch_bytes"] == up(xq) + up(xs) + up(wb) + p["flags"] * 4
    assert p["flags"] == 4 + 48


@pytest.mark.parametrize("s8", [True, False])
def test_cpu_path_is_the_plain_version(s8):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 40, 64, generator=g) * 3).to(torch.bfloat16)
    q = k_major(torch.randint(-127, 128, (64, 48), generator=g, dtype=torch.int8))
    s = torch.rand(48, generator=g) * 1e-2
    assert torch.equal(w8a8_fused(x, q, s, s8), w8a8_fused_plain(x, q, s, s8))
