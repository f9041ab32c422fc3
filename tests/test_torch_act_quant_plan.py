"""The activation quantizer's launch plan (``quant_plan``) and its exact
quotient rule (``exact_quotient_rint``), on the CPU.

The plan is held at every shape the VAR-d30 decodes launch: M = 32 pn^2
rows over the ten scales, K = 1920 (the qkv, proj and fc1 inputs) and 7680
(the fc2 input), and the 1x2 mesh rank's split rows, K = 960 and 3840. The
rule, which takes the kernel's quotient from a reciprocal product and falls
back to the IEEE quotient near a rounding tie, is held against
``torch.round(h / s)`` on constructed exact ties and near-ties at every
|q| <= 127, for scales as the kernel forms them.
"""

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.ops.kernels.quantize import (
    LATENCY_BOUND_THREADS,
    MAX_GROUP,
    MIN_GROUP,
    SMS,
    THREADS_PER_SM,
    act_quantize_kernel,
    act_scale_kernel,
    exact_quotient_rint,
    quant_plan,
)

PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
BF16, F32 = torch.bfloat16, torch.float32
CASES = [(32 * pn * pn, K, dt) for pn in PNS for K in (1920, 7680, 960, 3840)
         for dt in (BF16, F32)]


@pytest.mark.parametrize("M,K,dtype", CASES,
                         ids=[f"M{m}-K{k}-{str(d)[6:]}" for m, k, d in CASES])
def test_quant_plan_geometry(M, K, dtype):
    plan = quant_plan(M, K, dtype)
    vec, group, nv = plan["vec"], plan["group"], plan["nv"]
    threads, rows, grid = plan["threads"], plan["rows_per_block"], plan["grid"]
    assert vec == 16 // (4 if dtype == F32 else 2) and K % vec == 0
    # the row in registers: every load of it held once, at most two a thread
    assert group * nv * vec >= K and nv in (1, 2)
    assert MIN_GROUP <= group <= MAX_GROUP and group & (group - 1) == 0
    # few rows: one load a thread, the fewest threads that hold the row;
    # else the fewest that hold it in two loads each
    nvec = K // vec
    whole = max(MIN_GROUP, 1 << (nvec - 1).bit_length())
    if whole <= MAX_GROUP and M * whole <= LATENCY_BOUND_THREADS:
        assert nv == 1 and group == whole
    else:
        assert group == MIN_GROUP or (group // 2) * 2 * vec < K
        assert nv == 1 or group * vec < K
    assert threads % group == 0 and 128 <= threads <= 1024
    assert rows == threads // group
    # every row once: grid blocks walking rows grid apart, no more blocks
    # than rows and no more than the card holds at once
    assert 1 <= grid <= -(-M // rows)
    assert grid <= SMS * (THREADS_PER_SM // threads)
    assert grid == min(-(-M // rows), SMS * (THREADS_PER_SM // threads))


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_quant_plan_one_element_loads(dtype):
    """K not a multiple of the 16-byte vector takes one element a load."""
    plan = quant_plan(5, 100, dtype, vector=False)
    assert plan["vec"] == 1 and plan["group"] * plan["nv"] >= 100
    with pytest.raises(ValueError, match="multiple of"):
        quant_plan(5, 100, BF16)  # 100 is not a multiple of 8 bf16


@pytest.mark.parametrize("M,K,dtype,vector,match", [
    (8, 7680, BF16, False, "exceeds"),   # 7680 one-element loads
    (8, 16384, F32, True, "exceeds"),    # 4096 loads of 4 f32
    (8, 20000, BF16, True, "exceeds"),
    (0, 1920, BF16, True, "no launch"),
    (8, 1920, torch.float16, True, "float32 or"),
])
def test_quant_plan_refuses(M, K, dtype, vector, match):
    with pytest.raises(ValueError, match=match):
        quant_plan(M, K, dtype, vector)


def test_wrappers_refuse_cpu_tensors():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        act_quantize_kernel(x, None, False)
    with pytest.raises(ValueError, match="CUDA"):
        act_scale_kernel(x, None, False)
    with pytest.raises(ValueError, match="CUDA"):
        act_quantize_kernel(x, None, False, scale=torch.ones(4, 1))


def _scales(rng):
    """Row scales as the kernel forms them (fl(amax / 127), floored at
    1e-8), powers of two (exact ties) and the floor itself."""
    amax = np.concatenate([rng.uniform(1e-3, 50.0, 40),
                           rng.uniform(1e-6, 1e-3, 8)]).astype(np.float32)
    s = torch.clamp(torch.from_numpy(amax) / torch.tensor(127.0), min=1e-8)
    extra = torch.tensor([2.0 ** e for e in range(-12, 6)] + [1e-8, 3e-8])
    return torch.cat([s, extra.float()])


def test_exact_quotient_rule_on_ties_and_near_ties():
    """For every |q| <= 127: h at the f32 nearest (k + 0.5) s (an exact
    tie where the product is representable) and its neighbours up to four
    ulps away on either side, under each scale."""
    rng = np.random.default_rng(0)
    s = _scales(rng)[:, None]                                   # (S, 1)
    k = torch.arange(-128, 128, dtype=torch.float64)[None, :]  # (1, 256)
    tie = ((k + 0.5) * s.double()).float()                     # (S, 256)
    hs = [tie]
    up, down = tie.clone(), tie.clone()
    for _ in range(4):
        up = torch.nextafter(up, torch.full_like(up, float("inf")))
        down = torch.nextafter(down, torch.full_like(down, float("-inf")))
        hs += [up, down]
    h = torch.stack(hs)                                        # (9, S, 256)
    want = torch.round(h / s)
    got = exact_quotient_rint(h, s.expand_as(tie))
    assert want.abs().max().item() <= 128
    assert torch.equal(got, want)
    # the fast path is taken on none of these (all lie near a tie) but
    # decides elsewhere: on random rows the fallback is rare
    h = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32)) * 3
    sr = torch.clamp(h.abs().amax(-1, keepdim=True) / torch.tensor(127.0),
                     min=1e-8)
    assert torch.equal(exact_quotient_rint(h, sr.expand_as(h)),
                       torch.round(h / sr))
    p = h * (torch.ones_like(sr) / sr)
    near = ((p - torch.round(p)).abs() >= 0.5 - 2.0 ** -12).float().mean()
    assert 0 < near.item() < 2e-3


def test_exact_quotient_rule_falls_back_outside_its_range():
    """A scale far below the row's own (|h / s| > 128) and a scale whose
    reciprocal is not a normal number take the IEEE quotient."""
    h = torch.tensor([1000.3, -3.7e3, 5.5, 2.0 ** 100])
    for s in (torch.tensor(0.5), torch.tensor(2.0 ** 127)):
        got = exact_quotient_rint(h, s.expand_as(h))
        assert torch.equal(got, torch.round(h / s))

