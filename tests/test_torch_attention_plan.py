"""The attention kernel's launch geometry (``attention_plan``), on the CPU:
grid, warpgroups, ring stages, shared memory, copy box and the bytes the
copies stage, at the VAR decode's ten scales, the speculative verify
window and VAR-d16's 16 heads; and the refusals, with the wrapper's
messages, of what the kernel does not take."""

import pytest
import torch

from sdvar_tpu_torch.ops.kernels.attention import (
    MAX_SMEM,
    _check_operand,
    attention_plan,
)

PNS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
# (Lq, Lk) of the ten scales: pn^2 new queries over every token so far
SCALES = [(pn * pn, sum(x * x for x in PNS[: i + 1])) for i, pn in enumerate(PNS)]
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
# shared memory of a 3-stage ring at hd = 64, after 1 KiB of alignment
# slack: bf16 K/V 2 x 8 KiB a stage; int8 2 x 4 KiB + 2 x 64 scales a
# stage (rounded up to 1 KiB) and one pair of converted 8 KiB bf16 tiles;
# an f32 cache 2 x 16 KiB a stage and the same pair
SMEM_HD64 = {BF16: 1024 + 49152, I8: 1024 + 26624 + 16384,
             F32: 1024 + 3 * 32768 + 16384}
CASES = ([("d30 scale %d" % i, 32, Lq, Lk, 30, False) for i, (Lq, Lk) in enumerate(SCALES)]
         + [("verify window", 32, 425, 680, 30, True),
            ("d16 scale 9", 32, 256, 680, 16, False)])


@pytest.mark.parametrize("kv_dtype", [BF16, I8, F32], ids=["bf16", "int8", "f32"])
@pytest.mark.parametrize("tag,B,Lq,Lk,H,write", CASES, ids=[c[0] for c in CASES])
def test_attention_plan_geometry(tag, B, Lq, Lk, H, write, kv_dtype):
    hd = 64
    plan = attention_plan(B, Lq, Lk, H, hd, BF16, kv_dtype, write=write,
                          q_strides=(Lq * 3 * H * hd, 3 * H * hd),
                          kv_strides=(680 * H * hd, H * hd))
    gx, gh, gb = plan["grid"]
    wg = plan["warpgroups"]
    assert (gh, gb) == (H, B)
    assert plan["threads"] == 128 * wg and 1 <= wg <= 2
    rows = 64 * wg
    assert gx * rows >= Lq > (gx - 1) * rows  # every query row, no empty block
    assert rows - 64 < -(-Lq // gx)  # no idle warpgroup beyond one ragged one
    if Lq <= 128:
        assert gx == 1  # K/V staged once per (b, h)
    assert plan["stages"] == 3
    assert plan["smem_bytes"] == SMEM_HD64[kv_dtype] <= MAX_SMEM
    assert plan["box"] == (64, hd)
    item, new = {BF16: (2, 2), I8: (1, 1), F32: (4, 2)}[kv_dtype]
    n_new = Lq if write else 0
    per_row = 2 * hd * (item * (Lk - n_new) + new * n_new)
    if kv_dtype == I8:
        per_row += 8 * Lk
    assert plan["kv_bytes_staged"] == gx * B * H * per_row


@pytest.mark.parametrize("hd,kv_dtype,stages,wg,cap", [
    (32, BF16, 3, 4, 4), (64, I8, 3, 4, 4), (64, BF16, 3, 2, None),
    (128, BF16, 3, 2, 2), (128, F32, 3, 2, None), (128, I8, 3, 2, None)])
def test_attention_plan_head_dims(hd, kv_dtype, stages, wg, cap):
    plan = attention_plan(32, 256, 680, 30, hd, BF16, kv_dtype,
                          max_warpgroups=cap)
    assert plan["stages"] == stages and plan["warpgroups"] == wg
    assert plan["grid"][0] == 256 // (64 * wg)
    assert plan["smem_bytes"] <= MAX_SMEM


def test_attention_plan_f32_q_keeps_the_scalar_kernel():
    plan = attention_plan(4, 169, 424, 3, 64, F32, I8)
    assert plan["grid"] == (3, 3, 4) and plan["threads"] == 256
    assert plan["stages"] == 0 and plan["smem_bytes"] == 4 * (2 * 64 * 68 + 64 * 64
                                                             + 64 * 68 + 128)


@pytest.mark.parametrize("kwargs,match", [
    ({"hd": 96}, "head dim 96"),
    ({"q_dtype": torch.float16}, "not supported"),
    ({"kv_dtype": F32, "q_dtype": F32, "stages": 5}, None),
    ({"kv_dtype": torch.bfloat16, "q_dtype": F32}, "not taken"),
    ({"kv_strides": (680 * 1920, 1920 + 4)}, "16-byte aligned with strides a multiple of 8"),
    ({"q_strides": (3, 5760)}, "16-byte aligned"),
    ({"kv_dtype": I8, "kv_strides": (680 * 1920, 1928)}, "a multiple of 16"),
    ({"stages": 5}, "stages"),
    ({"stages": 1}, "stages"),
    ({"hd": 128, "kv_dtype": F32, "stages": 4}, "does not fit"),
    ({"max_warpgroups": 3, "hd": 128}, "warpgroups"),
    ({"Lq": 0}, "no launch"),
])
def test_attention_plan_refuses(kwargs, match):
    args = {"B": 32, "Lq": 256, "Lk": 680, "H": 30, "hd": 64,
            "q_dtype": BF16, "kv_dtype": BF16}
    args.update(kwargs)
    if match is None:  # f32 q ignores the ring: no refusal
        assert attention_plan(**args)["stages"] == 0
        return
    with pytest.raises(ValueError, match=match):
        attention_plan(**args)


def test_check_operand_refuses_a_cpu_tensor():
    q = torch.zeros(2, 4, 3, 64, dtype=BF16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _check_operand("q", q, BF16, 64)


def test_ablate_attention_finds_every_part():
    """The ablation tool's edits each hit the attention source once, so a
    change to the loop cannot silently leave an ablated copy whole."""
    from sdvar_tpu_torch.tools.ablate_attention import ABLATIONS, _sources

    srcs = _sources()
    assert set(srcs) == {"whole", *ABLATIONS}
    whole = srcs["whole"].read_text()
    for name in ABLATIONS:
        assert srcs[name].read_text() != whole
