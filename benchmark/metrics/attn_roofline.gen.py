"""Kernel row 1 (``csrc/attention.cu``, float K/V) against its roofline:
the sum over its launches in the traced window of each call's least time
(the larger of its FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s,
each input read once and the output written once; ``harness/work.py``)
over the sum of the launches' device time. A traced window starts at a
decode's first scale, and each decode calls the kernel scale by scale,
layer by layer, so the n-th launch's shape follows from n. The kernel is
found by its name below: a change that renames it changes this file."""

LAYER = "ops/kernels/attention.py + csrc/attention.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "img_per_s"
DRIVERS = ("fid",)
KV = "bf16"  # the KV cache of the cells it reads


def read(ctx):
    return decode_roofline(ctx, KV)


KERNEL = "attention_mma_kernel"


def decode_roofline(ctx, kv):
    from benchmark.harness import work

    if ctx.get("kv") != kv:
        return None
    durs = ctx["trace"].durations_of(lambda n: KERNEL in n)
    if not durs:
        return None
    least = work.decode_attention_least(ctx["model"]["var"], ctx["batch"], kv)
    need = sum(least[i % len(least)] for i in range(len(durs)))
    return 100.0 * need / sum(durs)
