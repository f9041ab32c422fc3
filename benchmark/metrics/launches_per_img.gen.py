"""Kernel launches on the card per image delivered, over a traced window of
whole batches: the host dispatch of the scale loop (``engine/decode.py``)
that paces the decode at small batches."""

LAYER = "engine/decode.py host dispatch"
UNIT = "launches/img"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "img_per_s"
DRIVERS = ("fid",)


def read(ctx):
    n = ctx["trace"].launches()
    return n / ctx["images"] if n and ctx["images"] else None
