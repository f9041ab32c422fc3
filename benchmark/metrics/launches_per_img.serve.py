"""Kernel launches on the card per request delivered in the traced window:
the host dispatch of the scale loop (``engine/decode.py``) at the server's
smaller, uneven batches."""

LAYER = "engine/decode.py host dispatch"
UNIT = "launches/img"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "latency_p95_ms"
DRIVERS = ("serve",)


def read(ctx):
    n = ctx["trace"].launches()
    return n / ctx["images"] if n and ctx["images"] else None
