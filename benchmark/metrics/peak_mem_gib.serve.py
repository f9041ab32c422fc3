"""The card's peak allocated memory over the traced window,
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at its start, in GiB."""

LAYER = "device"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "latency_p95_ms"
DRIVERS = ("serve",)


def read(ctx):
    b = ctx.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
