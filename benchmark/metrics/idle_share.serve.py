"""Share of the traced window in which no operation ran on the card (1 -
busy / window, the busy seconds the union of the device operations'
intervals): how far the host holds the card back."""

LAYER = "device"
UNIT = "ratio"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "latency_p95_ms"
DRIVERS = ("serve",)


def read(ctx):
    tr = ctx["trace"]
    return 1.0 - tr.busy_s / tr.window_s if tr.window_s > 0 and tr.busy_s > 0 else None
