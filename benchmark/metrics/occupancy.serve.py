"""Real requests over bucket slots, averaged over the traced window's
batches (``GenerationServer.stats``): below 1 the card decodes padding;
at low load the scheduler sends smaller, emptier batches."""

LAYER = "engine/serving.py scheduler"
UNIT = "ratio"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "latency_p95_ms"
DRIVERS = ("serve",)


def read(ctx):
    return ctx.get("occupancy") or None
