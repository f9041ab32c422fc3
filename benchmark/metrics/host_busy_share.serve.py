"""Share of the traced window in which the server's scheduler thread
dispatched batches: the summed host time of its ``sdvar.serve.dispatch``
spans (``utils.profiling``: the decode, the pixels and the queued copy of
a batch) over the window. Near 1, the host sets the pace. A program
without the recorder reports nothing."""

LAYER = "engine/serving.py scheduler"
UNIT = "ratio"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms"
DRIVERS = ("serve",)


def read(ctx):
    try:
        from sdvar_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    ms = sum(s.host_ms for s in spans() if s.name == "sdvar.serve.dispatch")
    window_s = ctx["trace"].window_s
    return 1e-3 * ms / window_s if ms > 0 and window_s > 0 else None
