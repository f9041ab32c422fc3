"""95th percentile over the traced window's requests of their
``sdvar.serve.queue`` span (``utils.profiling``): host milliseconds from a
request's submit to the start of its batch's dispatch on the scheduler
thread. A program without the recorder reports nothing."""

LAYER = "engine/serving.py scheduler"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms"
DRIVERS = ("serve",)


def read(ctx):
    from benchmark.harness.window import percentile_with_missing

    try:
        from sdvar_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    waits = [s.host_ms for s in spans() if s.name == "sdvar.serve.queue"]
    return percentile_with_missing(waits, 95) if waits else None
