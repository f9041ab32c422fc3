"""Device milliseconds of the latent decode per image delivered: the
``sdvar.decode`` spans of ``decode_all_scales`` (``utils.profiling``),
each the time between its two CUDA events on the dispatcher's stream
(idle time inside a decode included), summed over the traced window. A
program without the recorder reports nothing."""

LAYER = "models/var.py + engine/decode.py latent decode"
UNIT = "ms/img"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "img_per_s"
DRIVERS = ("fid",)


def read(ctx):
    try:
        from sdvar_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    ms = sum(s.device_ms for s in spans()
             if s.name == "sdvar.decode" and s.device_ms is not None)
    return ms / ctx["images"] if ms > 0 and ctx["images"] else None
