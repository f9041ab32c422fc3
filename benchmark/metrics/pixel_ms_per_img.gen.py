"""Device milliseconds of the pixel decoder per image delivered: the
``sdvar.pixels`` spans around ``sample_fid``'s pixel decode
(``utils.profiling``), each the time between its two CUDA events on the
dispatcher's stream, summed over the traced window. Minus
``conv_ms_per_img.gen``: the decoder's other kernels and its idle time. A
program without the recorder reports nothing."""

LAYER = "models/vqvae.py pixel decoder"
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
             if s.name == "sdvar.pixels" and s.device_ms is not None)
    return ms / ctx["images"] if ms > 0 and ctx["images"] else None
