"""Host milliseconds the dispatcher thread of ``sample_fid.sample_batches``
spends issuing a batch (its ``sdvar.fid.dispatch`` spans,
``utils.profiling``: the decode, the pixel decode and the queued copy,
not the wait on a full queue), summed over the traced window, per image
delivered. A program without the recorder reports nothing."""

LAYER = "engine/decode.py host dispatch"
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
    ms = sum(s.host_ms for s in spans() if s.name == "sdvar.fid.dispatch")
    return ms / ctx["images"] if ms > 0 and ctx["images"] else None
