"""Device milliseconds of the last two scales of the decode per image
delivered: the ``sdvar.decode.scale`` spans (``engine/decode.py``) whose
``si`` is one of the configuration's last two scales (VAR-d36 512px: scales
8 and 9, 1,600 of the 2,240 tokens, attending over 1,216 and 2,240 keys),
each the time between its two CUDA events on the dispatcher's stream,
summed over the traced window. They are what sets the 512px model apart
from the 256px cells. A program without the recorder reports nothing."""

LAYER = "models/var.py + engine/decode.py latent decode"
UNIT = "ms/img"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "img_per_s"
DRIVERS = ("fid_saln",)


def read(ctx):
    try:
        from sdvar_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    tail = len(ctx["model"]["var"]["patch_nums"]) - 2
    ms = sum(s.device_ms for s in spans()
             if s.name == "sdvar.decode.scale" and s.ids.get("si", -1) >= tail
             and s.device_ms is not None)
    return ms / ctx["images"] if ms > 0 and ctx["images"] else None
