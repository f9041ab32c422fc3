"""Share of the traced window's ``sdvar.decode.scale`` spans (a scale of
a decode, ``engine/decode.py``) whose block stack was replayed from a
CUDA graph: those that enclose a ``sdvar.decode.replay`` span. 1 when
every scale of every decode in the window replays; a program whose decode
has no graphs (no ``ScaleGraphs``) reports nothing."""

LAYER = "engine/decode.py host dispatch"
UNIT = "ratio"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "img_per_s"
DRIVERS = ("fid",)


def read(ctx):
    try:
        from sdvar_tpu_torch.engine import decode
        from sdvar_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    if not hasattr(decode, "ScaleGraphs"):
        return None
    got = spans()
    scales = {s.index for s in got if s.name == "sdvar.decode.scale"}
    replayed = {s.parent for s in got if s.name == "sdvar.decode.replay"}
    return len(scales & replayed) / len(scales) if scales else None
