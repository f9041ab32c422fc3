"""Mean device milliseconds a step of the ``backward`` span of
``train_step(timer=SpanTimer)``: the transformer's backward, with
``ops/attention.py``'s ``AttentionFn`` backward."""

LAYER = "train/trainer.py backward (ops/attention.py AttentionFn)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_img_per_s"
DRIVERS = ("train",)


def read(ctx):
    s = ctx.get("spans", {}).get("backward")
    return s["mean_ms"] if s else None
