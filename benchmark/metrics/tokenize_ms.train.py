"""Mean device milliseconds a step of the ``tokenize`` span of
``train_step(timer=SpanTimer)`` (CUDA events, no synchronisation inside
the step): the frozen VQVAE encoder and the quantizer's encode."""

LAYER = "train/trainer.py tokenize (VQVAE encoder + quantizer)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_img_per_s"
DRIVERS = ("train",)


def read(ctx):
    s = ctx.get("spans", {}).get("tokenize")
    return s["mean_ms"] if s else None
