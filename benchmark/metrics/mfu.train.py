"""The whole training step's share of the card's bf16 dense peak (989
TFLOP/s): the FLOPs a step needs (``harness/work.py:train_flops_per_step``:
the transformer's forward and backward, 3x the forward, the frozen
encoder and the quantizer's encode) times the steps of the traced window,
over the window."""

LAYER = "whole step (models/var.py + models/vqvae.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
DRIVERS = ("train",)


def read(ctx):
    from benchmark.harness import work

    if not ctx["steps"] or ctx["trace"].window_s <= 0:
        return None
    flops = work.train_flops_per_step(ctx["model"], ctx["batch"]) * ctx["steps"]
    return work.mfu_percent(flops, ctx["trace"].window_s)
