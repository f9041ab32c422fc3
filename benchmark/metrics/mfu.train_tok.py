"""The training step's share of the card's bf16 dense peak (989 TFLOP/s)
in the cells of the ``train_tok`` driver, which train on stored ids: the
FLOPs of ``harness/work.py:train_flops_per_step`` without the frozen
encoder and the quantizer's encode, which such a step does not run, and
with the teacher-forcing input's phi convolutions (one a scale but the
last), which it does; times the steps of the traced window, over the
window."""

LAYER = "whole step (models/var.py + models/vqvae.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
DRIVERS = ("train_tok",)


def read(ctx):
    from benchmark.harness import work

    if not ctx["steps"] or ctx["trace"].window_s <= 0:
        return None
    var, cv = ctx["model"]["var"], ctx["model"]["vqvae"]["z_channels"]
    hw = var["patch_nums"][-1]
    phi = 2 * hw * hw * cv * cv * 9   # one 3x3 phi convolution, as work.py counts it
    per_image = 3 * work.transformer_flops_per_row(var, decode=False) \
        + (len(var["patch_nums"]) - 1) * phi
    flops = ctx["batch"] * per_image * ctx["steps"]
    return work.mfu_percent(flops, ctx["trace"].window_s)
