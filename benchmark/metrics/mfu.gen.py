"""The whole generation's share of the card's bf16 dense peak (989
TFLOP/s, H100 SXM data sheet): the FLOPs the configuration needs per
image (``harness/work.py:gen_flops_per_image``: transformer for both CFG
rows at every scale, attention against each cached length, head, pixel
decoder) times the images of the traced window, over the window. It
bounds every kernel roofline of the step from above."""

LAYER = "whole step (models/var.py + models/vqvae.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "img_per_s"
DRIVERS = ("fid",)


def read(ctx):
    from benchmark.harness import work

    if not ctx["images"] or ctx["trace"].window_s <= 0:
        return None
    flops = work.gen_flops_per_image(ctx["model"]) * ctx["images"]
    return work.mfu_percent(flops, ctx["trace"].window_s)
