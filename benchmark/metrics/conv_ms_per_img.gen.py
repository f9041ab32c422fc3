"""Device milliseconds of convolution kernels (by name: the frozen
classification of ``harness/kernels.py``) per image delivered: the pixel
decoder (``models/vqvae.py``), which with the golden f32 decoder costs
about as much as the latent decode."""

LAYER = "models/vqvae.py pixel decoder"
UNIT = "ms/img"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "img_per_s"
DRIVERS = ("fid",)


def read(ctx):
    from benchmark.harness.kernels import is_conv

    s = ctx["trace"].seconds_where(is_conv)
    return 1e3 * s / ctx["images"] if s > 0 and ctx["images"] else None
