"""``latent_ms_per_img.gen`` (``metrics/latent_ms_per_img.gen.py``) in the
cells of the ``fid_saln`` driver: device milliseconds of the latent decode
per image delivered."""

from benchmark.metrics._reuse import reader

_gen = reader("latent_ms_per_img.gen")
LAYER, UNIT, BETTER, SOURCE, MOVES = (_gen.LAYER, _gen.UNIT, _gen.BETTER,
                                      _gen.SOURCE, _gen.MOVES)
DRIVERS = ("fid_saln",)
read = _gen.read
