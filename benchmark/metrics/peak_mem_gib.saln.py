"""``peak_mem_gib.gen`` (``metrics/peak_mem_gib.gen.py``) in the cells of the
``fid_saln`` driver: the card's peak allocated memory over the traced
window, in GiB."""

from benchmark.metrics._reuse import reader

_gen = reader("peak_mem_gib.gen")
LAYER, UNIT, BETTER, SOURCE, MOVES = (_gen.LAYER, _gen.UNIT, _gen.BETTER,
                                      _gen.SOURCE, _gen.MOVES)
DRIVERS = ("fid_saln",)
read = _gen.read
