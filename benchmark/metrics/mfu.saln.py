"""``mfu.gen`` (``metrics/mfu.gen.py``) in the cells of the ``fid_saln``
driver: the whole generation's share of the card's bf16 dense peak.

``harness/work.py`` counts the AdaLN projection once a layer (depth x 2C
x 6C a row); a shared-AdaLN model computes it once for the whole stack,
so the count overstates a VAR-d36 512px image by about 2 GFLOP in its
24,400 (under 0.01%), which this reader leaves as it is."""

from benchmark.metrics._reuse import reader

_gen = reader("mfu.gen")
LAYER, UNIT, BETTER, SOURCE, MOVES = (_gen.LAYER, _gen.UNIT, _gen.BETTER,
                                      _gen.SOURCE, _gen.MOVES)
DRIVERS = ("fid_saln",)
read = _gen.read
