"""``attn_roofline.gen`` (``metrics/attn_roofline.gen.py``) in the cells of
the ``fid_saln`` driver: kernel row 1 (float K/V) against its roofline, at
the cell's shapes (VAR-d36 512px: Lq up to 1,024 against Lk up to 2,240)."""

from benchmark.metrics._reuse import reader

_gen = reader("attn_roofline.gen")
LAYER, UNIT, BETTER, SOURCE, MOVES = (_gen.LAYER, _gen.UNIT, _gen.BETTER,
                                      _gen.SOURCE, _gen.MOVES)
DRIVERS = ("fid_saln",)
read = _gen.read
